"""The port's serving engine, its portable program and the kernels' ops, on
the CPU, at the tiny configuration of ``tests/test_torch_port_slice.py``
with weights bridged from JAX.

Two AOTInductor builds in the file: the float32 engine, built through
``cli.detect --build_engine --engine_batch 2 --device cpu`` from a
checkpoint of the bridged weights, and the int8 engine. Tolerances:

- the engine against the JAX package's jitted ``model.apply`` plus its
  class-mask gather (as ``tests/test_export.py`` holds JAX's own engine),
  and the program against the same forward's per-class masks: detections
  and masks within 1e-4, equal validity;
- the int8 engine against the live int8 model of the port: classes exact,
  the rest within ``rtol=0.05, atol=0.02`` (the rule of
  ``tests/test_quantize.py::test_int8_engine_build_load_roundtrip``);
- each op's fake implementation: the CPU implementation's shapes, dtypes and
  strides exactly; ``torch.library.opcheck`` on the CPU implementation.
"""

import contextlib
import hashlib
import io
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.ops.image import compose_image_meta

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export import engine as engine_mod
from maskrcnn_tf2_tpu_torch.export.engine import load_engine
from maskrcnn_tf2_tpu_torch.export.quantize import quantize_for_inference
from maskrcnn_tf2_tpu_torch.export.serialize import export_program, load_program
from maskrcnn_tf2_tpu_torch.kernels import int8_conv, nms, roi_align  # noqa: F401  (the ops)
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from test_torch_port_slice import TINY, images
from torch_port_helpers import pyramid, random_boxes, randomize, roi_boxes

OPS = torch.ops.maskrcnn_tf2_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def metas(n):
    return np.stack([compose_image_meta(i, (128, 128, 3), (128, 128, 3), (0, 0, 128, 128), 1.0, np.ones(3))
                     for i in range(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def bridged():
    """The slice test's JAX model and variables, and the port's state dict."""
    jmodel = JaxMaskRCNN(JaxConfig(**TINY))
    img, meta = images(2, 0), metas(2)
    variables = jax.jit(lambda r: jmodel.init({"params": r}, img, meta, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, np.random.RandomState(1))
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    state = flax_to_state_dict(variables, MaskRCNN(MaskRCNNConfig(**TINY), device="cpu"))
    return jmodel, variables, state


@pytest.fixture(scope="module")
def jax_infer(bridged):
    jmodel, variables, _ = bridged
    return jax.jit(lambda i, m: jmodel.apply(variables, i, m, train=False))


@pytest.fixture(scope="module")
def engine_path(bridged, tmp_path_factory):
    """The float32 engine at batch 2, built by ``cli.detect --build_engine``
    from a checkpoint of the bridged weights."""
    from maskrcnn_tf2_tpu_torch.cli import detect as cli_detect
    from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
    from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state

    root = tmp_path_factory.mktemp("engine")
    widths = {k: v for k, v in TINY.items() if k not in ("backbone", "num_classes", "image_shape")}
    mp = pytest.MonkeyPatch()
    mp.setattr(cli_detect, "MaskRCNNConfig", lambda **kw: MaskRCNNConfig(**{**kw, **widths}))
    try:
        cfg = cli_detect.MaskRCNNConfig(backbone="resnet18", num_classes=3, image_shape=(128, 128, 3),
                                        checkpoints_dir=str(root / "logs"))
        state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        state.model.load_state_dict(bridged[2])
        ckpt_lib.save(ckpt_lib.make_manager(cfg), state, 0, {"loss_sum": 1.0})
        path = str(root / "tiny.engine")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = cli_detect.main(["--backbone", "resnet18", "--num_classes", "3", "--img_size", "128",
                                   "--checkpoints_dir", str(root / "logs"), "--build_engine", path,
                                   "--engine_batch", "2", "--device", "cpu"])
    finally:
        mp.undo()
    assert out == path
    return path, printed.getvalue(), cfg


def test_detect_cli_builds_an_engine(engine_path):
    path, printed, cfg = engine_path
    assert f"engine written: {path} (batch=2)" in printed
    eng = load_engine(path, device="cpu")
    assert (eng.batch_size, eng.backbone, eng.image_shape, eng.meta_size) == (2, "resnet18", (128, 128, 3),
                                                                              cfg.meta_size)
    assert eng.config_md5 == cfg.md5()
    assert set(eng.metadata["kernels"]) == {"nms", "roi_align"}


def test_engine_build_makes_no_timed_choice(monkeypatch, tmp_path):
    """``build_engine`` compiles with Inductor's deterministic mode, besides
    eager's roundings: no choice that changes the arithmetic is made by
    timing, so two builds of one program generate the same kernels (ROADMAP
    §C, C.6: on the card, builds of the flagship without it generated
    different kernel sets)."""
    seen = {}

    class Compiled(Exception):
        pass

    def compile_and_package(program, package_path, inductor_configs):
        seen.update(inductor_configs)
        raise Compiled

    monkeypatch.setattr(engine_mod, "export_served", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package", compile_and_package)
    with pytest.raises(Compiled):
        engine_mod.build_engine(MaskRCNNConfig(**TINY), {}, str(tmp_path / "tiny.engine"), device="cpu")
    assert seen["deterministic"] is True
    assert seen["emulate_precision_casts"] is True and seen["joint_graph_constant_folding"] is False


def test_engine_matches_jax(engine_path, jax_infer):
    """uint8 ingress and the class-mask gather on the device, against JAX's
    jitted forward and its gather on the same uint8 images and meta."""
    eng = load_engine(engine_path[0], device="cpu")
    img, meta = images(2, 4), metas(2)
    det, masks = eng(img, meta)
    ref = jax_infer(img.astype(np.float32), meta)
    ref_det = np.asarray(ref["detections"])
    cls = ref_det[..., 4].astype(np.int64)
    ref_masks = np.take_along_axis(np.asarray(ref["mrcnn_masks"]), cls[:, :, None, None, None], axis=-1)[..., 0]
    assert det.shape == (2, MaskRCNNConfig(**TINY).detection_max_instances, 6) and masks.shape == det.shape[:2] + (28, 28)
    np.testing.assert_array_equal(det[..., 4] > 0, ref_det[..., 4] > 0)
    assert (det[..., 4] > 0).sum() >= 1, "no valid detection: the comparison would be vacuous"
    np.testing.assert_allclose(det, ref_det, rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks, ref_masks, rtol=0, atol=1e-4)


def test_program_round_trip_matches_jax(bridged, jax_infer, tmp_path):
    _, _, state = bridged
    path = export_program(MaskRCNNConfig(**TINY), state, str(tmp_path / "tiny.pt2"), batch_size=2, device="cpu")
    program = load_program(path, device="cpu")
    img, meta = images(2, 6).astype(np.float32), metas(2)
    with torch.no_grad():
        det, masks = (t.numpy() for t in program(torch.from_numpy(img), torch.from_numpy(meta)))
    ref = jax_infer(img, meta)
    ref_det = np.asarray(ref["detections"])
    np.testing.assert_array_equal(det[..., 4] > 0, ref_det[..., 4] > 0)
    assert (det[..., 4] > 0).sum() >= 1
    np.testing.assert_allclose(det, ref_det, rtol=0, atol=1e-4)
    np.testing.assert_allclose(masks, np.asarray(ref["mrcnn_masks"]), rtol=0, atol=1e-4)


def test_int8_engine_matches_the_live_int8_model(bridged, tmp_path):
    """Calibrate, build at batch 1, reload, serve: against the live int8
    model (``cast_for_serving_`` quantizes its weights once, as the build
    does) on the same image."""
    _, _, state = bridged
    cfg = MaskRCNNConfig(**TINY)
    calib = [(torch.from_numpy(images(1, 12)), torch.from_numpy(metas(1)))]
    qcfg, qstate = quantize_for_inference(cfg, state, calib, device="cpu")
    path = engine_mod.build_engine(qcfg, qstate, str(tmp_path / "int8.engine"), batch_size=1, device="cpu")
    eng = load_engine(path, device="cpu")
    assert set(eng.metadata["kernels"]) == {"int8_conv", "nms", "roi_align"}
    img = np.random.RandomState(13).randint(0, 256, (1, 128, 128, 3)).astype(np.uint8)
    det, masks = eng(img, metas(1))
    live = MaskRCNN(qcfg, device="cpu")
    live.load_state_dict(qstate)
    live.cast_for_serving_()
    with torch.no_grad():
        ref = live(torch.from_numpy(img).float(), torch.from_numpy(metas(1)))["detections"].numpy()
    assert (ref[..., 4] > 0).sum() >= 1
    np.testing.assert_array_equal(det[..., 4], ref[..., 4])  # classes exact
    np.testing.assert_allclose(det, ref, rtol=0.05, atol=0.02)
    assert np.isfinite(masks).all()


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------


def _rewrite(path, out, edit=None, trailing=b""):
    """``path`` with its metadata edited by ``edit`` and ``trailing`` bytes
    after the sections, under a header whose sha256 matches."""
    metadata, weights, package = engine_mod.read_engine(path)
    if edit is not None:
        edit(metadata)
    body = io.BytesIO()
    for section in (json.dumps(metadata).encode(), weights, package):
        engine_mod._write_section(body, section)
    blob = body.getvalue() + trailing
    with open(out, "wb") as f:
        f.write(engine_mod.MAGIC + b" " + hashlib.sha256(blob).hexdigest().encode() + b"\n" + blob)
    return str(out)


def _set(key, value):
    def edit(metadata):
        metadata[key] = value
    return edit


def _foreign_digest(metadata):
    metadata["kernels"]["nms"] = "0" * 64


@pytest.mark.parametrize("case,error,match", [
    ("corrupt", ValueError, "corrupt"),
    ("trailing", ValueError, "trailing bytes"),
    ("host", RuntimeError, "host .*rebuild"),
    ("torch", RuntimeError, "torch '0.0.1'.*rebuild"),
    ("kernel", RuntimeError, "csrc/nms.cu.*rebuild"),
    ("platform", RuntimeError, "platform 'cuda'.*rebuild"),
])
def test_engine_gates(engine_path, tmp_path, case, error, match):
    path = engine_path[0]
    if case == "corrupt":
        raw = bytearray(open(path, "rb").read())
        raw[raw.index(b"\n") + 100] ^= 0xFF
        bad = str(tmp_path / "corrupt.engine")
        open(bad, "wb").write(bytes(raw))
    elif case == "trailing":
        bad = _rewrite(path, tmp_path / "trailing.engine", trailing=b"\0")
    else:
        edit = {"host": _set("host_fp", "0" * 16), "torch": _set("torch_version", "0.0.1"),
                "kernel": _foreign_digest, "platform": _set("platform", "cuda")}[case]
        bad = _rewrite(path, tmp_path / f"{case}.engine", edit)
    with pytest.raises(error, match=match):
        load_engine(bad, device="cpu")


def test_gated_rewrite_loads_unchanged(engine_path, tmp_path):
    """The rewrite of the gate tests, with nothing edited, loads and serves:
    each gate test fails for its edit alone."""
    eng = load_engine(_rewrite(engine_path[0], tmp_path / "same.engine"), device="cpu")
    det, _ = eng(images(2, 4), metas(2))
    assert np.isfinite(det).all()


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _op_cases():
    rs = np.random.RandomState(5)
    T = torch.from_numpy
    boxes = np.stack([random_boxes(rs, 300) for _ in range(2)])
    valid = rs.uniform(size=(2, 300)) > 0.1
    rois = T(roi_boxes(rs, 2, 24))
    feats = [T(f) for f in pyramid(rs, 2, 64, 16)]
    dout = T(rs.normal(size=(2, 24, 7, 7, 16)).astype(np.float32))
    x = T(rs.randint(-127, 128, (2, 9, 11, 16)).astype(np.int8))
    w = T(rs.randint(-127, 128, (24, 3, 3, 16)).astype(np.int8))
    dw = T(rs.randint(-127, 128, (16, 3, 3, 1)).astype(np.int8))
    sx, sw, bias = torch.tensor(0.02), T(rs.uniform(0.001, 0.01, 24).astype(np.float32)), torch.randn(24)
    return {
        "greedy_nms": (OPS.greedy_nms.default, (T(boxes), T(valid), 0.5, 40)),
        "roi_align_f32": (OPS.roi_align.default, (feats, rois, 7, [64, 64, 3], 244.0)),
        "roi_align_bf16": (OPS.roi_align.default, ([f.bfloat16() for f in feats], rois, 14, [64, 64], 244.0)),
        "roi_align_backward": (OPS.roi_align_backward.default,
                               (dout, rois, [16, 16, 8, 8, 4, 4, 2, 2], [64, 64], 244.0)),
        "int8_conv_s2_bf16": (OPS.int8_conv.default, (x, w, sx, sw, bias, 2, 1, 1, 0, 0)),
        "int8_conv_depthwise": (OPS.int8_conv.default,
                                (x, dw, sx, sw[:16], None, 1, 16, 0, 0, 0)),
    }


OP_CASES = ["greedy_nms", "roi_align_f32", "roi_align_bf16", "roi_align_backward", "int8_conv_s2_bf16",
            "int8_conv_depthwise"]


@pytest.mark.parametrize("case", OP_CASES)
def test_fake_matches_cpu_implementation(case):
    """The fake implementation gives the CPU implementation's shapes, dtypes
    and strides exactly: a compiled graph reads the kernel's output by them."""
    op, args = _op_cases()[case]
    real = op(*args)
    mode = FakeTensorMode()
    fake_args = torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args)
    with mode:
        fake = op(*fake_args)
    real, fake = (r if isinstance(r, tuple) else (r,) for r in (real, fake))
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype, f.stride()) == (tuple(r.shape), r.dtype, r.stride())


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)
