"""The port's serving around the model, on the CPU: image decoding against
cv2, ``unmold_detections`` with per-class masks, ``Predictor.detect_stream``
against ``detect``, ``coco_config`` and ``COCO_CLASS_NAMES`` against the JAX
package's, and the two CLIs.

Tolerances: decoded pixels equal cv2's exactly; unmolded boxes, class ids and
scores equal the JAX function's exactly and >= 99.5 % of mask pixels equal
(the rule of ``tests/test_torch_port_slice.py``: the port resizes masks with
PyTorch's bilinear, the JAX package with cv2's); ``detect_stream`` equals
``detect`` over the same fixed-shape chunks bit for bit; the detect CLI's
JSON equals ``Predictor.detect``'s results, its mask blend equals the JAX
formula exactly and its box outline equals ``cv2.rectangle(..., 2)`` on
>= 99 % of pixels.
"""

import json
import os

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.config import coco_config as jax_coco_config
from maskrcnn_tf2_tpu.data.coco import COCO_CLASS_NAMES as JAX_COCO_CLASS_NAMES
from maskrcnn_tf2_tpu.export import inference as jax_inference

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig, coco_config
from maskrcnn_tf2_tpu_torch.data import image_io, raster
from maskrcnn_tf2_tpu_torch.data.coco import COCO_CLASS_NAMES
from maskrcnn_tf2_tpu_torch.export import inference as port_inference
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

try:
    import cv2
except ImportError:  # the card's machine has no cv2
    cv2 = None

needs_cv2 = pytest.mark.skipif(cv2 is None, reason="cv2 is absent")

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=10, num_classes=4,
            backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
            compute_dtype="float32", detection_min_confidence=0.0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# decoding (ROADMAP fault C.1)
# ---------------------------------------------------------------------------


def _ramp16(h=64, w=64):
    return (np.arange(h * w, dtype=np.int64) * 16).reshape(h, w).astype(np.uint16)  # 0 .. 65520


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@needs_cv2
@pytest.mark.parametrize("kind", ["grey16", "rgb16", "grey16_pgm", "L", "LA", "P"])
def test_imread_equals_cv2(tmp_path, kind):
    """Every pixel as ``cv2.imread(path, IMREAD_COLOR)`` decodes it: a 16-bit
    sample shifted right by 8, grey replicated, alpha dropped, the palette
    expanded."""
    from PIL import Image

    rs = np.random.RandomState(0)
    path = str(tmp_path / ("img.pgm" if kind == "grey16_pgm" else "img.png"))
    if kind in ("grey16", "grey16_pgm"):
        cv2.imwrite(path, _ramp16())
    elif kind == "rgb16":
        cv2.imwrite(path, rs.randint(0, 65536, (40, 48, 3)).astype(np.uint16))
    elif kind == "L":
        Image.fromarray(rs.randint(0, 256, (40, 48)).astype(np.uint8), "L").save(path)
    elif kind == "LA":
        Image.fromarray(rs.randint(0, 256, (40, 48, 2)).astype(np.uint8), "LA").save(path)
    else:
        img = Image.fromarray(rs.randint(0, 256, (40, 48, 3)).astype(np.uint8), "RGB")
        img.quantize(colors=37).save(path)
    got, want = image_io.imread(path), _cv2_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{kind}: {np.mean(got == want):.4f} of pixels equal"


# ---------------------------------------------------------------------------
# unmold with per-class masks (ROADMAP fault C.2)
# ---------------------------------------------------------------------------


def _detections(rs, d=12, n=9, classes=5):
    y1, x1 = rs.uniform(0.15, 0.6, (2, n))  # inside the window, as the model clips them
    h, w = rs.uniform(0.05, 0.25, (2, n))
    det = np.zeros((d, 6), np.float32)
    det[:n, :4] = np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1)
    det[:n, 4] = rs.randint(1, classes, n)
    det[:n, 5] = np.sort(rs.uniform(0.3, 1.0, n))[::-1]
    det[2, 2] = det[2, 0] - 0.004  # no height once in pixels: dropped by keep
    masks = rs.uniform(0, 1, (d, 28, 28, classes)).astype(np.float32)
    return det, masks


def test_unmold_takes_per_class_masks():
    """Per-class masks ``[D, mh, mw, C]`` and the same masks gathered at each
    detection's class give identical results; both equal the JAX function's
    boxes, ids and scores exactly and >= 99.5 % of its mask pixels."""
    rs = np.random.RandomState(3)
    det, masks = _detections(rs)
    gathered = np.take_along_axis(masks, det[:, 4].astype(np.int64)[:, None, None, None], -1)[..., 0]
    args = ((300, 400, 3), (512, 512, 3), np.array([64, 0, 448, 512], np.float32))
    per_class = port_inference.unmold_detections(det, masks, *args)
    pre = port_inference.unmold_detections(det, gathered, *args)
    ref = jax_inference.unmold_detections(det, masks, *args)
    assert len(per_class["class_ids"]) == 8
    for key in ("rois", "class_ids", "scores", "masks"):
        np.testing.assert_array_equal(per_class[key], pre[key])
    for key in ("rois", "class_ids", "scores"):
        np.testing.assert_array_equal(per_class[key], ref[key])
    assert np.mean(per_class["masks"] == ref["masks"]) >= 0.995


# ---------------------------------------------------------------------------
# coco_config and the class names
# ---------------------------------------------------------------------------


def test_coco_config_equals_jax():
    kw = dict(backbone="resnet101", batch_size=4, image_shape=(256, 256, 3))
    assert coco_config(**kw).to_dict() == jax_coco_config(**kw).to_dict()
    assert coco_config().md5() == jax_coco_config().md5()


def test_coco_class_names_equal_jax():
    assert COCO_CLASS_NAMES == JAX_COCO_CLASS_NAMES and len(COCO_CLASS_NAMES) == 81


# ---------------------------------------------------------------------------
# detect_stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictor():
    cfg = MaskRCNNConfig(**TINY)
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():  # spread the RPN scores: saturated scores tie
        model.rpn.rpn_class_raw.weight.mul_(0.1)
    return Predictor(cfg, model.state_dict(), device="cpu")


def stream_images():
    rs = np.random.RandomState(4)
    shapes = [(64, 64), (50, 80), (90, 60), (64, 64), (40, 40)]
    return [rs.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in shapes]


def assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_detect_stream_equals_detect(predictor, depth):
    """5 images at batch 2: two full chunks and a ragged tail, which the
    stream pads; per-image results do not depend on the other images of a
    batch, so they equal ``detect`` over the same chunks bit for bit."""
    images = stream_images()
    want = predictor.detect(images[0:2]) + predictor.detect(images[2:4])
    want += predictor.detect([images[4], images[0]])[:1]
    got = list(predictor.detect_stream(iter(images), batch_size=2, depth=depth))
    assert sum(len(r["class_ids"]) for r in got) > 0
    assert_results_equal(got, want)


@pytest.mark.parametrize("depth", [0, 2])
def test_detect_stream_reads_ahead_at_most_depth_plus_one_chunks(predictor, depth):
    """When the first result comes out, the stream has read no more than
    the chunks in flight and those preprocessed ahead: ``2 * depth + 2``."""
    images = stream_images() * 4
    pulled = []

    def source():
        for img in images:
            pulled.append(1)
            yield img

    stream = predictor.detect_stream(source(), batch_size=2, depth=depth)
    next(stream)
    assert len(pulled) <= 2 * (2 * depth + 2) < len(images)
    assert len(list(stream)) == len(images) - 1


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TINY_WIDTHS = dict(rpn_anchor_scales=(8, 16, 24, 32, 48), pre_nms_limit=128, post_nms_rois_training=32,
                   post_nms_rois_inference=32, train_rois_per_image=8, max_gt_instances=4, mini_mask_shape=(28, 28),
                   top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
                   compute_dtype="float32", detection_max_instances=10, detection_min_confidence=0.0, epochs=1)


def test_evaluate_cli_reads_a_train_model_checkpoint(tmp_path, monkeypatch, capsys):
    """``train_model`` trains the configuration the CLI builds (its widths
    made tiny through ``coco_config``) for one epoch on a synthetic COCO set
    whose categories carry the --minitrain names; the CLI finds that
    checkpoint and writes AP in [0, 1] that equals ``evaluate_dataset`` over
    a ``Predictor`` of the trained weights."""
    from maskrcnn_tf2_tpu_torch.cli import evaluate as cli_evaluate
    from maskrcnn_tf2_tpu_torch.eval.coco_eval import evaluate_dataset
    from maskrcnn_tf2_tpu_torch.train.loop import train_model
    from maskrcnn_tf2_tpu_torch.train.synthetic import shapes_coco_datasets

    monkeypatch.setattr(cli_evaluate, "coco_config", lambda **kw: coco_config(**{**TINY_WIDTHS, **kw}))
    root, ckpt = str(tmp_path / "coco"), str(tmp_path / "logs")
    names = ["background"] + cli_evaluate.MINITRAIN_CLASSES
    train, val = shapes_coco_datasets(root, (4, 3), size=64, seed=3, class_names=names)
    cfg = cli_evaluate.coco_config(backbone="resnet18", num_classes=5, image_shape=(64, 64, 3), image_min_dim=64,
                                   image_max_dim=64, batch_size=2, checkpoints_dir=ckpt)
    state = train_model(cfg, train, steps_per_epoch=2, device="cpu")
    out = str(tmp_path / "ap.json")
    stats = cli_evaluate.main(["--dataset_path", root, "--backbone", "resnet18", "--img_size", "64",
                               "--batch_size", "2", "--minitrain", "--checkpoints_dir", ckpt, "--out", out,
                               "--device", "cpu"])
    assert "WARNING" not in capsys.readouterr().out
    with open(out) as f:
        written = json.load(f)
    assert written.keys() == {"bbox", "segm"}
    for kind in ("bbox", "segm"):
        for k, v in written[kind].items():
            # an area range without GT has no AP (NaN), as in the JAX package
            assert 0.0 <= v <= 1.0 or (k.startswith("AP_") and np.isnan(v)), (kind, k, v)
    want = evaluate_dataset(Predictor(cfg, state.model.state_dict(), device="cpu"), val, cfg, verbose=False)
    assert json.dumps(stats) == json.dumps(want)


def test_detect_cli_writes_results_and_overlay(tmp_path, monkeypatch):
    """A saved checkpoint, 2 images: the JSON equals ``Predictor.detect``'s
    results; the overlay equals the JAX CLI's drawing (``cv2.rectangle`` 2 px
    outline, then the half-green blend, detection by detection) on every
    pixel where cv2 is present (>= 99 % required), and its blend equals the
    JAX formula exactly off the outlines."""
    from maskrcnn_tf2_tpu_torch.cli import detect as cli_detect
    from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
    from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state

    monkeypatch.setattr(cli_detect, "MaskRCNNConfig", lambda **kw: MaskRCNNConfig(**{**TINY_WIDTHS, **kw}))
    ckpt = str(tmp_path / "logs")
    cfg = cli_detect.MaskRCNNConfig(backbone="resnet18", num_classes=4, image_shape=(64, 64, 3), image_min_dim=64,
                                    image_max_dim=64, checkpoints_dir=ckpt)
    state = create_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    with torch.no_grad():
        state.model.rpn.rpn_class_raw.weight.mul_(0.1)
    ckpt_lib.save(ckpt_lib.make_manager(cfg), state, 0, {"loss_sum": 1.0})
    rs = np.random.RandomState(6)
    paths = []
    for i, hw in enumerate([(64, 64), (48, 80)]):
        paths.append(str(tmp_path / f"img{i}.png"))
        image_io.imwrite(paths[-1], rs.randint(0, 256, hw + (3,)).astype(np.uint8))
    out = str(tmp_path / "out")
    cli_detect.main(["--backbone", "resnet18", "--num_classes", "4", "--img_size", "64", "--checkpoints_dir", ckpt,
                     "--images", *paths, "--out", out, "--device", "cpu"])
    pred = Predictor(cfg, state.model.state_dict(), device="cpu")
    for i, path in enumerate(paths):
        img = image_io.imread(path)
        r = pred.detect([img])[0]
        assert len(r["class_ids"]) > 0
        with open(os.path.join(out, f"img{i}.json")) as f:
            assert json.load(f) == {"rois": r["rois"].tolist(), "class_ids": r["class_ids"].tolist(),
                                    "scores": r["scores"].tolist()}
        got = image_io.imread(os.path.join(out, f"img{i}_det.png"))
        outlines = np.zeros(img.shape[:2], np.uint8)
        blend = img.copy()
        for j, (y1, x1, y2, x2) in enumerate(r["rois"]):
            raster.outline_rectangle(outlines, (x1, y1), (x2, y2), 1, 2)
            m = r["masks"][:, :, j]
            blend[m] = (0.5 * blend[m] + 0.5 * np.array([0, 255, 0])).astype(np.uint8)
        assert np.array_equal(got[outlines == 0], blend[outlines == 0])
        if cv2 is not None:  # the JAX CLI's drawing, in RGB
            want = img.copy()
            for j, (y1, x1, y2, x2) in enumerate(r["rois"]):
                cv2.rectangle(want, (int(x1), int(y1)), (int(x2), int(y2)), (255, 0, 0), 2)
                m = r["masks"][:, :, j]
                want[m] = (0.5 * want[m] + 0.5 * np.array([0, 255, 0])).astype(np.uint8)
            assert np.mean(np.all(got == want, -1)) >= 0.99


@needs_cv2
def test_outline_rectangle_equals_cv2():
    """``raster.outline_rectangle`` against ``cv2.rectangle`` at thicknesses
    1-4 on 200 boxes each, corners inside and outside the image: >= 99 % of
    each canvas equal (every pixel of all 800, when this was written)."""
    rs = np.random.RandomState(0)
    for thickness in (1, 2, 3, 4):
        for _ in range(200):
            x1, x2 = sorted(int(v) for v in rs.randint(-5, 85, 2))
            y1, y2 = sorted(int(v) for v in rs.randint(-5, 65, 2))
            want, got = np.zeros((60, 80, 3), np.uint8), np.zeros((60, 80, 3), np.uint8)
            cv2.rectangle(want, (x1, y1), (x2, y2), (255, 0, 0), thickness)
            raster.outline_rectangle(got, (x1, y1), (x2, y2), (255, 0, 0), thickness)
            assert np.mean(np.all(got == want, -1)) >= 0.99


@pytest.mark.parametrize("flag,item", [(["--int8"], "ROADMAP A.8"), (["--build_engine", "engine.bin"], "ROADMAP A.9")])
def test_detect_cli_names_what_is_not_ported(capsys, flag, item):
    from maskrcnn_tf2_tpu_torch.cli import detect as cli_detect

    with pytest.raises(SystemExit) as err:
        cli_detect.main(["--images", "a.jpg", *flag, "--device", "cpu"])
    assert err.value.code != 0 and item in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["detect", "evaluate"])
def test_cli_default_device_is_the_card(tmp_path, cli):
    """Without ``--device`` a CLI asks for the card, and raises without one
    before it loads anything; it never falls to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default run would use it")
    import importlib

    module = importlib.import_module(f"maskrcnn_tf2_tpu_torch.cli.{cli}")
    args = ["--images", "a.jpg"] if cli == "detect" else ["--dataset_path", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args)
