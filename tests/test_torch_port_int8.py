"""The port's int8 post-training quantization against the JAX package's, on the CPU.

The small configuration of ``tests/test_quantize.py`` (96 px, ResNet-18,
64-wide FPN and mask head, 128-wide FCs, float32), the port's seeded weights
(every bias and batch-norm leaf randomised) carried to flax through the weight
bridge, and the same numpy inputs in both packages.

Tolerances:
- the int8 conv and dense sites: bit-equal in float32, the int32 sums and the
  dequantized outputs, against the JAX modules applied eagerly. Under
  ``jax.jit`` XLA's algebraic simplifier turns the weight scale's division by
  127 into a multiply by its reciprocal, which can move ``sw`` by an ulp; the
  port divides, as the source does, so the JAX int8 graphs below are compiled
  with that pass off (``EXACT_DIVISION``).
- calibration: every amax within 1e-5 relative (the float convolutions of the
  two packages sum in other orders);
- the whole detector in int8 with JAX's calibration carried across: C2-C5
  (dequantized) and P2-P6 within 1e-3 relative L2, RPN logits and classifier
  probabilities within 1e-3, detections' class ids equal and boxes within
  1e-3 (normalized): an activation within an ulp of a rounding boundary may
  quantize to the other integer in the other package;
- ``Predictor.detect``: class ids equal, boxes within 1 pixel, scores within
  1e-3, >= 99 % of mask pixels equal (the slice test's rule, widened as the
  detector's tolerance allows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.export.quantize import quantize_for_inference as jax_quantize_for_inference
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.models import get_backbone as jax_get_backbone
from maskrcnn_tf2_tpu.models.quant import Int8Conv, Int8Dense, Int8FCOnPooled
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.predictor import Predictor as JaxPredictor

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export.quantize import calibrate, quantize_for_inference
from maskrcnn_tf2_tpu_torch.kernels.int8_conv import int8_conv_accumulate_plain
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.mobilenet import add_conv_bn
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import ConvBN
from maskrcnn_tf2_tpu_torch.models.fpn import FPN
from maskrcnn_tf2_tpu_torch.models.heads import FPNClassifierHead, FPNMaskHead
from maskrcnn_tf2_tpu_torch.models.layers import Conv2d, Linear, SameConv2d
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.models.quant import Int8Conv2d, Int8Linear, QTensor, call_site, is_quant_buffer
from maskrcnn_tf2_tpu_torch.models.rpn import RPNHead
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_, state_dict_to_flax

from torch_port_helpers import randomize

SMALL = dict(
    image_shape=(96, 96, 3), image_min_dim=96, image_max_dim=96, rpn_anchor_scales=(8, 16, 32, 64, 96),
    pre_nms_limit=256, post_nms_rois_training=64, post_nms_rois_inference=64, train_rois_per_image=32,
    max_gt_instances=6, num_classes=4, detection_max_instances=10, detection_min_confidence=0.0,
    backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=128, mask_conv_channels=64,
    compute_dtype="float32", batch_size=1,
)
SWITCHES = ("MASKRCNN_TPU_INT8_QRES", "MASKRCNN_TPU_INT8_QC", "MASKRCNN_TPU_INT8_DW")
EXACT_DIVISION = {"xla_disable_hlo_passes": "algsimp"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def default_switches(monkeypatch):
    for name in SWITCHES + ("MASKRCNN_TPU_INT8_PET",):
        monkeypatch.delenv(name, raising=False)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)  # channels_last memory


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def deq(v):
    """A backbone endpoint as float32 NHWC: a port ``QTensor`` or JAX ``(s8, scale)`` pair dequantized."""
    if isinstance(v, QTensor):
        return nhwc(v.q.to(torch.float32) * v.scale)
    if isinstance(v, torch.Tensor):
        return nhwc(v)
    if isinstance(v, tuple):
        return np.asarray(v[0], np.float32) * np.asarray(v[1])
    return np.asarray(v)


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-12))


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------

# name -> (H, W, C, O, kernel, stride, groups, bias, input)
CONV_CASES = {
    "3x3_s1": (9, 9, 16, 24, 3, 1, 1, False, "x"),
    "3x3_s2_odd": (9, 7, 16, 24, 3, 2, 1, False, "x"),
    "1x1_s2": (8, 8, 32, 64, 1, 2, 1, False, "x"),
    "groups_4_of_4": (7, 7, 16, 16, 3, 1, 4, False, "x"),
    "depthwise": (6, 6, 8, 8, 3, 1, 8, False, "x"),
    "bias": (8, 8, 16, 24, 3, 1, 1, True, "x"),
    "pre_quantized": (8, 8, 16, 24, 3, 2, 1, True, "xq"),
    "amax_0": (6, 6, 8, 8, 3, 1, 1, True, "zeros"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_jax(case):
    h, w, c, o, k, s, g, use_bias, kind = CONV_CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    x = (rs.randn(2, h, w, c) * 3.0).astype(np.float32) if kind != "zeros" else np.zeros((2, h, w, c), np.float32)
    kernel = (rs.randn(k, k, c // g, o) / np.sqrt(k * k * c // g)).astype(np.float32)
    bias = rs.randn(o).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.8)
    jm = Int8Conv(features=o, kernel=(k, k), strides=(s, s), groups=g, use_bias=use_bias, dtype=jnp.float32)
    params = {"kernel": kernel, **({"bias": bias} if use_bias else {})}
    tm = Int8Conv2d(c, o, k, s, bias=use_bias, groups=g, quant="int8")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if use_bias:
            tm.bias.copy_(torch.from_numpy(bias))
    tamax = torch.tensor(amax)

    if kind == "xq":
        sx = np.float32(amax / np.float32(127.0))
        xq = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
        want = jm.apply({"params": params}, None, jnp.float32(amax), xq=jnp.asarray(xq), sx=jnp.float32(sx))
        got = tm(QTensor(nchw(xq), torch.tensor(sx), torch.float32), tamax)
    else:
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.float32(amax))
        got = tm(nchw(x), tamax)
        sx = max(amax, np.float32(1e-6)) / np.float32(127.0)
        xq = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))

    # the int32 sums, on JAX's own weight quantization
    sw = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), np.float32(1e-12)) / np.float32(127.0)
    wq = np.round(kernel / sw).astype(np.int8)
    jacc = jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), (s, s), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
                                        preferred_element_type=jnp.int32)
    tacc = int8_conv_accumulate_plain(torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(
        wq.transpose(3, 0, 1, 2))), s, g)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    # a frozen site (serving) gives the same bits
    tm.freeze_()
    again = tm(nchw(x), tamax) if kind != "xq" else tm(QTensor(nchw(xq), torch.tensor(sx), torch.float32), tamax)
    assert torch.equal(again, got)


@pytest.mark.parametrize("layer", ["dense", "fc_on_pooled"])
def test_int8_dense_matches_jax(layer):
    rs = np.random.RandomState(5)
    x = (rs.randn(2, 3, 5, 5, 8) * 2.0).astype(np.float32)
    k = 5 * 5 * 8
    kernel = (rs.randn(k, 32) / np.sqrt(k)).astype(np.float32)
    bias = rs.randn(32).astype(np.float32)
    amax = np.float32(np.abs(x).max())
    variables = {"params": {"kernel": kernel, "bias": bias}}
    if layer == "dense":
        want = Int8Dense(features=32, dtype=jnp.float32).apply(variables, jnp.asarray(x.reshape(6, k)),
                                                             jnp.float32(amax))
    else:
        want = Int8FCOnPooled(features=32, dtype=jnp.float32).apply(variables, jnp.asarray(x),
                                                                    jnp.float32(amax)).reshape(6, 32)
    tm = Int8Linear(k, 32, quant="int8")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(kernel.T))
        tm.bias.copy_(torch.from_numpy(bias))
    got = tm(torch.from_numpy(x.reshape(6, k)), torch.tensor(amax))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_scale_division_is_ieee():
    """The scales' ``/ 127`` (``quant._div``) is the float32 IEEE quotient, and
    so is the float64 reciprocal multiply that a backend (eager CUDA,
    Inductor) may take in its place, on every 101st positive normal float32
    (21 million values)."""
    from maskrcnn_tf2_tpu_torch.models.quant import _div

    a = np.arange(0x00800000, 0x7F800000, 101, dtype=np.uint32).view(np.float32)
    want = a / np.float32(127.0)
    np.testing.assert_array_equal(_div(torch.from_numpy(a), 127.0).numpy(), want)
    np.testing.assert_array_equal((a.astype(np.float64) * (1.0 / 127.0)).astype(np.float32), want)


def test_pet_switch_is_not_ported(monkeypatch):
    tm = Int8Conv2d(8, 8, 3, quant="int8")
    monkeypatch.setenv("MASKRCNN_TPU_INT8_PET", "bf16")
    with pytest.raises(ValueError, match="MASKRCNN_TPU_INT8_PET"):
        tm(torch.zeros((1, 8, 4, 4)), torch.tensor(1.0))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def mobilenet_depthwise(quant):
    owner = torch.nn.Module()
    add_conv_bn(owner, "dw", 8, 8, 3, groups=8, quant=quant)
    return owner


# site: (owner in a quant mode, layer name, amax name, float class, input shape)
SITES = {
    "resnet_grouped_convbn": (lambda q: ConvBN(8, 8, 3, groups=2, quant=q), "conv", "x_amax", SameConv2d,
                              (2, 8, 6, 6)),
    "mobilenet_depthwise": (mobilenet_depthwise, "dw_conv", "dw_x_amax", SameConv2d, (2, 8, 6, 6)),
    "fpn_lateral_1x1": (lambda q: FPN((8, 8, 8, 8), 8, quant=q), "fpn_c2p2", "fpn_c2p2_x_amax", Conv2d,
                        (2, 8, 6, 6)),
    "rpn_shared": (lambda q: RPNHead(8, 3, 8, quant=q), "rpn_conv_shared", "rpn_conv_shared_x_amax", SameConv2d,
                   (2, 8, 6, 6)),
    "classifier_fc": (lambda q: FPNClassifierHead(8, 3, pool_size=2, fc_size=8, quant=q), "mrcnn_class_conv1",
                      "mrcnn_class_conv1_x_amax", Linear, (4, 32)),
    "mask_conv": (lambda q: FPNMaskHead(8, 3, 8, quant=q), "mrcnn_mask_conv1", "mrcnn_mask_conv1_x_amax",
                  SameConv2d, (2, 8, 6, 6)),
}


@pytest.mark.parametrize("site", list(SITES))
def test_add_site_and_call_site(site, monkeypatch):
    """Each module's site: the float layer and no amax when quant is off; in
    calib the float output and the recorded max|x|; in int8 the int8 path
    with the owner's amax, except a depthwise MobileNet site, which stays in
    floating point unless MASKRCNN_TPU_INT8_DW is 1 (a ResNeXt-style grouped
    ConvBN is quantized)."""
    make, name, amax, float_cls, shape = SITES[site]
    torch.manual_seed(0)
    x = torch.from_numpy(np.random.RandomState(5).normal(size=shape).astype(np.float32))
    off = make("off")
    assert type(getattr(off, name)) is float_cls and not hasattr(off, amax)
    want = call_site(off, name, x)
    assert torch.equal(want, getattr(off, name)(x))
    calib = make("calib")
    calib.load_state_dict(off.state_dict(), strict=False)
    assert torch.equal(call_site(calib, name, x), want)
    assert float(getattr(calib, amax)) == float(x.abs().max())
    int8 = make("int8")
    int8.load_state_dict(calib.state_dict())
    layer = getattr(int8, name)
    assert isinstance(layer, Int8Linear if float_cls is Linear else Int8Conv2d) and layer.amax_name == amax
    quantized = layer(x, getattr(int8, amax))
    assert not torch.equal(quantized, want)
    if site == "mobilenet_depthwise":
        assert torch.equal(call_site(int8, name, x), want)
        monkeypatch.setenv("MASKRCNN_TPU_INT8_DW", "1")
    assert torch.equal(call_site(int8, name, x), quantized)


def port_and_flax(make_port, seed=1):
    """A seeded port model (quant off) and its randomised flax variables."""
    model = lecun_init_(make_port(), torch.Generator().manual_seed(seed))
    variables = randomize(state_dict_to_flax(model), np.random.RandomState(seed + 3))
    model.load_state_dict(flax_to_state_dict(variables, model))
    return model, variables


def flat_quant(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_quant(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


@pytest.mark.parametrize("backbone", ["resnet50", "resnext50", "mobilenetv2", "efficientnetb0"])
def test_backbone_calibration_matches_jax(backbone):
    """Every site's amax, and every ResNet block's out_amax, at 64x64."""
    off, variables = port_and_flax(lambda: get_backbone(backbone))
    x = np.random.RandomState(9).randn(1, 64, 64, 3).astype(np.float32)
    jnet = jax_get_backbone(backbone, dtype=jnp.float32, quant="calib")
    quant = jax.jit(lambda v, x: jnet.apply(v, x, train_bn=False, mutable=["quant"])[1]["quant"])(variables, x)
    want = flat_quant(quant)
    calib = get_backbone(backbone, quant="calib").to(memory_format=torch.channels_last).eval()
    calib.load_state_dict(off.state_dict(), strict=False)
    with torch.no_grad():
        calib(nchw(x))
    got = {k: float(v) for k, v in calib.state_dict().items() if is_quant_buffer(k)}
    assert got.keys() == want.keys()
    assert all(v > 0 for v in got.values())
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)


def small_inputs(n=1, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 255, (n, 12, 12, 3))
    images = np.clip(np.repeat(np.repeat(x, 8, 1), 8, 2) + rs.normal(0, 8, (n, 96, 96, 3)), 0, 255).astype(np.float32)
    meta = np.stack([compose_image_meta(i, (96, 96, 3), (96, 96, 3), (0, 0, 96, 96), 1.0, np.ones(4))
                     for i in range(n)]).astype(np.float32)
    return images, meta


def detector(backbone="resnet18", **kw):
    """``(port config, JAX config, port state_dict, flax variables)``, quant off."""
    cfg = dict(SMALL, backbone=backbone, **kw)
    model, variables = port_and_flax(lambda: MaskRCNN(MaskRCNNConfig(**cfg), device="cpu"))
    # smaller RPN class weights spread the scores: saturated scores tie, and ties rank by index
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    return MaskRCNNConfig(**cfg), JaxConfig(**cfg), flax_to_state_dict(variables, model), variables


@pytest.fixture(scope="module")
def calibrated():
    """The detector with both head switches, calibrated by JAX on one batch:
    ``(config, int8 config, state_dict with JAX's calibration carried across,
    JAX int8 config, JAX variables, images, meta)``."""
    cfg, jcfg, _, variables = detector(quant_classifier=True, quant_mask_head=True)
    images, meta = small_inputs()
    jqcfg, jvars = jax_quantize_for_inference(jcfg, dict(variables), [(jnp.asarray(images), jnp.asarray(meta))])
    jvars = jax.tree.map(np.asarray, jvars)
    qcfg = cfg.replace(quant_mode="int8")
    return cfg, qcfg, flax_to_state_dict(jvars, MaskRCNN(qcfg, device="cpu")), jqcfg, jvars, images, meta


def test_detector_calibration_matches_jax(calibrated):
    """The port's own ``quantize_for_inference`` against JAX's ``quant`` collection."""
    cfg, _, jstate, jqcfg, jvars, images, meta = calibrated
    state = {k: v for k, v in jstate.items() if not is_quant_buffer(k)}
    qcfg, qstate = quantize_for_inference(cfg, state, [(images, meta)], device="cpu")
    assert qcfg.quant_mode == jqcfg.quant_mode == "int8"
    want = flat_quant(jvars["quant"])
    got = {k: float(v) for k, v in qstate.items() if is_quant_buffer(k)}
    assert got.keys() == want.keys()
    assert {k.split(".")[0] for k in got} == {"backbone", "fpn", "rpn", "classifier", "mask_head"}
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)


def test_calibrate_needs_a_batch():
    cfg, _, state, _ = detector()
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate(cfg, state, [], device="cpu")


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def strip_out_amax(tree):
    return {k: strip_out_amax(v) for k, v in tree.items() if k != "out_amax"} if hasattr(tree, "items") else tree


def test_quant_collection_crosses_the_bridge_both_ways(calibrated):
    _, qcfg, _, _, jvars, _, _ = calibrated
    model = MaskRCNN(qcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(jvars, model))
    back = state_dict_to_flax(model)
    assert flat_quant(back["quant"]) == flat_quant(jvars["quant"])
    for bad in ({"fpn": {"fpn_bogus_x_amax": np.float32(1)}}, {"fpn": {"scale": np.float32(1)}}):
        with pytest.raises(KeyError):
            flax_to_state_dict({**jvars, "quant": {**jvars["quant"], **bad}}, MaskRCNN(qcfg, device="cpu"))
    # a calibration without out_amax: those blocks keep their float edge, and export none
    legacy = {**jvars, "quant": strip_out_amax(jvars["quant"])}
    model.load_state_dict(flax_to_state_dict(legacy, model))
    assert flat_quant(state_dict_to_flax(model)["quant"]) == flat_quant(legacy["quant"])


def test_calibration_without_out_amax_serves_as_qres_0(calibrated, monkeypatch):
    """In both packages, on the backbone: bit for bit the QRES=0 graph."""
    _, _, qstate, _, jvars, _, _ = calibrated
    x = np.random.RandomState(4).randn(1, 64, 64, 3).astype(np.float32)
    bb = {k: v["backbone"] for k, v in jvars.items()}
    jnet = jax_get_backbone("resnet18", dtype=jnp.float32, quant="int8")
    tnet = get_backbone("resnet18", quant="int8").to(memory_format=torch.channels_last).eval()
    sd = {k[len("backbone."):]: v for k, v in qstate.items() if k.startswith("backbone.")}

    def run(strip):
        variables = {**bb, "quant": strip_out_amax(bb["quant"]) if strip else bb["quant"]}
        jc5 = deq(jax.jit(lambda v, x: jnet.apply(v, x, train_bn=False)["C5"], compiler_options=EXACT_DIVISION)(
            variables, x))
        tnet.load_state_dict({k: v for k, v in sd.items() if not (strip and k.endswith("out_amax"))})
        with torch.no_grad():
            tc5 = deq(tnet(nchw(x))["C5"])
        return jc5, tc5

    legacy = run(strip=True)
    monkeypatch.setenv("MASKRCNN_TPU_INT8_QRES", "0")
    qres0 = run(strip=False)
    np.testing.assert_array_equal(legacy[0], qres0[0])
    np.testing.assert_array_equal(legacy[1], qres0[1])


# ---------------------------------------------------------------------------
# the whole detector in int8
# ---------------------------------------------------------------------------


def jax_int8_forward(jcfg, jvars, images, meta):
    """JAX's outputs, C1..C5 and P2..P6; traced anew, so the switches are read now."""
    model = JaxMaskRCNN(jcfg)

    def forward(v, images, meta):
        out, state = model.apply(
            v, images, meta, train=False,
            capture_intermediates=lambda mdl, method: method == "__call__" and mdl.name in ("backbone", "fpn"),
            mutable=["intermediates"])
        inter = state["intermediates"]
        return out, inter["backbone"]["__call__"][0], inter["fpn"]["__call__"][0][0]

    return jax.jit(forward, compiler_options=EXACT_DIVISION)(jvars, images, meta)


def port_int8_forward(qcfg, qstate, images, meta):
    model = MaskRCNN(qcfg, device="cpu")
    model.load_state_dict(qstate)
    seen = {}
    model.backbone.register_forward_hook(lambda m, i, o: seen.update(ends=o))
    model.fpn.register_forward_hook(lambda m, i, o: seen.update(pyramid=o[0]))
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(meta))
    return out, seen["ends"], seen["pyramid"]


def hold_detector(qcfg, qstate, jqcfg, jvars, images, meta):
    jout, jends, jpyr = jax_int8_forward(jqcfg, jvars, images, meta)
    tout, tends, tpyr = port_int8_forward(qcfg, qstate, images, meta)
    for level in ("C2", "C3", "C4", "C5"):
        assert isinstance(tends[level], QTensor) == isinstance(jends[level], tuple), level
        assert rel_l2(deq(tends[level]), deq(jends[level])) <= 1e-3, level
    for i, (t, j) in enumerate(zip(tpyr, jpyr)):
        assert rel_l2(nhwc(t), j) <= 1e-3, f"P{i + 2}"
    for key in ("rpn_logits", "mrcnn_probs"):
        assert np.abs(tout[key].numpy() - np.asarray(jout[key])).max() <= 1e-3, key
    tdet, jdet = tout["detections"].numpy(), np.asarray(jout["detections"])
    np.testing.assert_array_equal(tdet[..., 4], jdet[..., 4])
    assert np.abs(tdet[..., :4] - jdet[..., :4]).max() <= 1e-3
    assert (tdet[..., 4] > 0).sum() >= 1, "no detection: the comparison would be vacuous"
    return tout


def without_head_sites(qcfg, qstate, jqcfg, jvars):
    """The same calibration with ``quant_classifier`` and ``quant_mask_head`` off."""
    off = dict(quant_classifier=False, quant_mask_head=False)
    heads = ("classifier.", "mask_head.")
    state = {k: v for k, v in qstate.items() if not (k.startswith(heads) and is_quant_buffer(k))}
    jq = {k: v for k, v in jvars["quant"].items() if k not in ("classifier", "mask_head")}
    return qcfg.replace(**off), state, jqcfg.replace(**off), {**jvars, "quant": jq}


@pytest.mark.parametrize("switch", ["default", "QRES=0", "QC=0"])
def test_int8_detector_matches_jax(calibrated, monkeypatch, switch):
    """The heads in floating point (the default), under the default switches
    and each residual-stream switch."""
    _, qcfg, qstate, jqcfg, jvars, images, meta = calibrated
    if switch != "default":
        name, value = switch.split("=")
        monkeypatch.setenv(f"MASKRCNN_TPU_INT8_{name}", value)
    hold_detector(*without_head_sites(qcfg, qstate, jqcfg, jvars), images, meta)


def test_int8_detector_with_int8_heads_matches_jax(calibrated):
    """quant_classifier and quant_mask_head: the classifier's two FCs and the
    mask head's four convs in int8 too."""
    _, qcfg, qstate, jqcfg, jvars, images, meta = calibrated
    hold_detector(qcfg, qstate, jqcfg, jvars, images, meta)


def test_int8_mobilenet_detector_with_int8_depthwise_matches_jax(monkeypatch):
    """MobileNet V2 under MASKRCNN_TPU_INT8_DW=1: its depthwise sites in int8
    too (the switch changes nothing on a ResNet)."""
    monkeypatch.setenv("MASKRCNN_TPU_INT8_DW", "1")
    cfg, jcfg, _, variables = detector("mobilenetv2")
    images, meta = small_inputs(seed=7)
    jqcfg, jvars = jax_quantize_for_inference(jcfg, dict(variables), [(jnp.asarray(images), jnp.asarray(meta))])
    jvars = jax.tree.map(np.asarray, jvars)
    qcfg = cfg.replace(quant_mode="int8")
    hold_detector(qcfg, flax_to_state_dict(jvars, MaskRCNN(qcfg, device="cpu")), jqcfg, jvars, images, meta)


# ---------------------------------------------------------------------------
# serving, and the fault: quant_mode was not read
# ---------------------------------------------------------------------------


def test_predictor_int8_matches_jax(calibrated):
    _, qcfg, qstate, jqcfg, jvars, _, _ = calibrated
    img = small_inputs(1, seed=11)[0][0].astype(np.uint8)
    ref = JaxPredictor(jqcfg, jvars).detect([img])[0]
    ours = Predictor(qcfg, qstate, device="cpu").detect([img])[0]
    assert len(ours["class_ids"]) >= 1
    np.testing.assert_array_equal(ours["class_ids"], ref["class_ids"])
    assert np.abs(ours["rois"].astype(int) - ref["rois"].astype(int)).max() <= 1
    np.testing.assert_allclose(ours["scores"], ref["scores"], rtol=0, atol=1e-3)
    assert ours["masks"].shape == ref["masks"].shape
    assert np.mean(ours["masks"] == ref["masks"]) >= 0.99


def test_int8_config_builds_int8_sites(calibrated):
    """``quant_mode='int8'`` builds the int8 sites and serves other outputs
    than the floating-point graph with the same weights."""
    cfg, _, qstate, _, _, images, meta = calibrated
    with pytest.raises(ValueError, match="quant_mode"):
        MaskRCNNConfig(**SMALL, quant_mode="int4")
    int8 = MaskRCNN(cfg.replace(quant_mode="int8"), device="cpu")
    sites = [m for m in int8.modules() if isinstance(m, (Int8Conv2d, Int8Linear))]
    assert len(sites) == 16 + 3 + 8 + 1 + 2 + 4  # ResNet-18 blocks, FPN, RPN, classifier, mask head
    int8.load_state_dict(qstate)
    plain = MaskRCNN(cfg, device="cpu")
    plain.load_state_dict({k: v for k, v in qstate.items() if not is_quant_buffer(k)})
    with torch.no_grad():
        a = int8(torch.from_numpy(images), torch.from_numpy(meta))
        b = plain(torch.from_numpy(images), torch.from_numpy(meta))
    assert not torch.equal(a["rpn_logits"], b["rpn_logits"])
    assert float((a["rpn_logits"] - b["rpn_logits"]).abs().max()) < 1.0
