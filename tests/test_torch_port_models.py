"""Module parity of the PyTorch port with the flax modules, on the CPU.

The flax modules are initialised, their biases and batch-norm parameters and
statistics are randomised from a numpy seed, and ``weights.flax_to_state_dict``
carries the variables into the port. Each module then gets the same numpy
input in both frameworks. Tolerance: max |port - flax| <= 1e-4 * max |flax|
in float32 (convolutions sum in another order in the two frameworks).
"""

import numpy as np
import pytest
import torch

import jax

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.models.backbones.resnet import RESNET_VARIANTS as JAX_VARIANTS
from maskrcnn_tf2_tpu.models.backbones.resnet import ResNet as JaxResNet
from maskrcnn_tf2_tpu.ops.image import compose_image_meta

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_

from torch_port_helpers import randomize

TINY = dict(
    image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128), backbone="resnet18",
    top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
    pre_nms_limit=256, post_nms_rois_inference=64, num_classes=3, compute_dtype="float32",
)


def rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.max(np.abs(ours - ref)) / max(1e-6, np.max(np.abs(ref))))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxMaskRCNN(jcfg)
    img = np.zeros((1, 128, 128, 3), np.float32)
    meta = compose_image_meta(0, (128, 128, 3), (128, 128, 3), (0, 0, 128, 128), 1.0, np.ones(3))[None]
    variables = jax.jit(lambda r: jmodel.init({"params": r}, img, meta, train=False))(jax.random.PRNGKey(0))
    variables = randomize(variables, np.random.RandomState(0))
    tmodel = MaskRCNN(MaskRCNNConfig(**TINY), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    return jmodel, variables, tmodel


def test_weight_bridge_consumes_every_leaf_once(models):
    _, variables, tmodel = models
    sd = flax_to_state_dict(variables, tmodel)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert set(sd) == set(tmodel.state_dict())
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == n_leaves
    # a leaf that maps nowhere, and a model entry left unassigned, both raise
    extra = {**variables, "params": {**variables["params"], "stray": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(KeyError):
        flax_to_state_dict(extra, tmodel)
    short = {**variables, "params": {k: v for k, v in variables["params"].items() if k != "rpn"}}
    with pytest.raises(KeyError, match="unassigned"):
        flax_to_state_dict(short, tmodel)
    # the deconv kernel is flipped: W[c, f, i, j] = K[1-i, 1-j, c, f]
    k = variables["params"]["mask_head"]["mrcnn_mask_deconv"]["kernel"]
    w = sd["mask_head.mrcnn_mask_deconv.weight"].numpy()
    np.testing.assert_array_equal(w[3, 5, 0, 1], k[1, 0, 3, 5])


@pytest.mark.parametrize("hw", [(128, 128), (96, 160)])
def test_backbone_fpn_rpn_match(models, hw):
    jmodel, variables, tmodel = models
    x = np.random.RandomState(1).normal(size=(2,) + hw + (3,)).astype(np.float32)

    def flax_fn(v, x):
        def run(m, x):
            ends = m.backbone(x, train_bn=False)
            rpn_feats, _ = m.fpn(ends)
            return ends, rpn_feats, m.rpn(rpn_feats)

        return jmodel.apply(v, x, method=run)

    ends, pyr, (logits, probs, bbox) = jax.jit(flax_fn)(variables, x)
    with torch.no_grad():
        tends = tmodel.backbone(nchw(x))
        tpyr, _ = tmodel.fpn(tends)
        tlogits, tprobs, tbbox = tmodel.rpn(tpyr)
    for level in ("C1", "C2", "C3", "C4", "C5"):
        assert rel_err(nhwc(tends[level]), ends[level]) <= 1e-4, level
    for i in range(5):
        assert rel_err(nhwc(tpyr[i]), pyr[i]) <= 1e-4, f"P{i + 2}"
    for ours, ref in ((tlogits, logits), (tprobs, probs), (tbbox, bbox)):
        assert rel_err(ours.numpy(), ref) <= 1e-4


def test_heads_match(models):
    jmodel, variables, tmodel = models
    rs = np.random.RandomState(2)
    pooled = rs.normal(size=(2, 5, 7, 7, 64)).astype(np.float32)
    mpooled = rs.normal(size=(2, 5, 14, 14, 64)).astype(np.float32)

    def flax_fn(v, a, b):
        def run(m, a, b):
            return m.classifier(a, train_bn=False), m.mask_head(b, train_bn=False)

        return jmodel.apply(v, a, b, method=run)

    (logits, probs, deltas), masks = jax.jit(flax_fn)(variables, pooled, mpooled)
    with torch.no_grad():
        tl, tp, td = tmodel.classifier(torch.from_numpy(pooled))
        tm = tmodel.mask_head(torch.from_numpy(mpooled))
    for ours, ref in ((tl, logits), (tp, probs), (td, deltas), (tm, masks)):
        assert rel_err(ours.numpy(), ref) <= 1e-4


def test_resnet50_bottleneck_matches():
    """The flagship's bottleneck backbone, at a small odd/even input."""
    x = np.random.RandomState(3).normal(size=(1, 66, 64, 3)).astype(np.float32)
    jnet = JaxResNet(dtype=np.float32, **JAX_VARIANTS["resnet50"])
    v = jax.jit(jnet.init)(jax.random.PRNGKey(1), x)
    v = randomize(v, np.random.RandomState(4))
    ends = jax.jit(lambda v, x: jnet.apply(v, x, train_bn=False))(v, x)
    tnet = get_backbone("resnet50").eval()
    tnet.load_state_dict(flax_to_state_dict(v, tnet))
    with torch.no_grad():
        tends = tnet(nchw(x))
    for level in ("C2", "C3", "C4", "C5"):
        assert rel_err(nhwc(tends[level]), ends[level]) <= 1e-4, level


def test_factory_names_unported_backbones():
    with pytest.raises(ValueError, match="not ported"):
        get_backbone("mobilenetv2")


def test_lecun_init_is_seeded():
    a = MaskRCNN(MaskRCNNConfig(**TINY), device="cpu")
    b = MaskRCNN(MaskRCNNConfig(**TINY), device="cpu")
    lecun_init_(a, torch.Generator().manual_seed(5))
    lecun_init_(b, torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.backbone.stem.conv.weight
    assert abs(float(w.detach().std()) * (3 * 49) ** 0.5 - 1.0) < 0.1


def test_training_is_not_ported_yet():
    m = MaskRCNN(MaskRCNNConfig(**TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="A.12"):
        m(torch.zeros((1, 128, 128, 3)), torch.zeros((1, 15)), train=True)
