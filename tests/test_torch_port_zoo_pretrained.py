"""Pretrained weights for the whole backbone zoo, the port against the JAX
package on the CPU, and the layers and counts that come with the zoo.

- Converters: seeded ``state_dict``s written under each layout's own names
  (``train/synthetic.py``: torchvision ResNeXt, timm ``legacy_senet154`` at a
  smaller depth with its deep stem, the same with squeeze-excite as linear
  layers ``se.fc{i}``, torchvision ``mobilenet_v2``, timm ``mobilenetv1_100``,
  timm ``efficientnet_b0``) load through both packages' ``load_backbone_params``
  from the same starting weights: equal counts, every entry of the backbone
  covered, and equal values (the port read back through
  ``weights.state_dict_to_flax``), bit for bit.
- The single-conv ``layer0`` of timm ``legacy_seresnet*``: the port loads it
  into ``stem``; the JAX package maps it to the deep stem's ``stem1``, which
  the model lacks, and skips it. This divergence is by design (ROADMAP §C).
- ``create_train_state`` from a timm EfficientNet-B0 file and from
  ``'imagenet'`` prints the JAX package's ``loaded/total``.
- A 5x5 stride-2 "SAME" depthwise conv pads as flax does, ``lecun_init_``'s
  fan-in of grouped and depthwise kernels is flax's, and ``summarize`` prints
  the JAX package's string.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.models.backbones import pretrained as jax_pretrained
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.utils import summary as jax_summary

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.backbones import pretrained
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import ResNet
from maskrcnn_tf2_tpu_torch.models.layers import SameConv2d, same_pad_amounts
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.train import synthetic
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state
from maskrcnn_tf2_tpu_torch.utils.summary import count_params, summarize
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_, state_dict_to_flax

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, num_classes=4, top_down_pyramid_size=64,
            fpn_cls_fc_layers_size=64, mask_conv_channels=64, compute_dtype="float32")
SENET_SMALL = dict(stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=64, base_width=4, use_se=True,
                   deep_stem=True)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Holder(nn.Module):
    """A bare backbone under ``backbone.``, as the whole model holds it."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = lecun_init_(backbone, torch.Generator().manual_seed(3))


def linear_se(sd):
    """The same file with squeeze-excite as linear layers ``se.fc{i}``."""
    out = {}
    for k, v in sd.items():
        if ".se_module." in k:
            k, v = k.replace(".se_module.", ".se."), v.reshape(v.shape[0], -1) if v.dim() == 4 else v
        out[k] = v
    return out


LAYOUTS = {
    "torchvision_resnext50": (lambda: get_backbone("resnext50"), lambda: synthetic.resnet_state_dict("resnext50", 1)),
    "timm_senet154_small": (lambda: ResNet(**SENET_SMALL),
                            lambda: synthetic.resnet_state_dict(SENET_SMALL, 2, layout="timm")),
    "linear_se": (lambda: ResNet(**SENET_SMALL),
                  lambda: linear_se(synthetic.resnet_state_dict(SENET_SMALL, 3, layout="timm"))),
    "torchvision_mobilenet_v2": (lambda: get_backbone("mobilenetv2"),
                                 lambda: synthetic.torchvision_mobilenet_v2_state_dict(4)),
    "timm_mobilenetv1_100": (lambda: get_backbone("mobilenet"), lambda: synthetic.timm_mobilenet_v1_state_dict(5)),
    "timm_efficientnet_b0": (lambda: get_backbone("efficientnetb0"),
                             lambda: synthetic.timm_efficientnet_state_dict("efficientnetb0", 6)),
}


def flat(variables):
    return {c + "/" + "/".join(p): np.asarray(v) for c in ("params", "batch_stats")
            for p, v in jax_pretrained._flatten(variables[c]).items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_load_as_in_jax(tmp_path, layout):
    make_backbone, make_file = LAYOUTS[layout]
    model = Holder(make_backbone())
    start = state_dict_to_flax(model)
    path = str(tmp_path / "weights.pth")
    torch.save(make_file(), path)
    jvars, jax_loaded = jax_pretrained.load_backbone_params(start, path)
    loaded = pretrained.load_backbone_params(model, path)
    assert loaded == jax_loaded == pretrained.backbone_leaf_count(model)
    got, want = flat(state_dict_to_flax(model)), flat(jvars)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    before = flat(start)
    assert sum(not np.array_equal(v, before[k]) for k, v in want.items()) == loaded  # every leaf came from the file


def test_single_conv_layer0_loads_into_stem_in_the_port_and_is_skipped_by_jax(tmp_path):
    """timm ``legacy_seresnet18``: ``layer0.conv1``/``layer0.bn1`` is the 7x7
    stem. The port's converter takes the deep-stem branch only when the file
    has ``layer0.conv3.weight``; the JAX package's maps it to ``stem1``."""
    sd = synthetic.resnet_state_dict("seresnet18", 7, layout="timm")
    assert "layer0.conv1.weight" in sd and "layer0.conv3.weight" not in sd
    ours = pretrained.convert_torch_resnet(sd)
    assert torch.equal(ours["stem.conv.weight"], sd["layer0.conv1.weight"])
    assert not any(k.startswith("stem1") for k in ours)
    theirs = jax_pretrained.convert_torch_resnet(sd)
    assert "stem1" in theirs["params"] and "stem" not in theirs["params"]

    model = Holder(get_backbone("seresnet18"))
    start = state_dict_to_flax(model)
    path = str(tmp_path / "seresnet18.pth")
    torch.save(sd, path)
    jvars, jax_loaded = jax_pretrained.load_backbone_params(start, path)
    loaded = pretrained.load_backbone_params(model, path)
    total = pretrained.backbone_leaf_count(model)
    assert (loaded, jax_loaded) == (total, total - 5)  # the stem's kernel, scale, bias, mean and var
    got, want, before = flat(state_dict_to_flax(model)), flat(jvars), flat(start)
    for k, v in want.items():
        if "/stem/" in k:
            np.testing.assert_array_equal(v, before[k], err_msg=k)  # JAX keeps its seeded stem
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["params/backbone/stem/conv/kernel"],
                                  sd["layer0.conv1.weight"].numpy().transpose(2, 3, 1, 0))


def printed_coverage(capsys):
    return [ln.split(" leaves")[0] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("loaded pretrained backbone")]


def test_create_train_state_from_a_timm_efficientnet_file(tmp_path, capsys):
    """The port's ``create_train_state`` and the JAX package's
    ``init_backbone_weights`` print the same coverage for one file, and the
    backbones agree bit for bit."""
    path = str(tmp_path / "efficientnet_b0.pth")
    sd = synthetic.timm_efficientnet_state_dict("efficientnetb0", 8)
    torch.save(sd, path)
    cfg = dict(TINY, backbone="efficientnetb0", backbone_init_weights=path)
    model = create_train_state(MaskRCNNConfig(**cfg), torch.Generator().manual_seed(0), device="cpu").model
    fresh = MaskRCNN(MaskRCNNConfig(**dict(cfg, backbone_init_weights=None)), device="cpu")
    jvars, _ = jax_pretrained.init_backbone_weights(state_dict_to_flax(fresh), JaxConfig(**cfg))
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line == "loaded pretrained backbone: 304/304"
    bridged = flax_to_state_dict(jvars, model)
    for k, v in model.state_dict().items():
        if k.startswith("backbone.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, bridged[k]), k
    assert torch.equal(model.state_dict()["backbone.block1.se_reduce.weight"],
                       sd["blocks.1.0.se.conv_reduce.weight"][:, :, 0, 0])


@pytest.mark.parametrize("backbone", ["mobilenet", "efficientnetb0"])
def test_imagenet_resolves_to_the_keys_npz(tmp_path, monkeypatch, capsys, backbone):
    monkeypatch.setenv("MASKRCNN_TPU_WEIGHTS_DIR", str(tmp_path))
    source = lecun_init_(get_backbone(backbone), torch.Generator().manual_seed(9))
    pretrained.save_backbone_npz(source, str(tmp_path / f"{backbone}.npz"))
    model = create_train_state(MaskRCNNConfig(**dict(TINY, backbone=backbone, backbone_init_weights="imagenet")),
                               torch.Generator().manual_seed(0), device="cpu").model
    total = pretrained.backbone_leaf_count(model)
    assert printed_coverage(capsys) == [f"loaded pretrained backbone: {total}/{total}"]
    for k, v in source.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()["backbone." + k], v), k


@pytest.mark.parametrize("size", [16, 15])
def test_depthwise_5x5_stride_2_pads_as_flax(size):
    """flax "SAME" at stride 2 pads a 5x5 window (1, 2) at an even size and
    (2, 2) at an odd one; a depthwise conv with ``groups == channels``."""
    assert same_pad_amounts(16, 5, 2) == (1, 2) and same_pad_amounts(15, 5, 2) == (2, 2)
    c = 6
    conv = flax_nn.Conv(c, (5, 5), strides=(2, 2), padding="SAME", use_bias=False, feature_group_count=c)
    x = np.random.RandomState(size).normal(size=(2, size, size + 1, c)).astype(np.float32)
    variables = jax.jit(conv.init)(jax.random.PRNGKey(0), x)
    ref = jax.jit(conv.apply)(variables, x)
    ours = SameConv2d(c, c, 5, 2, bias=False, groups=c)
    assert tuple(ours.weight.shape) == (c, 1, 5, 5)
    ours.load_state_dict(flax_to_state_dict(variables, ours))
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - np.asarray(ref)).max() <= 1e-5 * np.abs(np.asarray(ref)).max()


@pytest.mark.parametrize("kind", ["grouped", "depthwise"])
def test_lecun_init_fan_in_of_grouped_and_depthwise_kernels_is_flaxs(kind):
    """Grouped: ResNeXt's 3x3 over 128 channels in 32 groups, fan-in 4 * 9;
    depthwise: 96 channels, fan-in 9. Both packages draw with std
    1 / sqrt(fan_in)."""
    cin, groups = (128, 32) if kind == "grouped" else (96, 96)
    fan_in = cin // groups * 9
    conv = SameConv2d(cin, cin, 3, groups=groups, bias=False)
    lecun_init_(conv, torch.Generator().manual_seed(0))
    assert tuple(conv.weight.shape) == (cin, cin // groups, 3, 3)
    flax_conv = flax_nn.Conv(cin, (3, 3), feature_group_count=groups, use_bias=False)
    kernel = flax_conv.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, cin)))["params"]["kernel"]
    assert kernel.shape == (3, 3, cin // groups, cin)
    for std in (float(conv.weight.detach().std()), float(np.std(kernel))):
        assert abs(std * fan_in**0.5 - 1.0) < 0.05, std


@pytest.mark.parametrize("backbone", ["mobilenetv2", "seresnext50"])
def test_summarize_equals_jax(backbone):
    cfg = dict(TINY, backbone=backbone)
    jmodel = JaxMaskRCNN(JaxConfig(**cfg))
    img = np.zeros((1, 64, 64, 3), np.float32)
    meta = compose_image_meta(0, (64, 64, 3), (64, 64, 3), (0, 0, 64, 64), 1.0, np.ones(4))[None]
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, img, meta, train=False), jax.random.PRNGKey(0))
    with torch.device("meta"):
        model = MaskRCNN(MaskRCNNConfig(**cfg), device="meta")
    assert summarize(model) == jax_summary.summarize(shapes)
    assert summarize(model, per_module=False) == jax_summary.summarize(shapes, per_module=False)
    assert count_params(model.backbone) == jax_summary.count_params(shapes["params"]["backbone"])
