"""Pretrained backbone weights in the port against the JAX package, on the
CPU.

The same files go through JAX ``init_backbone_weights`` and through the
port's ``create_train_state(..., device="cpu")``: torchvision-keyed ResNet-18
and ResNet-50 ``state_dict``s of seeded random tensors saved with
``torch.save``, ``.npz`` files written by either package (whole model and
bare backbone), and ``'imagenet'`` through ``MASKRCNN_TPU_WEIGHTS_DIR``. The
JAX variables, bridged by ``weights.flax_to_state_dict``, equal the port's
entries exactly, and both packages print the same ``loaded/total``. A
wrong-backbone file raises in both and a torchvision MobileNet V2 file loads
in both; an ``.npz`` shape mismatch raises and a ``.pt`` one is skipped in
both. ``tests/test_torch_port_zoo_pretrained.py`` holds the other layouts.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.models import get_backbone as jax_get_backbone
from maskrcnn_tf2_tpu.models.backbones import pretrained as jax_pretrained
from maskrcnn_tf2_tpu.ops.image import compose_image_meta

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.backbones import pretrained
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.train.synthetic import resnet_state_dict, torchvision_mobilenet_v2_state_dict
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_, state_dict_to_flax

from torch_port_helpers import randomize

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, num_classes=4, top_down_pyramid_size=64,
            fpn_cls_fc_layers_size=64, mask_conv_channels=64, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


_JAX_VARIABLES = {}


def jax_variables(backbone):
    """Fresh JAX model variables (jitted init, cached per backbone)."""
    if backbone not in _JAX_VARIABLES:
        model = JaxMaskRCNN(JaxConfig(backbone=backbone, **TINY))
        img = np.zeros((1, 64, 64, 3), np.float32)
        meta = compose_image_meta(0, (64, 64, 3), (64, 64, 3), (0, 0, 64, 64), 1.0, np.ones(4))[None]
        _JAX_VARIABLES[backbone] = jax.jit(lambda r: model.init({"params": r}, img, meta, train=False))(
            jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, _JAX_VARIABLES[backbone])


def port_state(backbone, source=None):
    cfg = MaskRCNNConfig(backbone=backbone, backbone_init_weights=source, **TINY)
    return create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu").model


def jax_load(backbone, source):
    cfg = JaxConfig(backbone=backbone, backbone_init_weights=source, **TINY)
    return jax_pretrained.init_backbone_weights(jax_variables(backbone), cfg)[0]


def assert_backbone_equal(variables, model, skip=()):
    """The JAX variables bridged to the port equal the port's backbone
    entries exactly (but ``skip``)."""
    bridged = flax_to_state_dict(variables, model)
    got = model.state_dict()
    keys = [k for k in got if k.startswith("backbone.") and not k.endswith("num_batches_tracked") and k not in skip]
    assert keys
    for k in keys:
        assert torch.equal(got[k], bridged[k]), k


def printed_coverage(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("loaded pretrained backbone")]
    return [ln.split(" leaves")[0] for ln in lines]


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_torchvision_file_loads_as_in_jax(tmp_path, capsys, backbone):
    """A torchvision-keyed ``.pth`` gives the JAX package's backbone exactly,
    with the same coverage (every leaf: 100 for ResNet-18, 265 for ResNet-50,
    ``num_batches_tracked`` not counted)."""
    path = str(tmp_path / f"{backbone}.pth")
    torch.save(resnet_state_dict(backbone, seed=5), path)
    jvars = jax_load(backbone, path)
    model = port_state(backbone, path)
    jax_line, port_line = printed_coverage(capsys)
    total = {"resnet18": 100, "resnet50": 265}[backbone]
    assert jax_line == port_line == f"loaded pretrained backbone: {total}/{total}"
    assert pretrained.backbone_leaf_count(model) == jax_pretrained.backbone_leaf_count(jvars) == total
    assert_backbone_equal(jvars, model)


def test_non_backbone_entries_keep_their_seeded_draws(tmp_path):
    path = str(tmp_path / "r18.pth")
    torch.save(resnet_state_dict("resnet18", seed=5), path)
    loaded, fresh = port_state("resnet18", path).state_dict(), port_state("resnet18").state_dict()
    heads = [k for k in fresh if not k.startswith("backbone.")]
    assert heads and all(torch.equal(loaded[k], fresh[k]) for k in heads)
    assert not torch.equal(loaded["backbone.stem.conv.weight"], fresh["backbone.stem.conv.weight"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_written_by_either_package_loads_in_the_other(tmp_path, capsys, writer):
    """A whole-model npz (heads too: both packages load every leaf they
    find): the JAX package's file into the port and the port's into the JAX
    package, exactly, with the same count."""
    path = str(tmp_path / "model.npz")
    source = randomize(jax_variables("resnet18"), np.random.RandomState(2))
    if writer == "jax":
        jax_pretrained.save_backbone_npz(source, path)
    else:
        model = MaskRCNN(MaskRCNNConfig(backbone="resnet18", **TINY), device="cpu")
        model.load_state_dict(flax_to_state_dict(source, model))
        pretrained.save_backbone_npz(model, path)
    jvars = jax_load("resnet18", path)
    model = port_state("resnet18", path)
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line
    assert model.state_dict().keys() == flax_to_state_dict(jvars, model).keys()
    for k, v in flax_to_state_dict(jvars, model).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k
    assert_backbone_equal(source, model)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bare_backbone_npz(tmp_path, capsys, writer):
    """A file written from a bare backbone (keys without ``backbone/``) loads
    into the whole model in both packages."""
    path = str(tmp_path / "bare.npz")
    if writer == "jax":
        bare = jax_get_backbone("resnet18", dtype=np.float32)
        variables = jax.jit(lambda r: bare.init({"params": r}, np.zeros((1, 64, 64, 3), np.float32), train_bn=False))(
            jax.random.PRNGKey(3))
        jax_pretrained.save_backbone_npz(randomize(jax.tree.map(np.asarray, variables), np.random.RandomState(4)), path)
    else:
        model = lecun_init_(MaskRCNN(MaskRCNNConfig(backbone="resnet18", **TINY), device="cpu"),
                            torch.Generator().manual_seed(9))
        pretrained.save_backbone_npz(model.backbone, path)
    with np.load(path) as data:
        assert "params/stem/conv/kernel" in data.files
    jvars = jax_load("resnet18", path)
    model = port_state("resnet18", path)
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line == "loaded pretrained backbone: 100/100"
    assert_backbone_equal(jvars, model)


def test_imagenet_resolves_through_the_weights_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MASKRCNN_TPU_WEIGHTS_DIR", str(tmp_path))
    for load in (lambda: jax_load("resnet18", "imagenet"), lambda: port_state("resnet18", "imagenet")):
        with pytest.raises(FileNotFoundError, match="resnet18.npz"):
            load()
    model = lecun_init_(MaskRCNN(MaskRCNNConfig(backbone="resnet18", **TINY), device="cpu"),
                        torch.Generator().manual_seed(7))
    pretrained.save_backbone_npz(model.backbone, str(tmp_path / "resnet18.npz"))
    jvars = jax_load("resnet18", "imagenet")
    loaded = port_state("resnet18", "imagenet")
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line == "loaded pretrained backbone: 100/100"
    assert_backbone_equal(jvars, loaded)
    assert_backbone_equal(state_dict_to_flax(model), loaded)


def test_wrong_backbone_and_mobilenet_files_raise_in_both(tmp_path, capsys):
    """ResNet-18 weights for ResNet-50 cover the same few leaves in both
    packages and raise. A torchvision MobileNet V2 file, refused before the
    zoo was ported, loads into a ``mobilenetv2`` model in both packages with
    the same coverage (every leaf) and the same values."""
    r18 = str(tmp_path / "r18.pth")
    torch.save(resnet_state_dict("resnet18", seed=1), r18)
    messages = []
    for load in (lambda: jax_load("resnet50", r18), lambda: port_state("resnet50", r18)):
        with pytest.raises(ValueError, match="covered only") as err:
            load()
        messages.append(str(err.value).split(" backbone leaves")[0])
    assert messages[0] == messages[1]
    mobilenet = str(tmp_path / "mnv2.pth")
    torch.save(torchvision_mobilenet_v2_state_dict(seed=1), mobilenet)
    jvars = jax_load("mobilenetv2", mobilenet)
    model = port_state("mobilenetv2", mobilenet)
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line == "loaded pretrained backbone: 255/255"
    assert_backbone_equal(jvars, model)


def test_shape_mismatch_raises_for_npz_and_is_skipped_for_pt(tmp_path, capsys):
    npz = str(tmp_path / "bad.npz")
    np.savez(npz, **{"params/backbone/stem/conv/kernel": np.zeros((3, 3, 3, 64), np.float32)})
    for load in (lambda: jax_load("resnet18", npz), lambda: port_state("resnet18", npz)):
        with pytest.raises(ValueError, match="shape mismatch"):
            load()
    sd = resnet_state_dict("resnet18", seed=2)
    sd["conv1.weight"] = torch.zeros(64, 3, 3, 3)  # one leaf of 100 misses: 99/100 passes the 90 % rule
    pt = str(tmp_path / "one_off.pt")
    torch.save(sd, pt)
    jvars = jax_load("resnet18", pt)
    model = port_state("resnet18", pt)
    jax_line, port_line = printed_coverage(capsys)
    assert jax_line == port_line == "loaded pretrained backbone: 99/100"
    # the skipped leaf keeps each package's own seeded draw
    assert_backbone_equal(jvars, model, skip=("backbone.stem.conv.weight",))
    assert torch.equal(model.state_dict()["backbone.stem.conv.weight"],
                       port_state("resnet18").state_dict()["backbone.stem.conv.weight"])


def test_a_pickled_module_is_refused(tmp_path):
    """``weights_only=True``: a whole pickled module is not loaded."""
    path = str(tmp_path / "module.pt")
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(pickle.UnpicklingError):
        port_state("resnet18", path)


def test_state_dict_to_flax_inverts_the_bridge():
    model = lecun_init_(MaskRCNN(MaskRCNNConfig(backbone="resnet50", **TINY), device="cpu"),
                        torch.Generator().manual_seed(1))
    variables = state_dict_to_flax(model)
    jvars = jax_variables("resnet50")
    flat = lambda tree: {k: np.shape(v) for k, v in jax_pretrained._flatten(tree).items()}  # noqa: E731
    assert flat(variables["params"]) == flat(jvars["params"])
    assert flat(variables["batch_stats"]) == flat(jvars["batch_stats"])
    back = flax_to_state_dict(variables, model)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
