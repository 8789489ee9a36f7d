"""C1..C5 of each backbone family in the port against the JAX package's, on
the CPU.

One case per family at 64x64, batch 2: SE-ResNet-18; SENet154's code at a
smaller depth (one grouped 64x4d bottleneck a stage, squeeze-excite, the deep
stem); the same as ResNeXt (32x4d, no SE, the 7x7 stem); MobileNet V1 and V2;
EfficientNet-B0. The port's seeded weights (``weights.lecun_init_``) with
every bias and batch-norm leaf randomised by ``torch_port_helpers.randomize``
go to flax through ``weights.state_dict_to_flax``. C1..C5 are compared in
eval mode in float32, and with batch statistics C1..C5 and the updated
running statistics in float64 (JAX under ``jax.enable_x64``). Tolerance:
max |port - flax| <= 1e-4 * max |flax|.

Why float64 for batch statistics: over 2 images of a 2x2 C5 map they are
ill-conditioned in float32. After 13-17 such layers JAX's own float32 C5 lies
1.8e-4 (MobileNet V1) and 2.4e-4 (MobileNet V2) of max |C5| from its float64
value, the port's 7.8e-5 and 6.3e-5; in float64 the two packages agree within
4e-13 (within 1e-7 and 3e-6 with squeeze-excite, whose mean and sigmoid both
packages take in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.models import get_backbone as jax_get_backbone
from maskrcnn_tf2_tpu.models.backbones.efficientnet import EfficientNet as JaxEfficientNet
from maskrcnn_tf2_tpu.models.backbones.resnet import ResNet as JaxResNet

from maskrcnn_tf2_tpu_torch.models.backbones.efficientnet import EfficientNet
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import ResNet
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict, lecun_init_, state_dict_to_flax

from jit_fast import jit_fast
from torch_port_helpers import randomize

LEVELS = ("C1", "C2", "C3", "C4", "C5")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.max(np.abs(ours - ref)) / max(1e-6, np.max(np.abs(ref))))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


FAMILIES = {
    "seresnet18": (lambda d: jax_get_backbone("seresnet18", dtype=d), lambda: get_backbone("seresnet18")),
    # SENet154's code at a smaller depth: grouped 64x4d bottlenecks, SE, the deep stem
    "senet_small": (
        lambda d: JaxResNet(stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=64, base_width=4, use_se=True,
                            deep_stem=True, dtype=d),
        lambda: ResNet(stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=64, base_width=4, use_se=True,
                       deep_stem=True)),
    "resnext_small": (
        lambda d: JaxResNet(stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=32, base_width=4, dtype=d),
        lambda: ResNet(stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=32, base_width=4)),
    "mobilenet": (lambda d: jax_get_backbone("mobilenet", dtype=d), lambda: get_backbone("mobilenet")),
    "mobilenetv2": (lambda d: jax_get_backbone("mobilenetv2", dtype=d), lambda: get_backbone("mobilenetv2")),
    "efficientnet_b0": (lambda d: JaxEfficientNet(width=1.0, depth=1.0, dtype=d),
                        lambda: EfficientNet(width=1.0, depth=1.0)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_endpoints_and_batch_statistics_match_flax(family):
    make_jax, make_port = FAMILIES[family]
    x = np.random.RandomState(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    tnet = lecun_init_(make_port(), torch.Generator().manual_seed(1))
    variables = randomize(state_dict_to_flax(tnet), np.random.RandomState(4))
    jnet = make_jax(jnp.float32)
    ends = jit_fast(lambda v, x: jnet.apply(v, x, train_bn=False))(variables, x)
    state = flax_to_state_dict(variables, tnet)
    tnet.load_state_dict(state)
    with torch.no_grad():
        tends = tnet.eval()(nchw(x))
    for level in LEVELS:
        assert rel_err(nhwc(tends[level]), ends[level]) <= 1e-4, ("eval", level)

    with jax.enable_x64(True):
        jnet64 = make_jax(jnp.float64)
        v64 = jax.tree.map(lambda a: a.astype(np.float64), variables)
        train_ends, updated = jit_fast(lambda v, x: jnet64.apply(v, x, train_bn=True, mutable=["batch_stats"]))(
            v64, x.astype(np.float64))
        train_ends, updated = jax.tree.map(np.asarray, (train_ends, updated))
    tnet = tnet.double()
    tnet.load_state_dict(state)
    with torch.no_grad():
        ttrain = tnet.train()(nchw(x).double())
    for level in LEVELS:
        assert rel_err(nhwc(ttrain[level]), train_ends[level]) <= 1e-4, ("batch statistics", level)
    want = flax_to_state_dict({"params": variables["params"], **updated}, tnet)
    for name, value in tnet.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            w = want[name].numpy()
            assert np.abs(value.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
