"""The port's sync-BN (``config.sync_bn``) against the JAX package's, on the
CPU; mirrors ``tests/test_sync_bn.py``.

``layers.BatchNorm`` with a process group on 2 gloo ranks (spawned
processes) against flax ``BatchNorm(axis_name="data")`` under ``shard_map``
on 2 virtual devices, and against one ``BatchNorm`` over the concatenated
batch: outputs, input gradients (of ``sum(y * cotangent)``, which reach
every rank's rows through the reduction) and running statistics, in float32
at a well-conditioned size ([8, 16] rows and [4, 8, 5, 5] maps, per-channel
offsets and scales). Tolerance: each within 2e-6 of max(1, max |reference|);
the running statistics equal on both ranks bit for bit.

The model gives its group to exactly the batch norms into which the JAX
package threads ``bn_axis`` (every one of the backbone and both heads), and
``sync_bn`` without a group raises a ``ValueError`` naming the knob when it
trains (it still serves).
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.layers import BatchNorm
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.parallel.multihost_dryrun import launch

import torch_port_dp_workers as workers

RANKS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
SHAPES = {"2d": (8, 16), "4d": (4, 8, 5, 5)}  # port layout [N, C] / [N, C, H, W]
TOL = 2e-6


def inputs(kind):
    rs = np.random.RandomState({"2d": 0, "4d": 1}[kind])
    shape = SHAPES[kind]
    c = shape[1]
    bshape = (1, c) + (1,) * (len(shape) - 2)
    x = (rs.normal(size=shape) * rs.uniform(0.5, 2.0, c).reshape(bshape) + rs.normal(0, 1, c).reshape(bshape))
    weight, bias = rs.uniform(0.5, 1.5, c), rs.normal(0, 0.1, c)
    stats = np.stack([rs.normal(0, 0.1, c), rs.uniform(0.5, 1.5, c)])
    cot = rs.normal(size=shape)
    return [a.astype(np.float32) for a in (x, weight, bias, stats, cot)]


def nhwc(a):
    return a if a.ndim == 2 else np.moveaxis(a, 1, -1)


def nchw(a):
    return a if a.ndim == 2 else np.moveaxis(a, -1, 1)


@functools.lru_cache(maxsize=None)
def port_ranks(kind):
    x, weight, bias, stats, cot = inputs(kind)
    return launch(workers.sync_bn, RANKS, (x, weight, bias, stats, cot, x.ndim), timeout_s=180)


def flax_shard_map(kind):
    """flax's BatchNorm(axis_name="data") on 2 virtual devices: ``(y, dy/dx,
    running mean, running var)`` with the port's layout."""
    x, weight, bias, stats, cot = inputs(kind)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, axis_name="data")
    variables = {"params": {"scale": weight, "bias": bias}, "batch_stats": {"mean": stats[0], "var": stats[1]}}

    def f(xs, cs):
        def loss(xs):
            y, mut = bn.apply(variables, xs, mutable=["batch_stats"])
            return jnp.sum(y * cs), (y, mut["batch_stats"])

        (_, (y, st)), gx = jax.value_and_grad(loss, has_aux=True)(xs)
        return y, gx, st["mean"][None], st["var"][None]

    from jax.experimental.shard_map import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))
    fn = shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"),) * 4, check_rep=False)
    y, gx, mean, var = jax.tree.map(np.asarray, jax.jit(fn)(nhwc(x), nhwc(cot)))
    return nchw(y), nchw(gx), mean, var


def one_batch_norm(kind):
    """The single-process ``BatchNorm`` over the whole batch."""
    x, weight, bias, stats, cot = (torch.from_numpy(a) for a in inputs(kind))
    bn = BatchNorm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(stats[0])
        bn.running_var.copy_(stats[1])
    x = x.requires_grad_(True)
    y = bn(x)
    (gx,) = torch.autograd.grad((y * cot).sum(), x)
    return y.detach().numpy(), gx.numpy(), bn.running_mean.numpy()[None], bn.running_var.numpy()[None]


def close(got, want):
    return np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("reference", ["flax_shard_map", "one_batch_norm"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_sync_batch_norm_matches(kind, reference):
    out = port_ranks(kind)
    y, gx, mean, var = {"flax_shard_map": flax_shard_map, "one_batch_norm": one_batch_norm}[reference](kind)
    assert close(np.concatenate([o["y"] for o in out]), y)
    assert close(np.concatenate([o["gx"] for o in out]), gx)
    for o in out:
        assert close(o["mean"], mean[0]) and close(o["var"], var[-1])
        assert np.array_equal(o["mean"], out[0]["mean"]) and np.array_equal(o["var"], out[0]["var"])


TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 32, 64, 128),
            pre_nms_limit=64, post_nms_rois_training=16, post_nms_rois_inference=16, train_rois_per_image=8,
            max_gt_instances=3, num_classes=2, compute_dtype="float32", batch_size=1, top_down_pyramid_size=64,
            fpn_cls_fc_layers_size=64, mask_conv_channels=64)


def flax_bn_axes(cfg, monkeypatch):
    """``{module path: axis_name}`` of every flax BatchNorm the JAX model
    builds (traced with ``jax.eval_shape``, nothing computed)."""
    seen = {}
    call = flax_nn.BatchNorm.__call__

    def record(self, *args, **kw):
        seen[self.scope.path] = self.axis_name
        return call(self, *args, **kw)

    monkeypatch.setattr(flax_nn.BatchNorm, "__call__", record)
    model = JaxMaskRCNN(cfg)
    h, w, c = cfg.image_shape
    g, (mh, mw) = cfg.max_gt_instances, cfg.mini_mask_shape
    args = (jnp.zeros((1, h, w, c)), jnp.zeros((1, cfg.meta_size)), jnp.zeros((1, g), jnp.int32),
            jnp.zeros((1, g, 4)), jnp.zeros((1, g, mh, mw)))
    jax.eval_shape(lambda r: model.init({"params": r, "sampling": r}, *args, train=True), jax.random.PRNGKey(0))
    return seen


@pytest.mark.parametrize("backbone", ["resnet18", "seresnext50", "mobilenetv2", "efficientnetb0"])
def test_model_syncs_where_jax_threads_bn_axis(backbone, monkeypatch):
    axes = flax_bn_axes(JaxConfig(**TINY, backbone=backbone, sync_bn=True), monkeypatch)
    group = object()  # the model only keeps it: no collective runs here
    model = MaskRCNN(MaskRCNNConfig(**TINY, backbone=backbone, sync_bn=True), device="cpu", group=group)
    ours = {tuple(name.split(".")): m.group for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    assert set(ours) == set(axes) and len(ours) > 20
    for path, axis in axes.items():
        assert (ours[path] is group) == (axis == "data"), path
    plain = MaskRCNN(MaskRCNNConfig(**TINY, backbone=backbone), device="cpu", group=group)
    assert all(m.group is None for m in plain.modules() if isinstance(m, BatchNorm))


def test_sync_bn_without_a_group_raises_in_training_and_serves():
    """As the JAX step outside ``shard_map``: a forward on batch statistics
    raises naming the knob; the model still serves on running averages."""
    from maskrcnn_tf2_tpu_torch.train.synthetic import synthetic_batch
    from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state, make_train_step

    cfg = MaskRCNNConfig(**TINY, backbone="resnet18", sync_bn=True)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(cfg.replace(max_gt_instances=8), 1, 0, "cpu")
    with pytest.raises(ValueError, match="sync_bn=True needs a process group"):
        make_train_step(cfg)(state, batch, rng=torch.Generator().manual_seed(1))
    out = state.model(batch["images"], batch["image_meta"])
    assert out["detections"].shape == (1, cfg.detection_max_instances, 6)
    assert MaskRCNNConfig(**TINY, parallel_mode="gspmd").tp_shards == 1
    with pytest.raises(ValueError, match="parallel_mode='gspmd'"):
        MaskRCNNConfig(**TINY, tp_shards=2)
