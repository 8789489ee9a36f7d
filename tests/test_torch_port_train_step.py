"""The PyTorch port's training step against the JAX package's, on the CPU.

A tiny float32 configuration (ResNet-18, 64x64 with anchors of 16-64 px so
that random weights still propose boxes the size of the GT, 64-wide FPN,
128-wide FC, 64-wide mask head, 32 proposals, 8 ROIs per image, 3 classes,
batch 2) runs
one step in both packages with the same bridged weights, the same batch and
the same uniform draws: JAX's, taken from its keys the way its step splits
them, and handed to the port. Tolerances: each loss <= 1e-5 relative; each
gradient leaf within 1e-4 * (max |JAX leaf| + the step's largest |JAX
gradient|); after the adamax step every parameter within 1e-3 * lr where
|JAX grad| >= 1e-4 and within 2 * lr everywhere (the first adamax update is
lr * g / (|g| + eps), so each side moves at most lr, and a near-zero
gradient's sign can differ); batch-norm statistics <= 1e-5 of max(1,
max |JAX statistic|).

Why the gradient tolerance has a step-wide term: at random weights the
gradients of a ReLU network with batch norms are not smooth in its inputs. A
perturbation that flips a ReLU or a max-pool argmax in a layer of few
positions, or shifts the statistics of a channel that is nearly constant
across the batch, moves some leaves by percents, and summing in another
order, as the two frameworks do, is such a perturbation
(``tests/torch_port_conditioning.py`` measures both effects: ResNet-18
leaves moved by up to 0.7 % with batch statistics and up to 8.6 % with
running averages by a 1e-6 input perturbation; JAX's float32 gradient of the
first mask-head layers here 5e-4 off its float64 value, 2.4 % with padding
slots, the port's within 4e-6). In this scene the first mask-head layers
differ the most, inside the step-wide term. With the batch norms on their running averages no such flip happens in this
scene, and every leaf agrees within 1e-4 of its own size
(``test_gradients_match_jax_on_running_averages``).
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.losses import batchnorm_module_paths as jax_batchnorm_module_paths
from maskrcnn_tf2_tpu.losses import l2_reg_loss as jax_l2_reg_loss
from maskrcnn_tf2_tpu.ops.anchors import get_anchors as jax_get_anchors
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from maskrcnn_tf2_tpu.train.train_step import _loss_and_updates
from maskrcnn_tf2_tpu.train.train_step import create_train_state as jax_create_train_state

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.losses import l2_reg_loss
from maskrcnn_tf2_tpu_torch.train.train_step import _loss, create_train_state, make_eval_step, make_train_step
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from torch_port_helpers import randomize

BASE = dict(
    image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(16, 24, 32, 48, 64),
    pre_nms_limit=128, post_nms_rois_training=32, post_nms_rois_inference=32, train_rois_per_image=8,
    roi_positive_ratio=0.25, max_gt_instances=4, num_classes=3, backbone="resnet18", top_down_pyramid_size=64,
    fpn_cls_fc_layers_size=128, mask_conv_channels=64, compute_dtype="float32",
)
B, G, H = 2, 4, 64


def make_batch(with_rois=False):
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 255, (B, 8, 8, 3))
    images = np.clip(np.repeat(np.repeat(x, 8, 1), 8, 2) + rs.normal(0, 8, (B, H, H, 3)), 0, 255)
    meta = compose_image_meta(0, (H, H, 3), (H, H, 3), (0, 0, H, H), 1.0, np.ones(3))
    # GT boxes on some of the seeded model's proposals: every image gets the
    # 2 positives that fill its 8 slots (2 + 3 * 2 negatives at ratio 0.25)
    boxes = np.asarray([
        [[0.51, 0.26, 0.77, 0.44], [0.25, 0.39, 0.55, 0.68], [0.10, 0.07, 0.43, 0.31], [0.10, 0.68, 0.39, 0.91]],
        [[0.02, 0.33, 0.38, 0.50], [0.15, 0.24, 0.47, 0.62], [0.53, 0.82, 0.75, 0.93], [0.0, 0.0, 0.0, 0.0]],
    ], np.float32)
    ids = np.asarray([[1, 2, 1, 3], [2, 2, 1, 0]], np.int32)  # the last a padding row
    masks = (rs.uniform(size=(B, G, 56, 56)) > 0.4).astype(np.float32)
    batch = {"images": images.astype(np.float32), "image_meta": np.tile(meta, (B, 1)),
             "gt_class_ids": ids, "gt_boxes": boxes, "gt_masks": masks}
    if with_rois:  # 32 ROIs per image: its first two GT boxes, shifted a little
        shift = np.linspace(-0.02, 0.02, 16, dtype=np.float32)[:, None, None]
        batch["input_rois"] = np.clip(boxes[:, None, :2] + shift[None], 0, 1).reshape(B, 32, 4)
    return batch


class _SamplingKey(flax_nn.Module):
    """The root module's first ``make_rng("sampling")``, as the JAX model
    draws its detection-target key."""

    @flax_nn.compact
    def __call__(self):
        return self.make_rng("sampling")


def jax_draws(rng, cfg, num_rois):
    """The uniform draws JAX's train step makes from ``rng``
    (``train/train_step.py:86-110``, ``models/mask_rcnn.py:188``,
    ``ops/targets.py:52``)."""
    rng_sample, rng_rpn, _ = jax.random.split(rng, 3)
    sampling = _SamplingKey().apply({}, rngs={"sampling": rng_sample})
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "det_pos", "det_neg")}
    for kind, keys, n in (("rpn", jax.random.split(rng_rpn, B), cfg.num_anchors()),
                          ("det", jax.random.split(sampling, B), num_rois)):
        for key in keys:
            kp, kn = jax.random.split(key)
            out[f"{kind}_pos"].append(np.asarray(jax.random.uniform(kp, (n,))))
            out[f"{kind}_neg"].append(np.asarray(jax.random.uniform(kn, (n,))))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


@functools.lru_cache(maxsize=1)
def jax_variables():
    # initialised without the switches: under tune_rpn_model_only flax would create no head parameters
    state = jax_create_train_state(JaxConfig(**BASE), jax.random.PRNGKey(0))
    variables = randomize({"params": state.params, "batch_stats": state.batch_stats}, np.random.RandomState(1))
    # smaller RPN class weights spread the scores: saturated scores would tie in the top-k
    rpn_class = variables["params"]["rpn"]["rpn_class_raw"]
    rpn_class["kernel"] = rpn_class["kernel"] * np.float32(0.1)
    return variables


def setup_pair(**over):
    jcfg = JaxConfig(**BASE, **over)
    variables = jax_variables()
    batch = make_batch(with_rois=not jcfg.use_rpn_rois)
    rng = jax.random.PRNGKey(7)
    cfg = MaskRCNNConfig(**BASE, **over)
    num_rois = batch["input_rois"].shape[1] if "input_rois" in batch else cfg.post_nms_rois_training
    draws = jax_draws(rng, jcfg, num_rois)
    return jcfg, cfg, variables, batch, rng, draws


def port_state(cfg, variables):
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state.model.load_state_dict(flax_to_state_dict(variables, state.model))
    return state


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_loss_fn(jcfg):
    anchors = jnp.asarray(jax_get_anchors(jcfg))
    return lambda p, bs, batch, rng: _loss_and_updates(p, bs, batch, rng, jcfg, anchors)


def rel(a, b):
    a = a.detach() if torch.is_tensor(a) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def step_pair():
    jcfg, cfg, variables, batch, rng, draws = setup_pair()
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (total, (losses, new_stats)), grads = vg(variables["params"], variables["batch_stats"], batch, rng)
    tx = jax_build_optimizer(jcfg)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new_params = jax.tree.map(lambda p, u: p + u, variables["params"], updates)
    ref = dict(total=total, losses=losses, grads=grads, params=new_params, stats=new_stats)
    return jcfg, cfg, variables, batch, draws, jax.tree.map(np.asarray, ref)


def test_whole_step_losses_and_gradients_match_jax(step_pair):
    _, cfg, variables, batch, draws, ref = step_pair
    model = port_state(cfg, variables).model
    total, losses = _loss(model, torch_batch(batch), draws, cfg)
    assert float(ref["losses"]["mrcnn_mask_loss"]) > 0, "no positive ROI: the head losses are untested"
    assert set(losses) == set(ref["losses"])
    for k, v in losses.items():
        assert rel(v, ref["losses"][k]) <= 1e-5, k
    assert rel(total, ref["total"]) <= 1e-5
    params = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in params], allow_unused=True)
    want = flax_to_state_dict({"params": ref["grads"]}, model, params_only=True)
    gmax = max(float(w.abs().max()) for w in want.values())
    for (name, _), g in zip(params, grads):
        w = want[name].numpy()
        assert g is not None, name  # every parameter is on the loss's path
        assert np.abs(g.numpy() - w).max() <= 1e-4 * (np.abs(w).max() + gmax), name


def test_gradients_match_jax_on_running_averages():
    over = dict(train_bn=False, train_bn_backbone=False)
    jcfg, cfg, variables, batch, rng, draws = setup_pair(**over)
    vg = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg), has_aux=True))
    (total, (ref, _)), jgrads = vg(variables["params"], variables["batch_stats"], batch, rng)
    model = port_state(cfg, variables).model
    ours, losses = _loss(model, torch_batch(batch), draws, cfg)
    assert float(ref["mrcnn_mask_loss"]) > 0
    for k, v in ref.items():
        assert rel(losses[k], v) <= 1e-5, k
    params = list(model.named_parameters())
    grads = torch.autograd.grad(ours, [p for _, p in params])
    want = flax_to_state_dict({"params": jax.tree.map(np.asarray, jgrads)}, model, params_only=True)
    for (name, _), g in zip(params, grads):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_whole_step_update_and_batch_stats_match_jax(step_pair):
    jcfg, cfg, variables, batch, draws, ref = step_pair
    state = port_state(cfg, variables)
    state, losses = make_train_step(cfg)(state, torch_batch(batch), draws=draws)
    assert state.step == 1 and float(losses["grad_finite"]) == 1.0
    lr = jcfg.learning_rate
    sd = state.model.state_dict()
    want = flax_to_state_dict({"params": ref["params"], "batch_stats": ref["stats"]}, state.model)
    grads = flax_to_state_dict({"params": ref["grads"]}, state.model, params_only=True)
    moved = 0
    for name, _ in state.model.named_parameters():
        got, w, g = sd[name].numpy(), want[name].numpy(), grads[name].numpy()
        err = np.abs(got - w)
        assert err.max() <= 2 * lr, name
        assert np.all(err[np.abs(g) >= 1e-4] <= 1e-3 * lr), name
        moved += int((np.abs(g) >= 1e-4).sum())
    assert moved > 1000
    for name, value in sd.items():
        if name.endswith(("running_mean", "running_var")):
            w = want[name].numpy()
            assert np.abs(value.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


@pytest.mark.parametrize("switch", [dict(tune_rpn_model_only=True), dict(use_rpn_rois=False, random_rois=32)])
def test_training_mode_switches_match_jax(switch):
    jcfg, cfg, variables, batch, rng, draws = setup_pair(**switch)
    _, (ref, _) = jax.jit(jax_loss_fn(jcfg))(variables["params"], variables["batch_stats"], batch, rng)
    state = port_state(cfg, variables)
    state, losses = make_train_step(cfg)(state, torch_batch(batch), draws=draws)
    assert set(losses) == set(ref) | {"grad_finite"}
    if cfg.tune_rpn_model_only:
        assert "mrcnn_class_loss" not in losses
    else:
        assert "rpn_class_loss" not in losses and float(ref["mrcnn_mask_loss"]) > 0
    for k, v in ref.items():
        assert rel(losses[k], v) <= 1e-5, k


def test_nonfinite_guard_keeps_the_old_state():
    _, cfg, variables, batch, _, draws = setup_pair()
    state = port_state(cfg, variables)
    step = make_train_step(cfg)
    state, _ = step(state, torch_batch(batch), draws=draws)  # a real step: the optimizer state is not fresh
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_before = state.opt_state
    bad = torch_batch(batch)
    bad["images"][0, 5, 5, 0] = float("nan")
    state, losses = step(state, bad, draws=draws)
    assert float(losses["grad_finite"]) == 0.0 and not np.isfinite(float(losses["loss_sum"]))
    assert state.step == 2
    assert state.opt_state is opt_before
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_eval_step_and_frozen_modules():
    """The eval step's losses are the training losses without L2 and leave
    the statistics alone; a frozen backbone gets zero gradients, so its
    optimizer state advances as optax's does."""
    _, cfg, variables, batch, _, draws = setup_pair()
    state = port_state(cfg, variables)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = make_eval_step(cfg)(state, torch_batch(batch), draws=draws)
    assert "l2_loss" not in losses
    _, train_losses = _loss(port_state(cfg, variables).model, torch_batch(batch), draws, cfg)
    for k, v in losses.items():
        assert float(v) == float(train_losses[k].detach()), k
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())

    frozen = cfg.replace(frozen_backbone=True)
    state = port_state(frozen, variables)
    stem = state.model.backbone.stem.conv.weight
    w0 = stem.detach().clone()
    state, losses = make_train_step(frozen)(state, torch_batch(batch), draws=draws)
    idx = [i for i, p in enumerate(state.model.parameters()) if p is stem][0]
    assert torch.equal(state.opt_state.slots["mu"][idx], torch.zeros_like(w0))
    assert torch.all(state.opt_state.slots["nu"][idx] == 1e-8)  # max(|0| + eps, b2 * 0)
    assert state.opt_state.count == 1
    assert not torch.equal(state.model.classifier.mrcnn_class_logits.weight, before["classifier.mrcnn_class_logits.weight"])


@pytest.mark.parametrize("include_bn,skip", [(False, ()), (True, ()), (False, ("backbone", "mask_head"))])
def test_l2_reg_loss_matches_jax(include_bn, skip):
    """One mean of squares per leaf, batch norms and biases skipped unless
    asked, frozen top-level modules skipped: within 1e-6 relative."""
    variables = jax_variables()
    ref = jax_l2_reg_loss(variables["params"], 2e-4, include_bn, skip_prefixes=skip,
                          bn_module_paths=jax_batchnorm_module_paths(variables["batch_stats"]))
    model = port_state(MaskRCNNConfig(**BASE), variables).model
    assert rel(l2_reg_loss(model, 2e-4, include_bn, skip), ref) <= 1e-6
