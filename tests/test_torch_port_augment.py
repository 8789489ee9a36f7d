"""The port's device augmentation against the JAX package's, on the CPU.

The port takes its draws as uniforms in [0, 1) (``ops.targets.draw_uniforms``);
the tests hand it the uniforms JAX draws from its own keys
(``train/train_step.py:86``, ``ops/augment.py:71-90``: ``bernoulli(k, 0.5)``
is ``uniform(k) < 0.5``, ``uniform(k, lo, hi)`` is ``max(lo, u * (hi - lo) +
lo)``). Tolerances: the flip exact; the zoom-out and the photometric jitter
within 1e-4 * 255 on the raw 0..255 image (the contractions sum in another
order), boxes within 1e-6. One training step with ``augment_on_device``
against JAX's at the whole-step tolerances of
``tests/test_torch_port_train_step.py`` on the batch norms' running
averages: each loss within 1e-5 relative, each gradient leaf within 1e-4 of
its own max.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.ops.anchors import get_anchors as jax_get_anchors
from maskrcnn_tf2_tpu.ops.augment import device_augment as jax_device_augment
from maskrcnn_tf2_tpu.train.train_step import _loss_and_updates

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.ops.augment import device_augment
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms
from maskrcnn_tf2_tpu_torch.train.train_step import _loss, make_eval_step
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from test_torch_port_train_step import BASE, jax_draws, jax_variables, make_batch, port_state, rel, torch_batch

AUG = dict(augment_on_device=True, augment_flip=True, augment_scale_jitter=0.25, augment_photometric=0.2)
# the step's scene on the batch norms' running averages: the zoom and the
# jitter leave the images within 2 float32 ulps of JAX's, and under batch
# statistics such a perturbation moves some losses by 1e-5 at random weights
# (tests/torch_port_conditioning.py); on running averages it does not
RUNNING = dict(train_bn=False, train_bn_backbone=False)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores, and more threads per process only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_aug_draws(aug_key, b):
    """The unit uniforms behind ``device_augment``'s draws from ``aug_key``."""
    keys = jax.random.split(aug_key, 4)
    shapes = [(b,), (b,), (b, 1, 1, 1), (b, 1, 1, 1)]
    names = ["aug_flip", "aug_scale", "aug_bright", "aug_contrast"]
    return {n: torch.from_numpy(np.asarray(jax.random.uniform(k, s)).reshape(b)) for n, k, s in zip(names, keys, shapes)}


def aug_batch(b=3, h=48, w=40, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    y1, x1 = rs.uniform(0, 0.5, (2, b, 4))
    boxes = np.stack([y1, x1, y1 + 0.3, x1 + 0.4], -1).astype(np.float32)
    ids = rs.randint(0, 3, (b, 4)).astype(np.int32)
    boxes[ids == 0] = 0.0
    masks = (rs.uniform(size=(b, 4, 14, 14)) > 0.5).astype(np.uint8)
    return {"images": images, "gt_class_ids": ids, "gt_boxes": boxes, "gt_masks": masks}


@pytest.mark.parametrize("flip,scale_jitter,photometric", [(True, 0.0, 0.0), (False, 0.25, 0.0),
                                                           (False, 0.0, 0.2), (True, 0.3, 0.15)])
def test_device_augment_matches_jax(flip, scale_jitter, photometric):
    b = 6
    batch = aug_batch(b)
    key = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v, jnp.float32 if k in ("images", "gt_masks") else None) for k, v in batch.items()}
    want = jax.jit(lambda bt, k: jax_device_augment(bt, k, flip=flip, scale_jitter=scale_jitter,
                                                    photometric=photometric))(jbatch, key)
    draws = jax_aug_draws(key, b)
    flips = (draws["aug_flip"] < 0.5).tolist()
    assert any(flips) and not all(flips)
    got = device_augment({k: torch.from_numpy(v) for k, v in batch.items()}, draws, flip=flip,
                         scale_jitter=scale_jitter, photometric=photometric)
    assert got["images"].dtype == torch.float32
    img, ref = got["images"].numpy(), np.asarray(want["images"])
    if scale_jitter == 0.0 and photometric == 0.0:
        np.testing.assert_array_equal(img, ref)
    else:
        assert np.abs(img - ref).max() <= 1e-4 * 255
        assert np.abs(img - batch["images"]).max() > 1.0  # the jitter did something
    np.testing.assert_allclose(got["gt_boxes"].numpy(), np.asarray(want["gt_boxes"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["gt_masks"].numpy(), np.asarray(want["gt_masks"]))


def test_draw_uniforms_adds_the_augment_draws():
    cfg = MaskRCNNConfig(**BASE)
    plain = draw_uniforms(cfg, 2, torch.Generator().manual_seed(1), "cpu")
    aug = draw_uniforms(cfg.replace(**AUG), 2, torch.Generator().manual_seed(1), "cpu")
    assert set(aug) - set(plain) == {"aug_flip", "aug_scale", "aug_bright", "aug_contrast"}
    assert all(torch.equal(plain[k], aug[k]) for k in plain)  # drawn after the others
    assert all(aug[k].shape == (2,) for k in aug if k.startswith("aug_"))


@pytest.fixture(scope="module")
def aug_step_pair():
    jcfg, cfg = JaxConfig(**BASE, **AUG, **RUNNING), MaskRCNNConfig(**BASE, **AUG, **RUNNING)
    variables = jax_variables()
    batch = make_batch()
    batch["images"] = batch["images"].astype(np.uint8).astype(np.float32)  # whole grey levels, as the loader's
    batch["gt_class_ids"] = np.minimum(batch["gt_class_ids"], 2)  # classes 1..num_classes-1 only
    rng = jax.random.PRNGKey(8)
    draws = dict(jax_draws(rng, jcfg, cfg.post_nms_rois_training), **jax_aug_draws(jax.random.split(rng, 3)[2], 2))
    anchors = jnp.asarray(jax_get_anchors(jcfg))
    loss = lambda p, bs, bt, r: _loss_and_updates(p, bs, bt, r, jcfg, anchors, augment=True)  # noqa: E731
    (total, (losses, _)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables["batch_stats"], batch, rng)
    return cfg, variables, batch, draws, jax.tree.map(np.asarray, dict(total=total, losses=losses, grads=grads))


def test_augmented_step_matches_jax(aug_step_pair):
    cfg, variables, batch, draws, ref = aug_step_pair
    assert (draws["aug_flip"] < 0.5).tolist() == [False, True]  # one image flipped, one not
    model = port_state(cfg, variables).model
    tb = torch_batch(batch)
    tb["images"] = tb["images"].to(torch.uint8)  # the loader's dtype; the step casts on the device
    total, losses = _loss(model, tb, draws, cfg, augment=True)
    assert float(ref["losses"]["mrcnn_mask_loss"]) > 0
    for k, v in losses.items():
        assert rel(v, ref["losses"][k]) <= 1e-5, k
    assert rel(total, ref["total"]) <= 1e-5
    params = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in params])
    want = flax_to_state_dict({"params": ref["grads"]}, model, params_only=True)
    for (name, _), g in zip(params, grads):
        w = want[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name
    # the eval step never augments: its losses are those of the plain batch
    plain_losses = _loss(port_state(cfg, variables).model, tb, draws, cfg)[1]
    eval_losses = make_eval_step(cfg)(port_state(cfg, variables), tb, draws=draws)
    assert all(float(eval_losses[k]) == float(plain_losses[k]) for k in eval_losses)
    assert float(eval_losses["loss_sum"]) != float(losses["loss_sum"])
