"""The PyTorch port's training ops against the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages. The samplers get the
uniform draws JAX itself makes from its keys, so targets compare index for
index. Tolerances: match, ROIs and class ids identical; deltas, crops,
boxes <= 1e-6 (the same float32 operations); mask targets identical except
where JAX's unrounded value lies within 1e-6 of 0.5; losses and the L2 term
<= 1e-6 relative (sums in another order); the ROIAlign backward's plain
version <= 1e-4 absolute against ``jax.grad`` of the gather form and the
Pallas VJP in interpret mode (the JAX package's own tolerance,
``tests/test_pallas_interpret.py``); every optimizer of the zoo <= 1e-6 of
max |param| after 3 steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tf2_tpu import losses as jax_losses
from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.kernels.roi_align_pallas import pyramid_roi_align_pallas
from maskrcnn_tf2_tpu.ops import boxes as jax_boxes
from maskrcnn_tf2_tpu.ops import image as jax_image
from maskrcnn_tf2_tpu.ops import targets as jax_targets
from maskrcnn_tf2_tpu.ops.roi_align import pyramid_roi_align_gather
from maskrcnn_tf2_tpu.train.optimizer import build_optimizer as jax_build_optimizer

from maskrcnn_tf2_tpu_torch import losses as port_losses
from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.kernels.roi_align import roi_align_backward, roi_align_backward_plain
from maskrcnn_tf2_tpu_torch.ops import boxes as port_boxes
from maskrcnn_tf2_tpu_torch.ops import image as port_image
from maskrcnn_tf2_tpu_torch.ops import targets as port_targets
from maskrcnn_tf2_tpu_torch.ops.anchors import get_anchors
from maskrcnn_tf2_tpu_torch.ops.roi_align import pyramid_roi_align
from maskrcnn_tf2_tpu_torch.train.optimizer import build_optimizer, set_learning_rate

from torch_port_helpers import pyramid, random_boxes, roi_boxes

T = torch.from_numpy


def rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.max(np.abs(ours - ref), initial=0.0) / max(1e-30, np.max(np.abs(ref), initial=0.0)))


def jax_uniform_pair(key, n):
    """The two draws ``_random_keep_topk`` makes from a target function's key."""
    kp, kn = jax.random.split(key)
    return np.array(jax.random.uniform(kp, (n,))), np.array(jax.random.uniform(kn, (n,)))


def gt_scene(rs, b, g, crowd=True):
    """Zero-padded GT: 3-5 boxes per image, classes 1..3, one crowd box."""
    ids = np.zeros((b, g), np.int32)
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        k = rs.randint(3, 6)
        boxes[i, :k] = random_boxes(rs, k, lo=0.15, hi=0.5)
        ids[i, :k] = rs.randint(1, 4, k)
        if crowd:
            ids[i, k - 1] = -1
    return ids, boxes


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_encode_boxes_matches_jax():
    rs = np.random.RandomState(0)
    a, g = random_boxes(rs, 300), random_boxes(rs, 300)
    a[:3] = 0.0  # padding rows take the 1e-8 guard
    np.testing.assert_allclose(port_boxes.encode_boxes(T(a), T(g)).numpy(),
                               np.asarray(jax_boxes.encode_boxes(a, g)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("crop", [(28, 28), (1, 5)])
def test_crop_and_resize_matches_jax(crop):
    rs = np.random.RandomState(1)
    images = rs.normal(size=(3, 20, 24, 2)).astype(np.float32)
    boxes = rs.uniform(-0.3, 1.3, (40, 4)).astype(np.float32)  # out-of-range points extrapolate 0
    boxes[:20] = random_boxes(rs, 20, lo=0.05, hi=0.6)
    idx = rs.randint(0, 3, 40).astype(np.int32)
    ours = port_image.crop_and_resize(T(images), T(boxes), T(idx), crop).numpy()
    ref = np.asarray(jax_image.crop_and_resize(images, boxes, idx, crop))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    masks = images[..., 0]
    ours = port_image.crop_and_resize_separable(T(masks), T(boxes), T(idx), crop).numpy()
    ref = np.asarray(jax_image.crop_and_resize_separable(masks, boxes, idx, crop))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# samplers, fed JAX's own draws
# ---------------------------------------------------------------------------


def test_rpn_targets_match_jax():
    cfg = MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128))
    anchors = get_anchors(cfg)
    rs = np.random.RandomState(2)
    ids, boxes = gt_scene(rs, 2, 6)
    per_anchor = 6  # 3 positives at most: the second image has 4, so the subsampling runs
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draws = [jax_uniform_pair(k, len(anchors)) for k in keys]
    ours = port_targets.rpn_targets(T(anchors), T(ids), T(boxes), T(np.stack([d[0] for d in draws])),
                                    T(np.stack([d[1] for d in draws])), per_anchor, cfg.rpn_bbox_std_dev)
    for i, key in enumerate(keys):
        ref = jax_targets.rpn_targets(key, anchors, ids[i], boxes[i], per_anchor, cfg.rpn_bbox_std_dev)
        np.testing.assert_array_equal(ours.match[i].numpy(), np.asarray(ref.match))
        np.testing.assert_allclose(ours.deltas[i].numpy(), np.asarray(ref.deltas), rtol=0, atol=1e-6)
    assert (ours.match == 1).sum(1).tolist() == [2, 3]
    assert (ours.match != 0).sum(1).tolist() == [per_anchor, per_anchor]


def jax_unrounded_masks(ref, boxes, ids, masks, mask_shape):
    """JAX's mask targets before ``round``: the mini-mask crop of each slot's
    assigned GT mask (``ops/targets.py:221-258``)."""
    rois = ref.rois
    iou = jax_boxes.overlaps(rois, boxes)
    gt_idx = jnp.argmax(jnp.where((ids > 0)[None], iou, -1.0), axis=1)
    g = jnp.take(jnp.asarray(boxes), gt_idx, axis=0)
    gh, gw = jnp.maximum(g[:, 2] - g[:, 0], 1e-8), jnp.maximum(g[:, 3] - g[:, 1], 1e-8)
    crop = jnp.stack([(rois[:, 0] - g[:, 0]) / gh, (rois[:, 1] - g[:, 1]) / gw,
                      (rois[:, 2] - g[:, 0]) / gh, (rois[:, 3] - g[:, 1]) / gw], axis=1)
    return np.asarray(jax_image.crop_and_resize_separable(masks, crop, gt_idx, mask_shape))


@pytest.mark.parametrize("mini", [True, False])
def test_detection_targets_match_jax(mini):
    rs = np.random.RandomState(4)
    b, p, g, t = 2, 300, 6, 64
    ids, boxes = gt_scene(rs, b, g)
    # proposals around the GT boxes and at random, the last rows zero padding
    jitter = boxes[:, rs.randint(0, 3, p)] + rs.normal(0, 0.04, (b, p, 4)).astype(np.float32)
    proposals = np.where(rs.uniform(size=(b, p, 1)) < 0.5, jitter,
                         np.stack([random_boxes(rs, p) for _ in range(b)]))
    proposals = np.clip(proposals, 0.0, 1.0).astype(np.float32)
    proposals[:, -20:] = 0.0
    size = (56, 56) if mini else (260, 260)  # above 256x256: the four-corner crop_and_resize
    masks = (rs.uniform(size=(b, g) + size) > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    draws = [jax_uniform_pair(k, p) for k in keys]
    kw = dict(train_rois_per_image=t, roi_positive_ratio=0.33, bbox_std=(0.1, 0.1, 0.2, 0.2),
              mask_shape=(28, 28), use_mini_masks=mini)
    ours = port_targets.detection_targets(T(proposals), T(ids), T(boxes), T(masks),
                                          T(np.stack([d[0] for d in draws])),
                                          T(np.stack([d[1] for d in draws])), **kw)
    for i, key in enumerate(keys):
        ref = jax_targets.detection_targets(key, proposals[i], ids[i], boxes[i], masks[i], **kw)
        for name in ("rois", "class_ids", "positive_mask", "valid_mask"):
            np.testing.assert_array_equal(getattr(ours, name)[i].numpy(), np.asarray(getattr(ref, name)), name)
        np.testing.assert_allclose(ours.deltas[i].numpy(), np.asarray(ref.deltas), rtol=0, atol=1e-6)
        differ = ours.masks[i].numpy() != np.asarray(ref.masks)
        if differ.any():
            assert mini, "full-frame masks go through the same gathers: no rounding difference"
            unrounded = jax_unrounded_masks(ref, boxes[i], ids[i], masks[i], (28, 28))
            assert np.all(np.abs(unrounded[differ] - 0.5) <= 1e-6)
        n_pos = int(ours.positive_mask[i].sum())
        assert n_pos == int(t * 0.33), "the positive cap must bind, or the sampler is untested"
        assert int(ours.valid_mask[i].sum()) == int(n_pos / 0.33)


def test_draw_uniforms_seeded_and_shaped():
    cfg = MaskRCNNConfig(image_shape=(64, 64, 3), rpn_anchor_scales=(4, 8, 16, 32, 64),
                         post_nms_rois_training=32)
    a = port_targets.draw_uniforms(cfg, 2, torch.Generator().manual_seed(1), "cpu")
    b = port_targets.draw_uniforms(cfg, 2, torch.Generator().manual_seed(1), "cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "rpn_pos": (2, cfg.num_anchors()), "rpn_neg": (2, cfg.num_anchors()),
        "det_pos": (2, 32), "det_neg": (2, 32)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert port_targets.draw_uniforms(cfg, 1, torch.Generator(), "cpu", num_rois=5)["det_pos"].shape == (1, 5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rs = np.random.RandomState(6)
    b, a, t, c = 2, 500, 24, 5
    logits = rs.normal(size=(b, a, 2)).astype(np.float32)
    match = rs.randint(-1, 2, (b, a)).astype(np.int32)
    pred, tgt = rs.normal(size=(2, b, a, 4)).astype(np.float32) * 2
    cls_logits = rs.normal(size=(b, t, c)).astype(np.float32)
    cls = rs.randint(0, c, (b, t)).astype(np.int32)
    active = np.ones((b, c), np.float32)
    active[1, 2] = 0.0  # a class inactive in the second image's dataset
    deltas = rs.normal(size=(b, t, c, 4)).astype(np.float32)
    tdeltas = rs.normal(size=(b, t, 4)).astype(np.float32)
    masks5 = rs.uniform(size=(b, 10, 6, 6, c)).astype(np.float32)
    masks4 = rs.uniform(size=(b, 10, 6, 6)).astype(np.float32)
    tmasks = (rs.uniform(size=(b, t, 6, 6)) > 0.5).astype(np.float32)
    pairs = [
        (port_losses.rpn_class_loss(T(logits), T(match)), jax_losses.rpn_class_loss(logits, match)),
        (port_losses.rpn_bbox_loss(T(pred), T(tgt), T(match)), jax_losses.rpn_bbox_loss(pred, tgt, match)),
        (port_losses.mrcnn_class_loss(T(cls_logits), T(cls), T(active)),
         jax_losses.mrcnn_class_loss(cls_logits, cls, active)),
        (port_losses.mrcnn_bbox_loss(T(deltas), T(tdeltas), T(cls)),
         jax_losses.mrcnn_bbox_loss(deltas, tdeltas, cls)),
        (port_losses.mrcnn_mask_loss(T(masks5), T(tmasks), T(cls)), jax_losses.mrcnn_mask_loss(masks5, tmasks, cls)),
        (port_losses.mrcnn_mask_loss(T(masks4), T(tmasks), T(cls)), jax_losses.mrcnn_mask_loss(masks4, tmasks, cls)),
    ]
    for i, (ours, ref) in enumerate(pairs):
        assert float(ref) > 0
        assert rel(float(ours), float(ref)) <= 1e-6, i
    # an empty selection gives 0, not NaN
    zero = np.zeros((b, a), np.int32)
    assert float(port_losses.rpn_bbox_loss(T(pred), T(tgt), T(zero))) == 0.0


# ---------------------------------------------------------------------------
# the ROIAlign backward's plain version
# ---------------------------------------------------------------------------


def test_roi_align_backward_plain_matches_jax_grad_of_gather():
    rs = np.random.RandomState(7)
    feats = pyramid(rs, 2, 128, 8)
    boxes = roi_boxes(rs, 2, 40)  # full-image, zero-area, padding, slivers, a far-corner box
    cot = rs.normal(size=(2, 40, 7, 7, 8)).astype(np.float32)
    ref = jax.grad(lambda fs: jnp.sum(pyramid_roi_align_gather(fs, boxes, 7, (128, 128)) * cot))(
        [jnp.asarray(f) for f in feats])
    ours = roi_align_backward_plain(T(cot), T(boxes), [f.shape[1:3] for f in feats], (128, 128))
    for lvl, (o, r) in enumerate(zip(ours, ref)):
        assert o.dtype == torch.float32 and tuple(o.shape) == feats[lvl].shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4, err_msg=f"level {lvl}")
    # zero-area and padding ROIs leave the maps untouched
    only_empty = np.zeros_like(cot)
    only_empty[:, 1:3] = cot[:, 1:3]
    untouched = roi_align_backward_plain(T(only_empty), T(boxes), [f.shape[1:3] for f in feats], (128, 128))
    assert all(float(g.abs().max()) == 0.0 for g in untouched)


def test_roi_align_backward_plain_matches_pallas_vjp():
    """The 8-ROI case of ``test_pallas_interpret.py``, with a padding ROI and
    a strip-mode sliver, against the custom VJP (K4) in interpret mode."""
    rs = np.random.RandomState(5)
    b, n = 1, 8
    feats = [rs.randn(b, s, s, 8).astype(np.float32) for s in (64, 32, 16, 8)]
    y1, x1 = rs.uniform(0, 0.6, (2, b, n))
    scale = np.exp(rs.uniform(np.log(0.05), np.log(0.6), (b, n)))
    aspect = np.exp(rs.normal(0, 0.8, (b, n)))
    h, w = np.minimum(scale * aspect, 0.9), np.minimum(scale / aspect, 0.9)
    boxes = np.stack([y1, x1, np.minimum(y1 + h, 1.0), np.minimum(x1 + w, 1.0)], -1).astype(np.float32)
    boxes[0, 0] = 0.0
    boxes[0, 1] = [0.0, 0.4, 1.0, 0.43]
    cot = rs.randn(b, n, 7, 7, 8).astype(np.float32)
    gf, gb = jax.grad(
        lambda fs, bx: jnp.sum(pyramid_roi_align_pallas(fs, bx, 7, (256, 256), interpret=True) * cot),
        argnums=(0, 1),
    )([jnp.asarray(f) for f in feats], jnp.asarray(boxes))
    assert float(jnp.abs(gb).max()) == 0.0
    ours = roi_align_backward_plain(T(cot), T(boxes), [f.shape[1:3] for f in feats], (256, 256))
    for lvl, (o, r) in enumerate(zip(ours, gf)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4, err_msg=f"level {lvl}")


def test_pyramid_roi_align_autograd_function():
    """The autograd Function: the maps' gradient is the backward wrapper's
    (plain on the CPU, in the maps' dtype), the boxes get none, and no kernel
    launches for CPU tensors."""
    rs = np.random.RandomState(8)
    feats = [T(f).requires_grad_() for f in pyramid(rs, 2, 64, 4)]
    boxes = T(roi_boxes(rs, 2, 12)).requires_grad_()
    cot = T(rs.normal(size=(2, 12, 14, 14, 4)).astype(np.float32))
    before = roi_align_backward.launches
    out = pyramid_roi_align(feats, boxes, 14, (64, 64))
    grads = torch.autograd.grad((out * cot).sum(), feats + [boxes], allow_unused=True)
    assert grads[-1] is None
    want = roi_align_backward_plain(cot, boxes.detach(), [tuple(f.shape[1:3]) for f in feats], (64, 64))
    for g, w in zip(grads[:-1], want):
        assert torch.equal(g, w)
    bf = [f.detach().to(torch.bfloat16).requires_grad_() for f in feats]
    gb = torch.autograd.grad((pyramid_roi_align(bf, boxes, 14, (64, 64)).float() * cot).sum(), bf)
    assert all(g.dtype == torch.bfloat16 for g in gb)
    assert roi_align_backward.launches == before


# ---------------------------------------------------------------------------
# the optimizer zoo against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["adam", "adamax", "adadelta", "adagrad", "sgd", "rmsprop", "ftrl"])
def test_optimizer_matches_optax(name):
    rs = np.random.RandomState(9)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rs.normal(size=s).astype(np.float32) for s in shapes]
    kw = dict(optimizer=name, learning_rate=0.05, clipvalue=1.5, clipnorm=4.0)
    jtx = jax_build_optimizer(JaxConfig(**kw))
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = jtx.init(jparams)
    opt = build_optimizer(MaskRCNNConfig(**kw))
    tparams = [T(p.copy()) for p in params]
    tstate = opt.init(tparams)
    for step in range(3):
        grads = [rs.normal(size=s).astype(np.float32) * 2 for s in shapes]  # some clip by value
        if step == 2:  # optax's injected learning rate, as train/optimizer.py::set_learning_rate sets it
            jstate.hyperparams["learning_rate"] = jnp.asarray(0.02, jnp.float32)
            tstate = set_learning_rate(tstate, 0.02)
        updates, jstate = jtx.update({str(i): jnp.asarray(g) for i, g in enumerate(grads)}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tupdates, tstate = opt.update([T(g) for g in grads], tstate, tparams)
        tparams = [p + u for p, u in zip(tparams, tupdates)]
    assert tstate.count == 3
    for i, p in enumerate(tparams):
        ref = np.asarray(jparams[str(i)])
        assert float(np.abs(p.numpy() - ref).max()) <= 1e-6 * float(np.abs(ref).max()), (name, i)
        assert float(np.abs(ref - params[i]).max()) > 1e-5  # the parameters moved
