"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``maskrcnn_tf2_tpu_torch``. Tolerances: anchors exact; box
and image ops <= 1e-6 (same float32 operation order); NMS identical
``(indices, valid)``; ROIAlign <= 1e-5 absolute in float32 (the four
weighted corners are summed in another order). The kernels themselves are held
against these plain versions in ``test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maskrcnn_tf2_tpu import config as jax_config
from maskrcnn_tf2_tpu.kernels.nms_pallas import greedy_keep_pallas
from maskrcnn_tf2_tpu.ops import anchors as jax_anchors
from maskrcnn_tf2_tpu.ops import boxes as jax_boxes
from maskrcnn_tf2_tpu.ops import image as jax_image
from maskrcnn_tf2_tpu.ops.detection import refine_detections as jax_refine
from maskrcnn_tf2_tpu.ops.nms import non_max_suppression as jax_nms
from maskrcnn_tf2_tpu.ops.proposal import generate_proposals as jax_proposals
from maskrcnn_tf2_tpu.ops.roi_align import pyramid_roi_align_gather
from maskrcnn_tf2_tpu.ops.roi_align import roi_level_assignment as jax_levels

from maskrcnn_tf2_tpu_torch import config as port_config
from maskrcnn_tf2_tpu_torch.kernels import nms as port_nms_kernel
from maskrcnn_tf2_tpu_torch.ops import anchors as port_anchors
from maskrcnn_tf2_tpu_torch.ops import boxes as port_boxes
from maskrcnn_tf2_tpu_torch.ops import image as port_image
from maskrcnn_tf2_tpu_torch.ops.detection import refine_detections as port_refine
from maskrcnn_tf2_tpu_torch.ops.nms import non_max_suppression as port_nms
from maskrcnn_tf2_tpu_torch.ops.proposal import generate_proposals as port_proposals
from maskrcnn_tf2_tpu_torch.ops.roi_align import pyramid_roi_align as port_roi_align
from maskrcnn_tf2_tpu_torch.ops.roi_align import roi_level_assignment as port_levels

from torch_port_helpers import nms_case, pyramid, random_boxes, roi_boxes

T = torch.from_numpy


# ---------------------------------------------------------------------------
# config, anchors, box and image ops
# ---------------------------------------------------------------------------


def test_config_copy_matches_jax_config():
    d = dict(image_shape=[256, 256, 3], num_classes=5, backbone="resnet50",
             pre_nms_limit=1000, post_nms_rois_inference=300, compute_dtype="float32")
    j = jax_config.MaskRCNNConfig.from_dict(d)
    p = port_config.MaskRCNNConfig.from_dict(d)
    assert p.to_dict() == j.to_dict()
    assert port_config.MaskRCNNConfig().to_dict() == jax_config.MaskRCNNConfig().to_dict()
    assert p.post_nms_rois(False) == j.post_nms_rois(False) == 300
    assert p.num_anchors() == j.num_anchors() and p.meta_size == j.meta_size


@pytest.mark.parametrize("shape", [(128, 128, 3), (512, 512, 3), (200, 300, 3)])
def test_anchors_exact(shape):
    j = jax_config.MaskRCNNConfig(image_shape=shape)
    p = port_config.MaskRCNNConfig(image_shape=shape)
    np.testing.assert_array_equal(port_anchors.get_anchors(p), jax_anchors.get_anchors(j))


def test_box_ops_match():
    rs = np.random.RandomState(0)
    boxes = random_boxes(rs, 500)
    deltas = rs.normal(0, 0.5, (500, 4)).astype(np.float32)
    window = np.array([0.1, 0.05, 0.9, 0.95], np.float32)
    windows = rs.uniform(0, 1, (500, 1, 4)).astype(np.float32)
    b2 = random_boxes(rs, 300)
    b2[:10, 2] = b2[:10, 0]  # zero-area boxes
    pairs = [
        (port_boxes.apply_box_deltas(T(boxes), T(deltas)), jax_boxes.apply_box_deltas(boxes, deltas)),
        (port_boxes.clip_boxes(T(boxes), window), jax_boxes.clip_boxes(boxes, window)),
        (port_boxes.clip_boxes(T(boxes)[:, None], T(windows)), jax_boxes.clip_boxes(boxes[:, None], windows)),
        (port_boxes.box_area(T(b2)), jax_boxes.box_area(b2)),
        (port_boxes.overlaps(T(boxes), T(b2)), jax_boxes.overlaps(boxes, b2)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_image_ops_match():
    rs = np.random.RandomState(1)
    meta = port_image.compose_image_meta(3, (480, 640, 3), (512, 512, 3), (64, 0, 448, 512), 0.8, np.ones(5))
    np.testing.assert_array_equal(
        meta, jax_image.compose_image_meta(3, (480, 640, 3), (512, 512, 3), (64, 0, 448, 512), 0.8, np.ones(5))
    )
    metas = np.stack([meta, meta * 0.5])
    ours = port_image.parse_image_meta(T(metas))
    ref = jax_image.parse_image_meta(jnp.asarray(metas))
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    win = ours["window"]
    np.testing.assert_allclose(
        port_image.norm_window(win, (512, 512)).numpy(),
        np.asarray(jax_image.norm_window(jnp.asarray(win.numpy()), (512, 512))), atol=1e-6)
    img = rs.randint(0, 256, (2, 16, 20, 3)).astype(np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(
        port_image.normalize_image(T(img), mean, std).numpy(),
        np.asarray(jax_image.normalize_image(img, mean, std)), atol=1e-6)
    np.testing.assert_allclose(
        port_image.maxmin_normalize_image(T(img)).numpy(),
        np.asarray(jax_image.maxmin_normalize_image(img)), atol=1e-6)


# ---------------------------------------------------------------------------
# NMS: the plain version of kernel K1 against the JAX package's XLA path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case", ["presorted_6000", "unsorted_class_offsets", "duplicate_chains", "all_invalid_row", "fewer_than_limit"]
)
def test_nms_plain_matches_jax(case):
    boxes, scores, valid, limit, thr, presorted = nms_case(case, np.random.RandomState(7))
    idx, ok = port_nms(T(boxes), T(scores), limit, thr,
                       None if valid is None else T(valid), presorted=presorted)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool
    assert idx.shape == ok.shape == (boxes.shape[0], limit)
    for b in range(boxes.shape[0]):
        ref_idx, ref_ok = jax_nms(boxes[b], scores[b], limit, thr,
                                  None if valid is None else valid[b], presorted=presorted)
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(ref_ok), err_msg=case)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ref_idx), err_msg=case)
    if case == "all_invalid_row":
        assert not ok[1].any()
    if case == "duplicate_chains":  # chains inside and across tiles really suppress
        assert 0 < ok.sum() < valid.sum()


def test_nms_single_image_form():
    rs = np.random.RandomState(3)
    boxes, scores = random_boxes(rs, 300), rs.uniform(size=300).astype(np.float32)
    idx, ok = port_nms(T(boxes), T(scores), 50, 0.5)
    ref_idx, ref_ok = jax_nms(boxes, scores, 50, 0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))


def test_nms_plain_matches_pallas_interpret():
    rs = np.random.RandomState(11)
    n, limit = 1024, 200
    boxes = random_boxes(rs, n)
    valid = rs.uniform(size=n) > 0.05
    keep = np.asarray(greedy_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.5,
                                         interpret=True, limit=limit))
    want = np.flatnonzero(keep)[:limit]
    pos, ok = port_nms_kernel.greedy_nms(T(boxes)[None], T(valid)[None], 0.5, limit)
    np.testing.assert_array_equal(pos[0][ok[0]].numpy(), want)


# ---------------------------------------------------------------------------
# ROIAlign: the plain version of kernels K2/K3 against the gather reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool,n", [(7, 300), (14, 100)])
def test_roi_align_plain_matches_gather(pool, n):
    rs = np.random.RandomState(pool)
    feats = pyramid(rs, 2, 128, 8)
    boxes = roi_boxes(rs, 2, n)
    ours = port_roi_align([T(f) for f in feats], T(boxes), pool, (128, 128, 3)).numpy()
    ref = np.asarray(pyramid_roi_align_gather([jnp.asarray(f) for f in feats], boxes, pool, (128, 128)))
    assert ours.shape == (2, n, pool, pool, 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert not ours[:, 1:3].any()  # zero-area and padding ROIs pool zeros


def test_roi_level_assignment_exact():
    rs = np.random.RandomState(5)
    boxes = roi_boxes(rs, 3, 400)
    for area in (128.0 * 128.0, 512.0 * 512.0):
        np.testing.assert_array_equal(
            port_levels(T(boxes), area).numpy(), np.asarray(jax_levels(jnp.asarray(boxes), area)))


# ---------------------------------------------------------------------------
# proposals and detection refinement
# ---------------------------------------------------------------------------


def test_generate_proposals_matches():
    rs = np.random.RandomState(2)
    cfg = jax_config.MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128))
    anchors = jax_anchors.get_anchors(cfg)
    a = anchors.shape[0]
    logits = rs.normal(0, 2, (2, a, 2)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = rs.normal(0, 1, (2, a, 4)).astype(np.float32)
    std = (0.1, 0.1, 0.2, 0.2)
    ours = port_proposals(T(probs), T(deltas), T(anchors), std, 800, 200, 0.7)
    ref = jax_proposals(probs, deltas, anchors, std, 800, 200, 0.7, False)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)


def test_refine_detections_matches():
    rs = np.random.RandomState(4)
    b, n, c = 2, 300, 6
    rois = np.stack([random_boxes(rs, n) for _ in range(b)])
    rois[:, -20:] = 0.0  # padding ROIs
    logits = rs.normal(0, 2, (b, n, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = rs.normal(0, 1, (b, n, c, 4)).astype(np.float32)
    windows = np.array([[0.0, 0.0, 1.0, 1.0], [0.1, 0.0, 0.9, 1.0]], np.float32)
    for min_conf in (0.0, 0.5):
        ours = port_refine(T(rois), T(probs), T(deltas), T(windows), min_confidence=min_conf,
                           nms_threshold=0.3, max_instances=50).numpy()
        ref = np.asarray(jax_refine(rois, probs, deltas, windows, min_confidence=min_conf,
                                    nms_threshold=0.3, max_instances=50))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        assert (ours[..., 4] > 0).any()
