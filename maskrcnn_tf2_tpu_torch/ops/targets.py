"""Training targets on the device, batched over images (counterpart of
``maskrcnn_tf2_tpu/ops/targets.py``).

``rpn_targets`` matches anchors to GT boxes and subsamples them;
``detection_targets`` samples proposals into the ROI heads' training slots
(positives packed first) with box deltas and mask targets. Both take their
uniform draws as tensors, one ``[B, N]`` per subsampling, where the JAX
package draws ``jax.random.uniform(key, (N,))`` inside: ``draw_uniforms``
makes all of a step's draws from one ``torch.Generator``, and a test can hand
in the draws JAX made and compare index for index. Subsampling keeps the
candidates whose draws are the ``k`` smallest, by the JAX package's ``top_k``
threshold form.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from maskrcnn_tf2_tpu_torch.ops.boxes import encode_boxes, overlaps
from maskrcnn_tf2_tpu_torch.ops.image import crop_and_resize, crop_and_resize_separable

_BIG = 1e9


def draw_uniforms(config, batch_size: int, generator: torch.Generator, device,
                  num_rois: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every uniform draw of one training step, on the CPU from ``generator``
    and then moved to ``device``, so one seed gives the same draws on every
    device. ``num_rois`` is the ROI count per image handed to
    ``detection_targets`` (the proposal count unless ``use_rpn_rois=False``).
    With ``augment_on_device`` the step's ``ops.augment.device_augment``
    draws come after the others: ``aug_flip``, ``aug_scale``, ``aug_bright``
    and ``aug_contrast``, one per image."""
    a = config.num_anchors()
    p = config.post_nms_rois(True) if num_rois is None else num_rois

    def u(*shape):
        return torch.rand((batch_size, *shape), generator=generator, dtype=torch.float32).to(device)

    draws = {"rpn_pos": u(a), "rpn_neg": u(a), "det_pos": u(p), "det_neg": u(p)}
    if config.augment_on_device:
        draws.update({k: u() for k in ("aug_flip", "aug_scale", "aug_bright", "aug_contrast")})
    return draws


def _random_keep_topk(draws: torch.Tensor, candidate: torch.Tensor, k, k_bound: Optional[int] = None) -> torch.Tensor:
    """Keep at most ``k`` True entries per row of ``candidate [B, N]``: those
    with the smallest ``draws``. ``k`` is an int or a ``[B]`` tensor;
    ``k_bound`` a static bound on it."""
    b, n = candidate.shape
    k = torch.as_tensor(k, device=candidate.device).expand(b)
    keys = torch.where(candidate, draws, _BIG)
    if k_bound is not None and k_bound < n:
        kb = int(k_bound)
        smallest = torch.topk(keys, kb, dim=1, largest=False, sorted=True).values  # [B, kb] ascending
        thresh = torch.gather(smallest, 1, torch.clamp(k - 1, 0, kb - 1).long()[:, None])
        return candidate & (keys <= thresh) & (k > 0)[:, None]
    order = torch.argsort(keys, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(n, device=order.device).expand(b, n))
    return candidate & (rank < k[:, None])


class RPNTargets(NamedTuple):
    match: torch.Tensor  # [B, A] int32: 1 positive, -1 negative, 0 neutral
    deltas: torch.Tensor  # [B, A, 4] std-normalized, zero where not positive


@torch.no_grad()
def rpn_targets(
    anchors: torch.Tensor,
    gt_class_ids: torch.Tensor,
    gt_boxes: torch.Tensor,
    draws_pos: torch.Tensor,
    draws_neg: torch.Tensor,
    train_anchors_per_image: int = 256,
    rpn_bbox_std: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
) -> RPNTargets:
    """Anchor matching and subsampling. ``anchors [A, 4]``, ``gt_class_ids
    [B, G]`` (0 padding, negative = crowd), ``gt_boxes [B, G, 4]``; draws
    ``[B, A]``. Positives: IoU >= 0.7 or the best anchor of a GT; negatives:
    IoU < 0.3 and no crowd overlap; at most half the anchors positive."""
    is_crowd = gt_class_ids < 0
    is_valid_gt = gt_class_ids > 0
    b = gt_boxes.shape[0]
    anchors_b = anchors.to(torch.float32).expand(b, -1, -1)
    iou = overlaps(anchors_b, gt_boxes.to(torch.float32))  # [B, A, G]
    iou_gt = torch.where(is_valid_gt[:, None, :], iou, -1.0)
    anchor_iou_max, anchor_iou_argmax = iou_gt.max(dim=2)
    no_crowd = torch.where(is_crowd[:, None, :], iou, -1.0).amax(dim=2) < 0.001

    match = torch.zeros(anchor_iou_max.shape, dtype=torch.int32, device=iou.device)
    match = torch.where((anchor_iou_max < 0.3) & no_crowd, -1, match)
    col_max = torch.clamp(iou.amax(dim=1), min=0.0)  # [B, G]
    is_best = (iou >= col_max[:, None, :]) & is_valid_gt[:, None, :] & (col_max > 0)[:, None, :]
    match = torch.where(is_best.any(dim=2), 1, match)
    match = torch.where(anchor_iou_max >= 0.7, 1, match)

    half = train_anchors_per_image // 2
    pos = _random_keep_topk(draws_pos, match == 1, half, k_bound=half)
    num_pos = pos.sum(dim=1)
    neg = _random_keep_topk(draws_neg, match == -1, train_anchors_per_image - num_pos,
                            k_bound=train_anchors_per_image)
    match = torch.where(pos, 1, torch.where(neg, -1, 0)).to(torch.int32)

    matched_gt = torch.gather(gt_boxes.to(torch.float32), 1, anchor_iou_argmax[..., None].expand(-1, -1, 4))
    deltas = encode_boxes(anchors_b, matched_gt)
    deltas = deltas / torch.tensor(rpn_bbox_std, dtype=deltas.dtype, device=deltas.device)
    deltas = torch.where((match == 1)[..., None], deltas, 0.0)
    return RPNTargets(match=match, deltas=deltas)


class DetectionTargets(NamedTuple):
    rois: torch.Tensor  # [B, T, 4] normalized, zero-padded
    class_ids: torch.Tensor  # [B, T] int32 GT class (0 = negative or padding)
    deltas: torch.Tensor  # [B, T, 4] std-normalized, zero where not positive
    masks: torch.Tensor  # [B, T, mh, mw] {0, 1}, zero where not positive
    positive_mask: torch.Tensor  # [B, T] bool
    valid_mask: torch.Tensor  # [B, T] bool


@torch.no_grad()
def detection_targets(
    proposals: torch.Tensor,
    gt_class_ids: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_masks: torch.Tensor,
    draws_pos: torch.Tensor,
    draws_neg: torch.Tensor,
    *,
    train_rois_per_image: int = 200,
    roi_positive_ratio: float = 0.33,
    bbox_std: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    mask_shape: Sequence[int] = (28, 28),
    use_mini_masks: bool = False,
) -> DetectionTargets:
    """Sample ``proposals [B, P, 4]`` into ``T`` head-training slots.

    Positives have IoU >= 0.5 with a non-crowd GT (at most ``int(T * ratio)``),
    negatives IoU < 0.5 and no crowd overlap (``int(pos / ratio) - pos`` of
    them); slots hold positives, then negatives, then zero padding. Mask
    targets are the assigned GT mask cropped to the ROI (in the GT box's frame
    for mini masks ``[B, G, mh', mw']``), resized to ``mask_shape`` and
    rounded. Draws are ``[B, P]``.
    """
    b, p, _ = proposals.shape
    t = train_rois_per_image
    dev = proposals.device
    proposals = proposals.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)

    proposal_valid = (torch.abs(proposals) > 0).any(dim=2)
    is_crowd = gt_class_ids < 0
    is_valid_gt = gt_class_ids > 0
    iou = overlaps(proposals, gt_boxes)  # [B, P, G]
    iou_gt = torch.where(is_valid_gt[:, None, :], iou, -1.0)
    roi_iou_max, roi_gt_argmax = iou_gt.max(dim=2)
    no_crowd = torch.where(is_crowd[:, None, :], iou, -1.0).amax(dim=2) < 0.001
    positive_cand = proposal_valid & (roi_iou_max >= 0.5)
    negative_cand = proposal_valid & (roi_iou_max < 0.5) & no_crowd

    max_pos = int(t * roi_positive_ratio)
    pos_sel = _random_keep_topk(draws_pos, positive_cand, max_pos, k_bound=max_pos)
    pos_count = pos_sel.sum(dim=1).to(torch.int32)
    # tensor / tensor: a CUDA division by a Python scalar multiplies by its
    # reciprocal, which can truncate 66 / 0.33 to 199
    ratio = torch.full_like(pos_count, roi_positive_ratio, dtype=torch.float32)
    neg_count = (pos_count.to(torch.float32) / ratio).to(torch.int32) - pos_count
    neg_sel = _random_keep_topk(draws_neg, negative_cand, neg_count, k_bound=t)

    arange = torch.arange(p, dtype=torch.int64, device=dev).expand(b, p)
    prio = torch.where(pos_sel, arange, torch.where(neg_sel, p + arange, 2 * p + arange))
    order = torch.argsort(prio, dim=1)[:, :t]  # unique priorities: any sort agrees
    slot_pos = torch.gather(pos_sel, 1, order)
    slot_valid = slot_pos | torch.gather(neg_sel, 1, order)

    rois = torch.gather(proposals, 1, order[..., None].expand(-1, -1, 4))
    rois = torch.where(slot_valid[..., None], rois, 0.0)
    roi_gt_idx = torch.gather(roi_gt_argmax, 1, order)  # [B, T]
    roi_gt_boxes = torch.gather(gt_boxes, 1, roi_gt_idx[..., None].expand(-1, -1, 4))
    class_ids = torch.where(slot_pos, torch.gather(gt_class_ids.to(torch.int64), 1, roi_gt_idx), 0)
    class_ids = class_ids.to(torch.int32)

    deltas = encode_boxes(rois, roi_gt_boxes)
    deltas = deltas / torch.tensor(bbox_std, dtype=deltas.dtype, device=dev)
    deltas = torch.where(slot_pos[..., None], deltas, 0.0)

    if use_mini_masks:  # the ROI in the frame of its GT box
        gy1, gx1, gy2, gx2 = (roi_gt_boxes[..., i] for i in range(4))
        gh = torch.clamp(gy2 - gy1, min=1e-8)
        gw = torch.clamp(gx2 - gx1, min=1e-8)
        crop_boxes = torch.stack(
            [(rois[..., 0] - gy1) / gh, (rois[..., 1] - gx1) / gw,
             (rois[..., 2] - gy1) / gh, (rois[..., 3] - gx1) / gw],
            dim=-1,
        )
    else:
        crop_boxes = rois
    if gt_masks.shape[-2] * gt_masks.shape[-1] <= 256 * 256:
        masks = crop_and_resize_separable(gt_masks, crop_boxes, roi_gt_idx, mask_shape)
    else:
        masks = torch.stack([
            crop_and_resize(gt_masks[i][..., None], crop_boxes[i], roi_gt_idx[i], mask_shape)[..., 0]
            for i in range(b)
        ])
    masks = torch.where(slot_pos[..., None, None], torch.round(masks), 0.0)
    return DetectionTargets(rois=rois, class_ids=class_ids, deltas=deltas, masks=masks,
                            positive_mask=slot_pos, valid_mask=slot_valid)
