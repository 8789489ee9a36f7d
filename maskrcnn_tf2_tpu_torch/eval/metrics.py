"""Numpy evaluation metrics: mask IoU, greedy matching, VOC-style AP.

A copy of ``maskrcnn_tf2_tpu/eval/metrics.py``, so that the port imports
nothing of the JAX package; exact parity with it is the point (the float32
mask product and the 1e-10 floors included). Same semantics as the
reference's ``src/evaluating.py``:
``compute_overlaps_masks`` (:13-33), ``compute_matches`` (:36-91),
``compute_ap`` (:94-128) and the IoU-sweep mAP used by the eval notebooks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def compute_overlaps_boxes(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise box IoU [N1, N2] (pixel or normalized, consistent)."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    y1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    x1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    y2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    x2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = np.maximum(y2 - y1, 0) * np.maximum(x2 - x1, 0)
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def compute_overlaps_masks(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Mask IoU via flattened dot product (reference evaluating.py:13-33).

    masks1: [H, W, N1], masks2: [H, W, N2] (binary).
    """
    if masks1.shape[-1] == 0 or masks2.shape[-1] == 0:
        return np.zeros((masks1.shape[-1], masks2.shape[-1]))
    m1 = masks1.reshape(-1, masks1.shape[-1]).astype(np.float32) > 0.5
    m2 = masks2.reshape(-1, masks2.shape[-1]).astype(np.float32) > 0.5
    area1 = m1.sum(0)
    area2 = m2.sum(0)
    inter = m1.T.astype(np.float32) @ m2.astype(np.float32)
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def compute_matches(
    gt_boxes,
    gt_class_ids,
    gt_masks,
    pred_boxes,
    pred_class_ids,
    pred_scores,
    pred_masks,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.0,
    use_masks: bool = True,
):
    """Greedy score-ordered matching (reference evaluating.py:36-91).

    Returns (gt_match, pred_match, overlaps): per-gt matched pred index and
    per-pred matched gt index (-1 = unmatched).
    """
    gt_boxes = np.asarray(gt_boxes)
    pred_boxes = np.asarray(pred_boxes)
    indices = np.argsort(-np.asarray(pred_scores), kind="stable")
    pred_boxes = pred_boxes[indices]
    pred_class_ids = np.asarray(pred_class_ids)[indices]
    pred_scores = np.asarray(pred_scores)[indices]
    if use_masks:
        pred_masks = np.asarray(pred_masks)[..., indices]
        overlaps = compute_overlaps_masks(pred_masks, gt_masks)
    else:
        overlaps = compute_overlaps_boxes(pred_boxes, gt_boxes)

    pred_match = -1 * np.ones([pred_boxes.shape[0]])
    gt_match = -1 * np.ones([gt_boxes.shape[0]])
    for i in range(pred_boxes.shape[0]):
        sorted_ixs = np.argsort(-overlaps[i])
        if score_threshold and pred_scores[i] < score_threshold:
            continue
        for j in sorted_ixs:
            if gt_match[j] > -1:
                continue
            if overlaps[i, j] < iou_threshold:
                break
            if pred_class_ids[i] == gt_class_ids[j]:
                gt_match[j] = i
                pred_match[i] = j
                break
    return gt_match, pred_match, overlaps


def compute_ap(
    gt_boxes,
    gt_class_ids,
    gt_masks,
    pred_boxes,
    pred_class_ids,
    pred_scores,
    pred_masks,
    iou_threshold: float = 0.5,
    use_masks: bool = True,
):
    """VOC-style interpolated AP at one IoU (reference evaluating.py:94-128).

    Returns (mAP, precisions, recalls, overlaps).
    """
    gt_match, pred_match, overlaps = compute_matches(
        gt_boxes,
        gt_class_ids,
        gt_masks,
        pred_boxes,
        pred_class_ids,
        pred_scores,
        pred_masks,
        iou_threshold,
        use_masks=use_masks,
    )
    n_pred = len(pred_match)
    if n_pred == 0:
        return 0.0, np.zeros(0), np.zeros(0), overlaps
    precisions = np.cumsum(pred_match > -1) / (np.arange(n_pred) + 1)
    recalls = np.cumsum(pred_match > -1).astype(np.float32) / max(len(gt_match), 1)

    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = np.maximum(precisions[i], precisions[i + 1])
    indices = np.where(recalls[:-1] != recalls[1:])[0] + 1
    ap = np.sum((recalls[indices] - recalls[indices - 1]) * precisions[indices])
    return float(ap), precisions, recalls, overlaps


def compute_ap_range(
    gt_boxes,
    gt_class_ids,
    gt_masks,
    pred_boxes,
    pred_class_ids,
    pred_scores,
    pred_masks,
    iou_thresholds: Sequence[float] = None,
    use_masks: bool = True,
    verbose: bool = False,
) -> float:
    """AP averaged over IoU 0.5:0.95:0.05 (the eval-notebook sweep)."""
    iou_thresholds = iou_thresholds or np.arange(0.5, 1.0, 0.05)
    ap_total = 0.0
    for t in iou_thresholds:
        ap, _, _, _ = compute_ap(
            gt_boxes,
            gt_class_ids,
            gt_masks,
            pred_boxes,
            pred_class_ids,
            pred_scores,
            pred_masks,
            iou_threshold=t,
            use_masks=use_masks,
        )
        if verbose:
            print(f"AP @{t:.2f}: {ap:.3f}")
        ap_total += ap
    return ap_total / len(iou_thresholds)
