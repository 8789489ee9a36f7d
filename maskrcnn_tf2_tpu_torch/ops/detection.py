"""Inference detection refinement: class-specific decode + class-offset NMS.

Counterpart of ``maskrcnn_tf2_tpu/ops/detection.py``, batched over images
(one NMS launch for the batch). Each box is shifted by ``class_id * 2`` before
suppression, so boxes of different classes never overlap: one NMS equals
per-class NMS. Output ``[B, max_instances, 6]`` = (y1, x1, y2, x2, class_id,
score), normalized, zero-padded. Runs in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch

from maskrcnn_tf2_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from maskrcnn_tf2_tpu_torch.ops.nms import non_max_suppression
from maskrcnn_tf2_tpu_torch.ops.proposal import DELTA_CLIP
from maskrcnn_tf2_tpu_torch.utils import profiling


@torch.no_grad()
def refine_detections(
    rois: torch.Tensor,  # [B, N, 4]
    probs: torch.Tensor,  # [B, N, C]
    deltas: torch.Tensor,  # [B, N, C, 4]
    windows: torch.Tensor,  # [B, 4] normalized
    bbox_std: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    min_confidence: float = 0.7,
    nms_threshold: float = 0.3,
    max_instances: int = 100,
) -> torch.Tensor:
    rois = rois.to(torch.float32)
    probs = probs.to(torch.float32)
    deltas = deltas.to(torch.float32)
    windows = windows.to(torch.float32)

    class_ids = torch.argmax(probs, dim=2)  # [B, N]; background may win
    scores = torch.gather(probs, 2, class_ids[..., None])[..., 0]
    profiling.host_sync(rois.device)  # the constant below, copied from the host
    std = torch.tensor(bbox_std, dtype=torch.float32, device=rois.device)
    class_deltas = torch.gather(deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))
    class_deltas = torch.clamp(class_deltas[:, :, 0] * std, -DELTA_CLIP, DELTA_CLIP)
    refined = apply_box_deltas(rois, class_deltas)
    refined = clip_boxes(refined, windows[:, None, :])

    roi_valid = torch.any(torch.abs(rois) > 0, dim=2)
    keep = roi_valid & (class_ids > 0) & (scores >= min_confidence)

    shifted = refined + class_ids.to(torch.float32)[..., None] * 2.0
    nms_idx, nms_valid = non_max_suppression(
        shifted, scores, max_instances, nms_threshold, valid=keep
    )
    nms_idx = nms_idx.long()
    out_boxes = torch.gather(refined, 1, nms_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(nms_valid[..., None], out_boxes, 0.0)
    out_class = torch.where(nms_valid, torch.gather(class_ids, 1, nms_idx), 0)
    out_score = torch.where(nms_valid, torch.gather(scores, 1, nms_idx), 0.0)
    return torch.cat(
        [out_boxes, out_class.to(torch.float32)[..., None], out_score[..., None]], dim=2
    )
