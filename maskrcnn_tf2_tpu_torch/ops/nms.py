"""Fixed-shape greedy non-max suppression.

Counterpart of ``maskrcnn_tf2_tpu/ops/nms.py`` with the same
``(indices, valid)`` contract. The port's functions are batched: ``[B, N, 4]``
boxes give ``[B, max_output_size]`` outputs in one kernel launch; ``[N, 4]``
boxes give ``[max_output_size]`` as in the JAX package. The keep-mask comes
from ``kernels.nms.greedy_nms``, which also compacts it, so the ``top_k``
compaction of the JAX package is not needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from maskrcnn_tf2_tpu_torch.kernels.nms import greedy_nms

_NEG_INF = -1e9


def non_max_suppression(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output_size: int,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    presorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS.

    Args:
      boxes: ``[B, N, 4]`` or ``[N, 4]`` (y1, x1, y2, x2), float32.
      scores: ``[B, N]`` or ``[N]``.
      max_output_size: output slot count.
      iou_threshold: suppression threshold.
      valid: optional bool mask of real (non-padding) rows.
      presorted: the caller guarantees that ``scores`` (where valid) are
        already descending, e.g. they came out of a top-k.

    Returns:
      ``(indices, out_valid)``: int32 indices into the input, in descending
      score order (ties: lowest index first), 0 where ``out_valid`` is False.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    boxes = boxes.to(torch.float32)
    b, n, _ = boxes.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    if presorted:
        boxes_s, valid_s, order = boxes, valid, None
    else:
        scores = torch.where(valid, scores.to(torch.float32), _NEG_INF)
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        valid_s = torch.gather(valid, 1, order)
    positions, out_valid = greedy_nms(
        boxes_s.contiguous(), valid_s.contiguous(), iou_threshold, max_output_size
    )
    if order is None:
        indices = positions
    else:
        picked = torch.gather(order, 1, positions.long().clamp(max=max(n - 1, 0)))
        indices = torch.where(out_valid, picked, 0).to(torch.int32)
    if single:
        return indices[0], out_valid[0]
    return indices, out_valid


def nms_padded_boxes(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_output_size: int,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
    presorted: bool = False,
):
    """NMS returning gathered, zero-padded ``(boxes [.., M, 4], scores [.., M],
    valid [.., M])``."""
    idx, out_valid = non_max_suppression(
        boxes, scores, max_output_size, iou_threshold, valid, presorted=presorted
    )
    idx = idx.long()
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, 0.0)
    out_scores = torch.where(out_valid, torch.gather(scores, -1, idx), 0.0)
    return out_boxes, out_scores, out_valid
