"""Box geometry on ``[..., 4]`` tensors in ``(y1, x1, y2, x2)`` order.

Counterpart of ``maskrcnn_tf2_tpu/ops/boxes.py``: every function broadcasts
over leading axes and keeps the JAX package's operation order, so float32
results agree to the last bit on the CPU.
"""

from __future__ import annotations

import torch


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dy, dx, log dh, log dw) refinements to boxes."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    center_y = center_y + deltas[..., 0] * height
    center_x = center_x + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])

    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    return torch.stack([y1, x1, y1 + height, x1 + width], dim=-1)


def clip_boxes(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clip boxes to a (wy1, wx1, wy2, wx2) window: a 4-sequence or a tensor
    broadcastable against ``boxes[..., 4]`` (e.g. per-image ``[B, 1, 4]``)."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    wy1, wx1, wy2, wx2 = (window[..., i] for i in range(4))

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    return torch.stack(
        [
            clip(boxes[..., 0], wy1, wy2),
            clip(boxes[..., 1], wx1, wx2),
            clip(boxes[..., 2], wy1, wy2),
            clip(boxes[..., 3], wx1, wx2),
        ],
        dim=-1,
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1], min=0.0
    )


def overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``, with the
    union clamped below at 1e-10."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    intersection = torch.clamp(y2 - y1, min=0.0) * torch.clamp(x2 - x1, min=0.0)
    area1 = box_area(boxes1)[..., :, None]
    area2 = box_area(boxes2)[..., None, :]
    union = area1 + area2 - intersection
    return intersection / torch.clamp(union, min=1e-10)


def encode_boxes(boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """``(dy, dx, log dh, log dw)`` targets mapping ``boxes`` to ``gt_boxes``.

    Zero-size boxes are guarded with a 1e-8 floor on heights and widths;
    callers mask such rows out downstream.
    """
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    gt_height = gt_boxes[..., 2] - gt_boxes[..., 0]
    gt_width = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_center_y = gt_boxes[..., 0] + 0.5 * gt_height
    gt_center_x = gt_boxes[..., 1] + 0.5 * gt_width

    height = torch.clamp(height, min=1e-8)
    width = torch.clamp(width, min=1e-8)
    gt_height = torch.clamp(gt_height, min=1e-8)
    gt_width = torch.clamp(gt_width, min=1e-8)

    dy = (gt_center_y - center_y) / height
    dx = (gt_center_x - center_x) / width
    dh = torch.log(gt_height / height)
    dw = torch.log(gt_width / width)
    return torch.stack([dy, dx, dh, dw], dim=-1)
