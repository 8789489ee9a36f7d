"""Box geometry on ``[..., 4]`` tensors in ``(y1, x1, y2, x2)`` order.

Counterpart of ``maskrcnn_tf2_tpu/ops/boxes.py``: every function broadcasts
over leading axes and keeps the JAX package's operation order, so float32
results agree to the last bit on the CPU.
"""

from __future__ import annotations

import torch

from maskrcnn_tf2_tpu_torch.utils import profiling


def _norm_constants(boxes: torch.Tensor, shape):
    h, w = shape[0], shape[1]
    profiling.host_sync(boxes.device, 2)  # the two constants below, copied from the host
    scale = torch.tensor([h - 1, w - 1, h - 1, w - 1], dtype=boxes.dtype, device=boxes.device)
    shift = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=boxes.dtype, device=boxes.device)
    return scale, shift


def norm_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Pixel boxes -> normalized: ``(y2, x2)`` shifted down by one pixel, then
    divided by ``(h - 1, w - 1)``, so ``[0, 0, h, w]`` maps to ``[0, 0, 1, 1]``.
    Tensor by tensor: on CUDA a Python scalar divisor is a reciprocal multiply."""
    scale, shift = _norm_constants(boxes, shape)
    return (boxes - shift) / scale


def denorm_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Normalized boxes -> pixel coordinates (the inverse of ``norm_boxes``)."""
    scale, shift = _norm_constants(boxes, shape)
    return boxes * scale + shift


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
    if not isinstance(window, torch.Tensor):
        profiling.host_sync(boxes.device)  # copied from the host
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


def extract_bboxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """Tight pixel boxes ``[N, 4]`` float32 ``(y1, x1, y2 + 1, x2 + 1)`` from
    masks ``[N, H, W]``; zeros for an empty mask."""
    n, h, w = masks.shape
    any_row = (masks > 0).any(dim=2)  # [N, H]
    any_col = (masks > 0).any(dim=1)  # [N, W]
    rows = torch.arange(h, dtype=torch.int32, device=masks.device).expand(n, h)
    cols = torch.arange(w, dtype=torch.int32, device=masks.device).expand(n, w)
    big = torch.iinfo(torch.int32).max
    y1 = torch.where(any_row, rows, big).amin(dim=1)
    y2 = torch.where(any_row, rows, -1).amax(dim=1) + 1
    x1 = torch.where(any_col, cols, big).amin(dim=1)
    x2 = torch.where(any_col, cols, -1).amax(dim=1) + 1
    box = torch.stack([y1, x1, y2, x2], dim=-1).to(torch.float32)
    return torch.where(any_row.any(dim=1, keepdim=True), box, 0.0)
