"""The least time an H100 could take for a kernel's work: bytes over the HBM
bandwidth, operations over the float32 rate outside the tensor cores (NVIDIA's
data sheet, SXM part at 700 W). ``nms_bound`` is copied from the port's
``chip_smoke.py`` so that the yardstick stays with the
benchmark; ``roi_bound`` there counted the whole pyramid as read, which a
1024 pyramid's sparse samples do not read, so here it counts the pixels the
samples touch. Each returns ``(bytes ms, operations ms)``, and a roofline
share is ``max`` of the two over the measured time.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_DENSE_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
IOU_FLOPS = 13  # per box pair: 4 min/max, 2 sub, 2 clamps, 1 mul, 2 add/sub, 1 max, 1 div


def nms_bound(boxes_s, valid_s, positions, out_valid):
    """(bytes time, operations time) in ms of greedy NMS over score-sorted
    ``boxes_s [B, N, 4]``. Operations count the pairs greedy NMS must test on
    this data, up to the box that fills the limit: a kept box against every
    box kept before it, a suppressed one against one box."""
    b, n, _ = boxes_s.shape
    limit = positions.shape[1]
    pairs = 0
    for i in range(b):
        kept = positions[i][out_valid[i]].long().cpu()
        keep = torch.zeros(n, dtype=torch.long)
        keep[kept] = 1
        end = int(kept[-1]) + 1 if len(kept) == limit else n
        kept_before = torch.cumsum(keep, 0) - keep
        need = torch.where(keep.bool(), kept_before, torch.ones_like(keep))
        pairs += int((need[:end] * valid_s[i, :end].cpu().long()).sum())
    nbytes = b * n * (16 + 1) + b * limit * (4 + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, pairs * IOU_FLOPS / F32_FLOPS * 1e3


def roi_touched_pixels(level_hw, boxes, pool: int, image_shape) -> int:
    """Distinct pyramid pixels that the bilinear samples' corners of
    ``boxes [B, N, 4]`` touch, each ROI at its level (the reference's level
    rule and sample grid), counted once per image."""
    from benchmark.reference.ops import roi_levels

    boxes = boxes.detach().float().cpu()
    area = float(image_shape[0]) * float(image_shape[1])
    frac = torch.arange(pool, dtype=torch.float32) / max(pool - 1, 1)
    total = 0
    for bx in boxes:
        lvl = roi_levels(bx, area, len(level_hw))
        ok = (bx[:, 2] > bx[:, 0]) & (bx[:, 3] > bx[:, 1])
        for level, (h, w) in enumerate(level_hw):
            sel = bx[ok & (lvl == level)]
            if not len(sel):
                continue
            if pool > 1:
                ys = (sel[:, :1] + (sel[:, 2:3] - sel[:, :1]) * frac) * (h - 1)
                xs = (sel[:, 1:2] + (sel[:, 3:4] - sel[:, 1:2]) * frac) * (w - 1)
            else:
                ys, xs = (0.5 * (sel[:, :1] + sel[:, 2:3])) * (h - 1), (0.5 * (sel[:, 1:2] + sel[:, 3:4])) * (w - 1)
            y0 = torch.clamp(torch.floor(ys), 0, h - 1)
            x0 = torch.clamp(torch.floor(xs), 0, w - 1)
            rows = torch.cat([y0, torch.clamp(y0 + 1, max=h - 1)], dim=1).long()
            cols = torch.cat([x0, torch.clamp(x0 + 1, max=w - 1)], dim=1).long()
            total += int(torch.unique((rows[:, :, None] * w + cols[:, None, :]).reshape(-1)).numel())
    return total


def roi_bound(features, boxes, pool, image_shape):
    """ROIAlign forward: the pyramid pixels its samples touch and the boxes
    read once, the pooled ROIs written once; 8 operations per output element
    (4 weights, 4 products). ``features`` may be meta tensors (shapes)."""
    b, n, _ = boxes.shape
    c = features[0].shape[-1]
    item = features[0].element_size()
    out_elems = b * n * pool * pool * c
    touched = roi_touched_pixels([(f.shape[1], f.shape[2]) for f in features], boxes, pool, image_shape)
    nbytes = touched * c * item + boxes.numel() * 4 + out_elems * item
    return nbytes / HBM_BYTES_PER_S * 1e3, out_elems * 8 / F32_FLOPS * 1e3

