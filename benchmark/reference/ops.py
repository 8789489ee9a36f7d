"""Plain float32 PyTorch operations of Mask R-CNN inference, the yardstick the
benchmark judges the port's outputs by.

Written from the published description (matterport/Mask_RCNN
``mrcnn/model.py`` and ``mrcnn/utils.py``) in the conventions of the port's
JAX reference: boxes ``(y1, x1, y2, x2)`` normalized with the ``h - 1``,
``w - 1`` scale, anchors row-major with ratios fastest, greedy NMS over
score-sorted boxes with ties kept in index order, ROIs assigned to pyramid
levels by ``4 + round(log2(sqrt(hw) / (244 / sqrt(image area))))``, and
bilinear crops whose sample grid ends on the box corners. No kernel, no
batching across images, no lower precision: every function here computes in
float32 on whatever device its inputs live on, and imports nothing of the
program under test.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DELTA_CLIP = float(np.log(1000.0 / 16.0))  # log-size deltas clamped before exp


# ---------------------------------------------------------------- anchors


def pyramid_anchors(cfg: dict) -> np.ndarray:
    """Normalized anchors ``[A, 4]``, P2..P6, (row, col, ratio) order."""
    h, w = cfg["image_shape"][0], cfg["image_shape"][1]
    out = []
    for scale, stride in zip(cfg["rpn_anchor_scales"], cfg["backbone_strides"]):
        fh, fw = int(np.ceil(h / stride)), int(np.ceil(w / stride))
        ratios = np.asarray(cfg["rpn_anchor_ratios"], np.float64)
        heights, widths = scale / np.sqrt(ratios), scale * np.sqrt(ratios)
        sy = np.arange(0, fh, cfg.get("rpn_anchor_stride", 1)) * stride
        sx = np.arange(0, fw, cfg.get("rpn_anchor_stride", 1)) * stride
        sx, sy = np.meshgrid(sx, sy)
        bw, cx = np.meshgrid(widths, sx)
        bh, cy = np.meshgrid(heights, sy)
        centers = np.stack([cy, cx], axis=2).reshape(-1, 2)
        sizes = np.stack([bh, bw], axis=2).reshape(-1, 2)
        out.append(np.concatenate([centers - 0.5 * sizes, centers + 0.5 * sizes], axis=1).astype(np.float32))
    pix = np.concatenate(out, axis=0)
    scale = np.array([h - 1, w - 1, h - 1, w - 1], np.float32)
    return ((pix - np.array([0, 0, 1, 1], np.float32)) / scale).astype(np.float32)


# ---------------------------------------------------------------- boxes


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + 0.5 * height
    cx = boxes[..., 1] + 0.5 * width
    cy = cy + deltas[..., 0] * height
    cx = cx + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])
    y1 = cy - 0.5 * height
    x1 = cx - 0.5 * width
    return torch.stack([y1, x1, y1 + height, x1 + width], dim=-1)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """``window [..., 4]`` broadcastable against ``boxes[..., 0]``."""
    wy1, wx1, wy2, wx2 = (window[..., i] for i in range(4))
    clip = lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi)
    return torch.stack([clip(boxes[..., 0], wy1, wy2), clip(boxes[..., 1], wx1, wx2),
                        clip(boxes[..., 2], wy1, wy2), clip(boxes[..., 3], wx1, wx2)], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)


def overlaps(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``, union clamped at 1e-10."""
    a, b = b1[..., :, None, :], b2[..., None, :, :]
    y1 = torch.maximum(a[..., 0], b[..., 0])
    x1 = torch.maximum(a[..., 1], b[..., 1])
    y2 = torch.minimum(a[..., 2], b[..., 2])
    x2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(y2 - y1, min=0.0) * torch.clamp(x2 - x1, min=0.0)
    union = box_area(b1)[..., :, None] + box_area(b2)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


# ---------------------------------------------------------------- NMS


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, threshold: float, limit: int) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy NMS of one image's score-sorted ``boxes [N, 4]``: a box is kept
    when it is valid and no kept box before it overlaps it by more than
    ``threshold``. Returns the first ``limit`` kept positions (zero-padded)
    and their validity, as numpy arrays."""
    sup = (overlaps(boxes, boxes) > threshold).cpu().numpy()
    ok = valid.cpu().numpy().copy()
    keep = []
    for i in range(len(ok)):
        if not ok[i]:
            continue
        keep.append(i)
        if len(keep) == limit:
            break
        ok &= ~sup[i]
    pos = np.zeros(limit, np.int64)
    pos[:len(keep)] = keep
    return pos, np.arange(limit) < len(keep)


def generate_proposals(rpn_probs: torch.Tensor, rpn_bbox: torch.Tensor, anchors: torch.Tensor,
                       cfg: dict, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: ``[A, 2]`` probabilities and ``[A, 4]`` deltas ->
    (``[count, 4]`` proposals, zero-padded, ``[count]`` validity)."""
    scores = rpn_probs[:, 1].float()
    deltas = rpn_bbox.float() * torch.tensor(cfg["rpn_bbox_std_dev"], dtype=torch.float32, device=scores.device)
    pre = min(cfg["pre_nms_limit"], scores.shape[0])
    order = torch.sort(scores, descending=True, stable=True).indices[:pre]
    d = torch.clamp(deltas[order], -DELTA_CLIP, DELTA_CLIP)
    boxes = apply_box_deltas(anchors.float()[order], d)
    boxes = clip_boxes(boxes, torch.tensor([0.0, 0.0, 1.0, 1.0], device=boxes.device))
    pos, ok = greedy_nms(boxes, torch.ones(pre, dtype=torch.bool, device=boxes.device), cfg["rpn_nms_threshold"], count)
    out = boxes[torch.from_numpy(pos).to(boxes.device)]
    ok_t = torch.from_numpy(ok).to(boxes.device)
    return torch.where(ok_t[:, None], out, 0.0), ok_t


def refine_detections(rois: torch.Tensor, probs: torch.Tensor, deltas: torch.Tensor, window: torch.Tensor,
                      cfg: dict, min_confidence: float) -> torch.Tensor:
    """One image: proposals ``[N, 4]``, ``[N, C]`` probabilities, ``[N, C, 4]``
    deltas and the normalized window -> ``[max_instances, 6]`` detections
    (box, class, score), per-class NMS by a class offset, zero-padded."""
    class_ids = torch.argmax(probs, dim=1)
    scores = probs.gather(1, class_ids[:, None])[:, 0]
    std = torch.tensor(cfg["bbox_std_dev"], dtype=torch.float32, device=rois.device)
    d = torch.clamp(deltas[torch.arange(len(rois), device=rois.device), class_ids] * std, -DELTA_CLIP, DELTA_CLIP)
    refined = clip_boxes(apply_box_deltas(rois, d), window[None, :])
    keep = (rois.abs() > 0).any(dim=1) & (class_ids > 0) & (scores >= min_confidence)
    masked = torch.where(keep, scores, -1e9)
    order = torch.sort(masked, descending=True, stable=True).indices
    shifted = refined + class_ids.float()[:, None] * 2.0
    pos, ok = greedy_nms(shifted[order], keep[order], cfg["detection_nms_threshold"], cfg["detection_max_instances"])
    idx = order[torch.from_numpy(pos).to(rois.device)]
    ok_t = torch.from_numpy(ok).to(rois.device)
    out = torch.cat([refined[idx], class_ids[idx].float()[:, None], scores[idx][:, None]], dim=1)
    return torch.where(ok_t[:, None], out, 0.0)


# ---------------------------------------------------------------- ROIAlign


def roi_levels(boxes: torch.Tensor, image_area: float, num_levels: int = 4) -> torch.Tensor:
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    scale = torch.sqrt(torch.clamp(h * w, min=1e-12))
    image_scale = boxes.new_tensor(244.0) / torch.sqrt(boxes.new_tensor(image_area))
    lvl = torch.clamp(torch.round(torch.log2(scale / image_scale)).to(torch.int64) + 4, 2, 1 + num_levels) - 2
    return torch.where((h > 0) & (w > 0), lvl, torch.zeros_like(lvl))


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor, pool: int, image_shape) -> torch.Tensor:
    """One image: channels-last maps ``[H_l, W_l, C]`` (P2..P5) and boxes
    ``[N, 4]`` -> ``[N, pool, pool, C]``: each box from its level, ``pool``
    bilinear samples a side whose grid ends on the box corners scaled by
    ``(H_l - 1, W_l - 1)``, corners clamped to the map, zero-area boxes zero.
    Differentiable in the maps (the gather's backward scatters)."""
    dev = boxes.device
    c = features[0].shape[-1]
    hs = torch.tensor([f.shape[0] for f in features], device=dev)
    ws = torch.tensor([f.shape[1] for f in features], device=dev)
    offs = torch.tensor(np.cumsum([0] + [f.shape[0] * f.shape[1] for f in features[:-1]]), device=dev)
    lvl = roi_levels(boxes, float(image_shape[0]) * float(image_shape[1]), len(features))
    hm1 = (hs[lvl] - 1).float()[:, None]
    wm1 = (ws[lvl] - 1).float()[:, None]
    y1, x1, y2, x2 = (boxes[:, i] for i in range(4))
    if pool > 1:
        frac = torch.from_numpy(np.arange(pool, dtype=np.float32) / np.float32(pool - 1)).to(dev)
        ys = (y1[:, None] + (y2 - y1)[:, None] * frac) * hm1
        xs = (x1[:, None] + (x2 - x1)[:, None] * frac) * wm1
    else:
        ys, xs = (0.5 * (y1 + y2))[:, None] * hm1, (0.5 * (x1 + x2))[:, None] * wm1

    def corners(v, m1):
        c0 = torch.minimum(torch.clamp(torch.floor(v), min=0.0), m1)
        c1 = torch.minimum(torch.clamp(c0 + 1, min=0.0), m1)
        return c0.long(), c1.long(), torch.clamp(v - c0, 0.0, 1.0)

    y0, y1i, ty = corners(ys, hm1)
    x0, x1i, tx = corners(xs, wm1)
    off, wl = offs[lvl][:, None, None], ws[lvl][:, None, None]
    flat = torch.cat([f.reshape(-1, c) for f in features]).float()

    def at(yc, xc):
        return flat[(off + yc[:, :, None] * wl + xc[:, None, :]).reshape(-1)].reshape(len(boxes), pool, pool, c)

    wy, wx = ty[:, :, None, None], tx[:, None, :, None]
    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
           + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    return out * ((y2 > y1) & (x2 > x1)).float()[:, None, None, None]


# ---------------------------------------------------------------- host I/O


def _resize_bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize; uint8 rounds to nearest."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    chw = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(chw, size=(out_h, out_w), mode="bilinear", align_corners=False)[0]
    y = y[0] if x.dim() == 2 else y.permute(1, 2, 0)
    if image.dtype == np.uint8:
        y = y.round().clamp(0, 255)
    return y.numpy().astype(image.dtype)


def mold_image(image: np.ndarray, cfg: dict, image_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``square`` resize: scale up to ``image_min_dim`` on the short side,
    down so the long side fits ``image_max_dim``, zero-pad to a square. Returns
    the molded image and its meta vector ``[id, original shape, molded shape,
    window, scale, active classes]``."""
    h, w = image.shape[:2]
    scale = max(1.0, cfg["image_min_dim"] / min(h, w))
    if round(max(h, w) * scale) > cfg["image_max_dim"]:
        scale = cfg["image_max_dim"] / max(h, w)
    if scale != 1.0:
        image = _resize_bilinear(image, round(h * scale), round(w * scale))
    rh, rw = image.shape[:2]
    side = cfg["image_max_dim"]
    top, left = (side - rh) // 2, (side - rw) // 2
    image = np.pad(image, [(top, side - rh - top), (left, side - rw - left), (0, 0)])
    meta = np.concatenate([[image_id], [h, w, 3], list(image.shape), [top, left, top + rh, left + rw], [scale],
                           np.ones(cfg["num_classes"])]).astype(np.float32)
    return image, meta


def unmold(detections: np.ndarray, masks: np.ndarray, original_shape, cfg: dict, window) -> dict:
    """One image's ``[D, 6]`` detections and ``[D, mh, mw]`` class masks ->
    pixel boxes of the original image, classes, scores and full-size masks."""
    zero = np.where(detections[:, 4] == 0)[0]
    n = zero[0] if len(zero) else detections.shape[0]
    boxes, class_ids, scores, masks = detections[:n, :4].copy(), detections[:n, 4].astype(np.int32), \
        detections[:n, 5], masks[:n]
    h, w = cfg["image_shape"][0], cfg["image_shape"][1]
    wy1, wx1, wy2, wx2 = window
    wy1, wx1, wy2, wx2 = wy1 / (h - 1), wx1 / (w - 1), (wy2 - 1) / (h - 1), (wx2 - 1) / (w - 1)
    boxes = (boxes - np.array([wy1, wx1, wy1, wx1])) / np.maximum(np.array([wy2 - wy1, wx2 - wx1] * 2), 1e-10)
    oh, ow = original_shape[:2]
    boxes = np.around(boxes * np.array([oh - 1, ow - 1, oh - 1, ow - 1]) + np.array([0, 0, 1, 1])).astype(np.int32)
    keep = np.where((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0)[0]
    boxes, class_ids, scores, masks = boxes[keep], class_ids[keep], scores[keep], masks[keep]
    full = np.zeros((oh, ow, len(keep)), bool)
    for i, (y1, x1, y2, x2) in enumerate(boxes):
        if y2 > y1 and x2 > x1:
            full[y1:y2, x1:x2, i] = _resize_bilinear(masks[i].astype(np.float32), y2 - y1, x2 - x1) >= 0.5
    return {"rois": boxes, "class_ids": class_ids, "scores": scores, "masks": full}
