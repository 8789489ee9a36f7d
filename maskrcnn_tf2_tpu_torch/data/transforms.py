"""Host-side numpy image and mask geometry of the data pipeline (counterpart
of ``maskrcnn_tf2_tpu/data/transforms.py``), without cv2.

* Bilinear resizes (images, ``unmold_mask``) use PyTorch's ``F.interpolate``
  with ``align_corners=False``, the half-pixel grid of cv2's INTER_LINEAR. cv2
  rounds uint8 images through fixed-point weights, so a resized image can
  differ from cv2's by one grey level, and an unmolded mask pixel can flip
  where the upsampled mask sits at 0.5.
* Nearest resizes (masks) pick source pixel ``min(floor(i / (dst / src)),
  src - 1)``, in double precision, as cv2's INTER_NEAREST does: the same
  pixels.
* ``crop`` mode draws its window from the ``random.Random`` passed in; one
  seeded as ``random.seed`` seeds the JAX package's global generator draws
  the same window.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _resize_bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``[H, W]`` or ``[H, W, C]`` -> resized, same dtype (uint8 rounds to nearest)."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    chw = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(chw, size=(out_h, out_w), mode="bilinear", align_corners=False)[0]
    y = y[0] if x.dim() == 2 else y.permute(1, 2, 0)
    if image.dtype == np.uint8:
        y = y.round().clamp(0, 255)
    return y.numpy().astype(image.dtype)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def _resize_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``[H, W, ...]`` -> ``[out_h, out_w, ...]``, cv2's INTER_NEAREST pixels."""
    h, w = mask.shape[:2]
    return mask[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]


def resize_image(
    image: np.ndarray,
    min_dim: Optional[int] = None,
    max_dim: Optional[int] = None,
    min_scale: Optional[float] = None,
    mode: str = "square",
    rng: Optional[random.Random] = None,
):
    """Aspect-preserving resize + pad: ``(image, window, scale, padding,
    crop)``. ``window`` is the (y1, x1, y2, x2) pixel region holding the image
    inside the padding. ``square`` pads to ``max_dim`` a side, ``pad64`` to
    multiples of 64, ``crop`` takes a random ``min_dim`` square (drawn from
    ``rng``), ``none`` returns the image as it is."""
    image_dtype = image.dtype
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = 1.0
    padding = [(0, 0), (0, 0), (0, 0)]
    crop = None

    if mode == "none":
        return image, window, scale, padding, crop
    if mode not in ("square", "pad64", "crop"):
        raise ValueError(f"resize mode '{mode}' not supported")

    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim and mode == "square":
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max
    if scale != 1.0:
        image = _resize_bilinear(image, round(h * scale), round(w * scale))

    h, w = image.shape[:2]
    if mode == "crop":
        rng = rng or random.Random()
        y = rng.randint(0, h - min_dim)
        x = rng.randint(0, w - min_dim)
        crop = (y, x, min_dim, min_dim)
        return image[y : y + min_dim, x : x + min_dim].astype(image_dtype), (0, 0, min_dim, min_dim), scale, padding, crop
    if mode == "square":
        top, left = (max_dim - h) // 2, (max_dim - w) // 2
        padding = [(top, max_dim - h - top), (left, max_dim - w - left), (0, 0)]
    else:  # pad64
        if min_dim and min_dim % 64:
            raise ValueError("pad64 needs min_dim a multiple of 64")
        pad_h, pad_w = -h % 64, -w % 64
        padding = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)]
    image = np.pad(image, padding[: image.ndim], mode="constant")
    window = (padding[0][0], padding[1][0], h + padding[0][0], w + padding[1][0])
    return image.astype(image_dtype), window, scale, padding, crop


def resize_mask(mask: np.ndarray, scale: float, padding, crop=None) -> np.ndarray:
    """Instance masks ``[H, W, N]`` through the image's scale and padding (or
    crop), nearest neighbour; bool."""
    h, w = mask.shape[:2]
    if scale != 1.0:
        mask = _resize_nearest(mask.astype(np.uint8), round(h * scale), round(w * scale))
    if crop is not None:
        y, x, ch, cw = crop
        mask = mask[y : y + ch, x : x + cw]
    else:
        mask = np.pad(mask, padding[: mask.ndim], mode="constant")
    return mask.astype(bool)


def extract_bboxes(mask: np.ndarray) -> np.ndarray:
    """Tight pixel boxes ``[N, 4]`` int32 (y1, x1, y2, x2), y2 and x2
    exclusive, from masks ``[H, W, N]``; zeros for an empty mask."""
    boxes = np.zeros([mask.shape[-1], 4], dtype=np.int32)
    rows = mask.any(axis=1)  # [H, N]
    cols = mask.any(axis=0)  # [W, N]
    for i in np.nonzero(rows.any(axis=0))[0]:
        ys, xs = np.nonzero(rows[:, i])[0], np.nonzero(cols[:, i])[0]
        boxes[i] = [ys[0], xs[0], ys[-1] + 1, xs[-1] + 1]
    return boxes


def minimize_mask(bbox: np.ndarray, mask: np.ndarray, mini_shape) -> np.ndarray:
    """Crop masks ``[H, W, N]`` to their boxes and resize each to
    ``mini_shape`` (nearest): ``[mh, mw, N]`` bool."""
    mini = np.zeros(tuple(mini_shape) + (mask.shape[-1],), dtype=bool)
    for i in range(mask.shape[-1]):
        y1, x1, y2, x2 = bbox[i][:4].astype(int)
        if y2 > y1 and x2 > x1:
            mini[:, :, i] = _resize_nearest(mask[y1:y2, x1:x2, i], mini_shape[0], mini_shape[1])
    return mini


def expand_mask(bbox: np.ndarray, mini_mask: np.ndarray, image_shape) -> np.ndarray:
    """Inverse of ``minimize_mask``: ``[H, W, N]`` bool."""
    mask = np.zeros(tuple(image_shape[:2]) + (mini_mask.shape[-1],), dtype=bool)
    for i in range(mask.shape[-1]):
        y1, x1, y2, x2 = bbox[i][:4].astype(int)
        if y2 > y1 and x2 > x1:
            mask[y1:y2, x1:x2, i] = _resize_nearest(mini_mask[:, :, i].astype(bool), y2 - y1, x2 - x1)
    return mask


def unmold_boxes(detections: np.ndarray, original_shape, image_shape, window):
    """``(n, boxes [n, 4] int32, keep)``: ``n`` the detections before the first
    of class 0, their boxes in the original image's pixels, and the indices of
    those of positive area, in order."""
    zero_ix = np.where(detections[:, 4] == 0)[0]
    n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]
    boxes = detections[:n, :4].copy()
    h, w = image_shape[0], image_shape[1]
    wy1, wx1, wy2, wx2 = window
    wy1, wx1, wy2, wx2 = wy1 / (h - 1), wx1 / (w - 1), (wy2 - 1) / (h - 1), (wx2 - 1) / (w - 1)
    shift = np.array([wy1, wx1, wy1, wx1])
    scale_arr = np.array([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    boxes = (boxes - shift) / np.maximum(scale_arr, 1e-10)
    oh, ow = original_shape[:2]
    boxes = np.around(
        boxes * np.array([oh - 1, ow - 1, oh - 1, ow - 1]) + np.array([0, 0, 1, 1])
    ).astype(np.int32)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return n, boxes, np.where(areas > 0)[0]


def paste_kept_masks(out: np.ndarray, masks: np.ndarray, boxes: np.ndarray, keep) -> None:
    """``unmold_mask`` of ``masks[j]`` at ``boxes[j]`` (``unmold_boxes``'
    pixel boxes) for the ``k``-th ``j`` of ``keep``, into ``out[:, :, k]``,
    an ``[H0, W0, len(keep)]`` bool view."""
    for slot, j in enumerate(keep):
        out[:, :, slot] = unmold_mask(masks[j], boxes[j], out.shape)


def unmold_mask(mask: np.ndarray, bbox, image_shape) -> np.ndarray:
    """Paste a low-resolution float mask into full resolution, thresholded at
    0.5."""
    y1, x1, y2, x2 = (int(v) for v in bbox)
    full = np.zeros(tuple(image_shape[:2]), dtype=bool)
    if y2 <= y1 or x2 <= x1:
        return full
    full[y1:y2, x1:x2] = _resize_bilinear(mask.astype(np.float32), y2 - y1, x2 - x1) >= 0.5
    return full
