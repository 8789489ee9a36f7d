"""Inference I/O on the host: resize + meta in, unmold out.

Counterpart of ``maskrcnn_tf2_tpu/export/inference.py`` and of the
``square`` mode of ``resize_image`` and ``unmold_mask`` in
``maskrcnn_tf2_tpu/data/transforms.py``. The JAX package resizes with cv2,
which the card's machine does not have; the port resizes with PyTorch's
bilinear ``F.interpolate`` (``align_corners=False``, the same half-pixel
grid as cv2's INTER_LINEAR). cv2 rounds uint8 images through fixed-point
weights, so a resized image can differ from cv2's by one grey level, and an
unmolded mask pixel can flip where the upsampled mask sits at 0.5.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.ops.image import compose_image_meta


def _resize_bilinear(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``[H, W]`` or ``[H, W, C]`` -> resized, same dtype (uint8 rounds to nearest)."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    chw = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(chw, size=(out_h, out_w), mode="bilinear", align_corners=False)[0]
    y = y[0] if x.dim() == 2 else y.permute(1, 2, 0)
    if image.dtype == np.uint8:
        y = y.round().clamp(0, 255)
    return y.numpy().astype(image.dtype)


def resize_image(image: np.ndarray, min_dim=None, max_dim=None, min_scale=None, mode="square"):
    """Aspect-preserving resize + centered zero pad to ``max_dim`` square.

    Returns ``(image, window, scale)``; ``window`` is the (y1, x1, y2, x2)
    pixel region of the real image inside the padding.
    Only the ``square`` mode, the flagship configuration's, is ported.
    """
    if mode != "square":
        raise NotImplementedError(f"resize mode {mode!r} is not ported yet (only 'square')")
    h, w = image.shape[:2]
    scale = 1.0
    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim:
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max
    if scale != 1.0:
        image = _resize_bilinear(image, round(h * scale), round(w * scale))
    h, w = image.shape[:2]
    top_pad = (max_dim - h) // 2
    left_pad = (max_dim - w) // 2
    padding = [(top_pad, max_dim - h - top_pad), (left_pad, max_dim - w - left_pad), (0, 0)]
    image = np.pad(image, padding[: image.ndim], mode="constant")
    return image, (top_pad, left_pad, h + top_pad, w + left_pad), scale


def unmold_mask(mask: np.ndarray, bbox, image_shape) -> np.ndarray:
    """Paste a low-res float mask into full resolution, thresholded at 0.5."""
    y1, x1, y2, x2 = (int(v) for v in bbox)
    full = np.zeros(tuple(image_shape[:2]), dtype=bool)
    if y2 <= y1 or x2 <= x1:
        return full
    m = _resize_bilinear(mask.astype(np.float32), y2 - y1, x2 - x1)
    full[y1:y2, x1:x2] = m >= 0.5
    return full


def process_input(
    image: np.ndarray, config: MaskRCNNConfig, image_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB image -> (molded image in the input dtype, meta vector).
    Normalization happens on the device inside the model."""
    original_shape = image.shape
    molded, window, scale = resize_image(
        image,
        min_dim=config.image_min_dim,
        max_dim=config.image_max_dim,
        min_scale=config.image_min_scale,
        mode=config.image_resize_mode,
    )
    meta = compose_image_meta(
        image_id, original_shape, molded.shape, window, scale,
        np.ones(config.num_classes, np.float32),
    )
    return molded, meta


def unmold_detections(
    detections: np.ndarray, masks: np.ndarray, original_shape, image_shape, window
) -> Dict[str, np.ndarray]:
    """One image's padded outputs -> original-image-space results.

    ``detections [D, 6]`` normalized; ``masks [D, mh, mw]`` already gathered
    at each detection's class on the device. Returns
    rois ``[N, 4]`` pixel int32, class_ids ``[N]``, scores ``[N]`` and masks
    ``[H0, W0, N]`` bool.
    """
    zero_ix = np.where(detections[:, 4] == 0)[0]
    n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

    boxes = detections[:n, :4].copy()
    class_ids = detections[:n, 4].astype(np.int32)
    scores = detections[:n, 5]

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
    keep = np.where(areas > 0)[0]
    boxes, class_ids, scores, masks = boxes[keep], class_ids[keep], scores[keep], masks[:n][keep]

    full_masks = np.zeros(tuple(original_shape[:2]) + (len(keep),), dtype=bool)
    for i in range(len(keep)):
        full_masks[:, :, i] = unmold_mask(masks[i], boxes[i], original_shape)
    return {"rois": boxes, "class_ids": class_ids, "scores": scores, "masks": full_masks}
