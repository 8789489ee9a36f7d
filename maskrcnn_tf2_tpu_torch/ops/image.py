"""Image meta contract and input normalization.

Counterpart of ``maskrcnn_tf2_tpu/ops/image.py``. The meta vector is
``[image_id(1), original_shape(3), image_shape(3), window(4), scale(1),
active_class_ids(num_classes)]``; images stay channels-last ``[..., H, W, C]``.
"""

from __future__ import annotations

import numpy as np
import torch


def compose_image_meta(
    image_id, original_shape, image_shape, window, scale, active_class_ids
) -> np.ndarray:
    """The meta vector of one image, on the host."""
    return np.concatenate(
        [
            np.asarray([image_id], np.float32),
            np.asarray(original_shape[:3], np.float32),
            np.asarray(image_shape[:3], np.float32),
            np.asarray(window, np.float32),
            np.asarray([scale], np.float32),
            np.asarray(active_class_ids, np.float32),
        ]
    )


def parse_image_meta(meta: torch.Tensor) -> dict:
    """Split a batched ``[B, M]`` meta tensor into named parts."""
    return {
        "image_id": meta[..., 0:1],
        "original_image_shape": meta[..., 1:4],
        "image_shape": meta[..., 4:7],
        "window": meta[..., 7:11],
        "scale": meta[..., 11:12],
        "active_class_ids": meta[..., 12:],
    }


def norm_window(window: torch.Tensor, image_shape) -> torch.Tensor:
    """Pixel window -> normalized, with the norm_boxes convention."""
    h, w = image_shape[0], image_shape[1]
    scale = window.new_tensor([h - 1, w - 1, h - 1, w - 1])
    shift = window.new_tensor([0.0, 0.0, 1.0, 1.0])
    return (window - shift) / scale


def normalize_image(image: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8/float [0, 255] -> (x/255 - mean) / std in float32."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=image.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) / 255.0 - mean) / std


def maxmin_normalize_image(image: torch.Tensor) -> torch.Tensor:
    """Per-image (x - min) / (max - min) over the trailing (H, W, C) axes."""
    x = image.to(torch.float32)
    axes = tuple(range(x.ndim - 3, x.ndim))
    lo = torch.amin(x, dim=axes, keepdim=True)
    x = x - lo
    hi = torch.amax(x, dim=axes, keepdim=True)
    return x / torch.clamp(hi, min=1e-12)
