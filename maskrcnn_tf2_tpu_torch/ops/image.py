"""Image meta contract and input normalization.

Counterpart of ``maskrcnn_tf2_tpu/ops/image.py``. The meta vector is
``[image_id(1), original_shape(3), image_shape(3), window(4), scale(1),
active_class_ids(num_classes)]``; images stay channels-last ``[..., H, W, C]``.
``crop_and_resize`` and its separable form build the mask targets of the
training step.
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


# ---------------------------------------------------------------------------
# crop_and_resize: bilinear, tf.image.crop_and_resize semantics
# ---------------------------------------------------------------------------


def _sample_coords(lo: torch.Tensor, hi: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``[..., n]`` sample coordinates whose grid endpoints sit on ``lo`` and
    ``hi`` scaled by ``dim - 1`` (the centre when ``n == 1``)."""
    if n > 1:
        # IEEE division on the host (PyTorch's CUDA division by a scalar
        # multiplies by its reciprocal)
        frac = torch.from_numpy(np.arange(n, dtype=np.float32) / np.float32(n - 1)).to(lo.device)
        return (lo[..., None] + (hi - lo)[..., None] * frac) * (dim - 1)
    return (0.5 * (lo + hi))[..., None] * (dim - 1)


def crop_and_resize(
    images: torch.Tensor, boxes: torch.Tensor, box_indices: torch.Tensor, crop_size
) -> torch.Tensor:
    """``tf.image.crop_and_resize`` (bilinear, extrapolation 0).

    ``images [K, H, W, C]``, ``boxes [R, 4]`` normalized, ``box_indices [R]``
    -> ``[R, ph, pw, C]`` float32. A sample point whose y or x falls outside
    ``[0, dim - 1]`` gives 0.
    """
    k, h, w, c = images.shape
    r = boxes.shape[0]
    ph, pw = int(crop_size[0]), int(crop_size[1])
    boxes = boxes.to(torch.float32)
    y1, x1, y2, x2 = (boxes[:, i] for i in range(4))
    ys = _sample_coords(y1, y2, ph, h)  # [R, ph]
    xs = _sample_coords(x1, x2, pw, w)  # [R, pw]
    valid_y = (ys >= 0) & (ys <= h - 1)
    valid_x = (xs >= 0) & (xs <= w - 1)

    def corners(coord, size):
        c0 = torch.floor(coord).to(torch.int64)
        t = coord - c0.to(torch.float32)
        return torch.clamp(c0, 0, size - 1), torch.clamp(c0 + 1, 0, size - 1), t

    y0, y1i, ty = corners(ys, h)
    x0, x1i, tx = corners(xs, w)
    flat = images.reshape(k * h * w, c).to(torch.float32)
    base = box_indices.to(torch.int64)[:, None, None] * (h * w)

    def gather(yc, xc):
        idx = base + yc[:, :, None] * w + xc[:, None, :]  # [R, ph, pw]
        return flat[idx.reshape(-1)].reshape(r, ph, pw, c)

    wy1 = ty[:, :, None, None]
    wx1 = tx[:, None, :, None]
    out = (
        gather(y0, x0) * (1 - wy1) * (1 - wx1)
        + gather(y0, x1i) * (1 - wy1) * wx1
        + gather(y1i, x0) * wy1 * (1 - wx1)
        + gather(y1i, x1i) * wy1 * wx1
    )
    point_valid = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    return torch.where(point_valid, out, 0.0)


def crop_and_resize_separable(
    masks: torch.Tensor, boxes: torch.Tensor, box_indices: torch.Tensor, crop_size
) -> torch.Tensor:
    """``crop_and_resize`` of single-channel ``masks [..., K, H, W]`` as two
    batched matmuls, ``out_r = Y_r @ M_{g_r} @ X_r^T`` with hat-function
    interpolation rows (``Y_r[i, h] = max(0, 1 - |y_i - h|)``, zero for an
    out-of-range point). ``boxes [..., R, 4]``, ``box_indices [..., R]`` ->
    ``[..., R, ph, pw]`` float32; leading axes batch images."""
    k, h, w = masks.shape[-3:]
    ph, pw = int(crop_size[0]), int(crop_size[1])
    boxes = boxes.to(torch.float32)
    y1, x1, y2, x2 = (boxes[..., i] for i in range(4))
    ys = _sample_coords(y1, y2, ph, h)  # [..., R, ph]
    xs = _sample_coords(x1, x2, pw, w)
    valid_y = (ys >= 0) & (ys <= h - 1)
    valid_x = (xs >= 0) & (xs <= w - 1)
    grid_h = torch.arange(h, dtype=torch.float32, device=boxes.device)
    grid_w = torch.arange(w, dtype=torch.float32, device=boxes.device)
    ymat = torch.clamp(1.0 - torch.abs(ys[..., None] - grid_h), min=0.0) * valid_y[..., None]
    xmat = torch.clamp(1.0 - torch.abs(xs[..., None] - grid_w), min=0.0) * valid_x[..., None]
    idx = box_indices.to(torch.int64)
    sel = torch.gather(
        masks.to(torch.float32), -3,
        idx[..., None, None].expand(*idx.shape, h, w),
    )  # [..., R, H, W]
    return (ymat @ sel) @ xmat.transpose(-1, -2)
