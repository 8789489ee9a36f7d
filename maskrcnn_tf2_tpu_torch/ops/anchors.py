"""Pyramid anchor generation (numpy), a copy of ``maskrcnn_tf2_tpu/ops/anchors.py``.

Anchors are a constant for a fixed image shape, so they are made once on the
host and moved to the device by the model. Ordering is (row, col, ratio) per
level, row-major with ratios fastest, levels finest first; it must match the
RPN head's reshape ordering exactly.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig


def compute_backbone_shapes(
    image_shape: Sequence[int], strides: Sequence[int]
) -> Tuple[Tuple[int, int], ...]:
    """Spatial [H, W] of each pyramid level."""
    h, w = int(image_shape[0]), int(image_shape[1])
    return tuple((int(np.ceil(h / s)), int(np.ceil(w / s))) for s in strides)


def generate_level_anchors(
    scale: float,
    ratios: Sequence[float],
    feature_shape: Sequence[int],
    feature_stride: int,
    anchor_stride: int = 1,
) -> np.ndarray:
    """All anchors for one pyramid level, pixel coords ``[N, (y1,x1,y2,x2)]``."""
    ratios = np.asarray(ratios, dtype=np.float64)
    heights = scale / np.sqrt(ratios)
    widths = scale * np.sqrt(ratios)

    shifts_y = np.arange(0, feature_shape[0], anchor_stride) * feature_stride
    shifts_x = np.arange(0, feature_shape[1], anchor_stride) * feature_stride
    shifts_x_grid, shifts_y_grid = np.meshgrid(shifts_x, shifts_y)

    box_widths, box_centers_x = np.meshgrid(widths, shifts_x_grid)
    box_heights, box_centers_y = np.meshgrid(heights, shifts_y_grid)

    box_centers = np.stack([box_centers_y, box_centers_x], axis=2).reshape(-1, 2)
    box_sizes = np.stack([box_heights, box_widths], axis=2).reshape(-1, 2)

    return np.concatenate(
        [box_centers - 0.5 * box_sizes, box_centers + 0.5 * box_sizes], axis=1
    ).astype(np.float32)


def generate_pyramid_anchors(
    scales: Sequence[float],
    ratios: Sequence[float],
    feature_shapes: Sequence[Sequence[int]],
    feature_strides: Sequence[int],
    anchor_stride: int = 1,
) -> np.ndarray:
    """Concat anchors over levels: ``[A, 4]`` pixel coords, P2..P6."""
    return np.concatenate(
        [
            generate_level_anchors(
                scales[i], ratios, feature_shapes[i], feature_strides[i], anchor_stride
            )
            for i in range(len(scales))
        ],
        axis=0,
    )


def norm_boxes_np(boxes: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Pixel boxes -> normalized, scaled by (h - 1, w - 1)."""
    h, w = shape[0], shape[1]
    scale = np.array([h - 1, w - 1, h - 1, w - 1], dtype=np.float32)
    shift = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)
    return ((boxes - shift) / scale).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _cached_anchors(
    image_hw: Tuple[int, int],
    scales: Tuple[float, ...],
    ratios: Tuple[float, ...],
    strides: Tuple[int, ...],
    anchor_stride: int,
) -> np.ndarray:
    feature_shapes = compute_backbone_shapes(image_hw, strides)
    pix = generate_pyramid_anchors(scales, ratios, feature_shapes, strides, anchor_stride)
    anchors = norm_boxes_np(pix, image_hw)
    anchors.flags.writeable = False  # shared by every caller of the cache
    return anchors


def get_anchors(config: MaskRCNNConfig, image_shape=None) -> np.ndarray:
    """Normalized pyramid anchors ``[A, 4]`` for a config (cached per shape)."""
    hw = tuple((image_shape or config.image_shape)[:2])
    return _cached_anchors(
        hw,
        tuple(float(s) for s in config.rpn_anchor_scales),
        tuple(float(r) for r in config.rpn_anchor_ratios),
        tuple(config.backbone_strides),
        config.rpn_anchor_stride,
    )
