"""Pyramid ROIAlign over channels-last FPN maps.

Counterpart of ``maskrcnn_tf2_tpu/ops/roi_align.py``: maps are
``[B, H_l, W_l, C]`` finest first (P2..P5), boxes ``[B, N, 4]`` normalized,
output ``[B, N, P, P, C]`` in ROI order. Both entry points go through the
one kernel wrapper ``kernels.roi_align.roi_align``, which serves the 1000
proposals at 7x7 and the 100 detections at 14x14 alike.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from maskrcnn_tf2_tpu_torch.kernels.roi_align import roi_align, roi_level_assignment

__all__ = ["roi_level_assignment", "pyramid_roi_align", "pyramid_roi_align_deferred"]


@torch.no_grad()
def pyramid_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    pool_size: int,
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> torch.Tensor:
    """Crop-and-resize each ROI from its assigned FPN level."""
    return roi_align(
        [f.contiguous() for f in features],
        boxes.to(torch.float32).contiguous(),
        pool_size,
        image_shape,
        denominator,
    )


def pyramid_roi_align_deferred(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    pool_size: int,
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(pooled, slot)`` as in the JAX package. The kernel writes in ROI
    order, so ``slot`` is always None: there is no unsort to defer."""
    return pyramid_roi_align(features, boxes, pool_size, image_shape, denominator), None
