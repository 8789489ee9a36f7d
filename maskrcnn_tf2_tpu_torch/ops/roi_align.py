"""Pyramid ROIAlign over channels-last FPN maps, differentiable in the maps.

Counterpart of ``maskrcnn_tf2_tpu/ops/roi_align.py``: maps are
``[B, H_l, W_l, C]`` finest first (P2..P5), boxes ``[B, N, 4]`` normalized,
output ``[B, N, P, P, C]`` in ROI order. Both entry points go through the one
kernel wrapper ``kernels.roi_align.roi_align``, which serves the proposals at
7x7 and the detections or training ROIs at 14x14 alike.

``PyramidRoIAlign`` is the counterpart of the JAX package's custom VJP
``kernels/roi_align_pallas.py::_pyramid_roi_align_pallas``: the forward
kernel, and in the backward ``kernels.roi_align.roi_align_backward``. The
boxes get no gradient (the reference stop-gradients its crop boxes).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from maskrcnn_tf2_tpu_torch.kernels.roi_align import roi_align, roi_align_backward, roi_level_assignment

__all__ = ["roi_level_assignment", "pyramid_roi_align", "pyramid_roi_align_deferred", "PyramidRoIAlign"]


class PyramidRoIAlign(torch.autograd.Function):
    """``apply(boxes, pool_size, image_shape, denominator, *features)``."""

    @staticmethod
    def forward(ctx, boxes, pool_size, image_shape, denominator, *features):
        ctx.save_for_backward(boxes)
        ctx.geometry = ([(f.shape[1], f.shape[2]) for f in features], image_shape, denominator)
        return roi_align(list(features), boxes, pool_size, image_shape, denominator)

    @staticmethod
    def backward(ctx, dout):
        (boxes,) = ctx.saved_tensors
        level_hw, image_shape, denominator = ctx.geometry
        grads = roi_align_backward(dout.contiguous(), boxes, level_hw, image_shape, denominator)
        return (None, None, None, None, *grads)


def pyramid_roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    pool_size: int,
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> torch.Tensor:
    """Crop-and-resize each ROI from its assigned FPN level."""
    return PyramidRoIAlign.apply(
        boxes.detach().to(torch.float32).contiguous(),
        pool_size,
        tuple(image_shape),
        denominator,
        *(f.contiguous() for f in features),
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
