"""Convolution helpers with TF "SAME" padding.

Flax pads a stride-2 convolution at an even input size asymmetrically: (2, 3)
for the 7x7 stem, (0, 1) for a 3x3 and 1x1 nothing. PyTorch's ``padding=k//2``
is symmetric and shifts every stride-2 output by a pixel, so the port pads
explicitly with ``same_pad`` before an unpadded convolution.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pad_amounts(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` as TF/flax "SAME" would before a ``kernel``/``stride`` window."""
    top, bottom = same_pad_amounts(x.shape[2], kernel, stride)
    left, right = same_pad_amounts(x.shape[3], kernel, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding (square kernel and stride)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, bias=True):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, self.kernel_size[0], self.stride[0]))


def batch_norm(channels: int, dims: int = 2) -> nn.Module:
    """Flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``: torch momentum 0.1."""
    cls = nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d
    return cls(channels, eps=1e-5, momentum=0.1)


def activation(leaky: bool):
    return (lambda v: F.leaky_relu(v, 0.2)) if leaky else F.relu
