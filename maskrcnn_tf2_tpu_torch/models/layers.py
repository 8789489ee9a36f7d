"""Layers with flax's semantics: "SAME" padding, cast at use, batch norm.

Flax pads a stride-2 convolution at an even input size asymmetrically: (2, 3)
for the 7x7 stem, (0, 1) for a 3x3 and 1x1 nothing. PyTorch's ``padding=k//2``
is symmetric and shifts every stride-2 output by a pixel, so the port pads
explicitly with ``same_pad`` before an unpadded convolution.

Parameters are float32 master weights, as in the JAX package; ``Conv2d``,
``ConvTranspose2d`` and ``Linear`` cast their weight and bias to the input's
dtype at use (``compute_dtype``), so gradients and optimizer updates stay
float32. Casting a tensor to its own dtype is free, which a serving copy
with its weights already in the compute dtype uses (``MaskRCNN.cast_for_serving_``).

``BatchNorm`` is flax's ``BatchNorm(momentum=0.9, epsilon=eps)`` (1e-5 in the
ResNet family, 1e-3 in MobileNet and EfficientNet, as in the JAX package): in
training mode it normalizes with the biased batch variance and updates
``running = 0.9 * running + 0.1 * batch`` with that biased variance (torch's
own module would use the unbiased one); statistics are float32 over a bf16
input. ``module.train(mode)`` is the ``train_bn`` switch.
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


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its parameters to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class SameConv2d(Conv2d):
    """``Conv2d`` with flax's "SAME" padding (square kernel and stride);
    ``groups`` as flax's ``feature_group_count`` (``groups == in_channels``
    is a depthwise convolution)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, bias=True, groups=1):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding=0, bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(same_pad(x, self.kernel_size[0], self.stride[0]))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no output padding) that casts its parameters
    to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
                                  self.stride, self.padding, 0, self.groups, self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` that casts its parameters to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


FLAX_MOMENTUM = 0.9


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Flax ``BatchNorm(momentum=0.9, epsilon=eps)`` over the channel axis of
    ``[N, C]`` or ``[N, C, H, W]``; float32 parameters and statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps, momentum=1.0 - FLAX_MOMENTUM)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2D or 4D input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        # momentum 1 writes the batch's mean and unbiased variance into the
        # scratch statistics; the normalization itself uses the biased one
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean * self.momentum)
            self.running_var.mul_(FLAX_MOMENTUM).add_(var * ((n - 1) / n) * self.momentum)
        return y


def activation(leaky: bool):
    return (lambda v: F.leaky_relu(v, 0.2)) if leaky else F.relu


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu6``: hardtanh, whose gradient is 0 at both 0 and 6 as
    JAX's is (``torch.clamp`` would pass it at its bounds, and a bf16
    network meets 6.0 exactly)."""
    return F.relu6(x)


swish = F.silu


def squeeze_excite(x: torch.Tensor, reduce: nn.Module, expand: nn.Module, act) -> torch.Tensor:
    """Channel attention as the JAX package computes it: the spatial mean in
    float32, the two dense layers (``reduce``, ``act``, ``expand``) in the
    compute dtype, the sigmoid in float32, then ``x`` scaled per channel."""
    s = x.to(torch.float32).mean((2, 3)).to(x.dtype)
    s = expand(act(reduce(s)))
    return x * torch.sigmoid(s.to(torch.float32)).to(x.dtype)[:, :, None, None]
