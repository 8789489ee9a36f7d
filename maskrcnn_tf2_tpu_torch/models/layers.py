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

Sync-BN (``config.sync_bn``): a ``BatchNorm`` whose ``group`` is a process
group computes its batch statistics across the group's ranks as flax's
``BatchNorm(axis_name=...)`` does: ``mean = pmean(E[x])``, ``mean2 =
pmean(E[x**2])`` (one all-reduce of both, in float32 over the input),
``var = max(mean2 - mean**2, 0)``, and the running statistics take that biased
``var``. The gradient flows through the reduction: the all-reduce's backward
all-reduces the cotangent (psum's transpose is psum), so each rank's input
gradient holds every rank's loss. ``sync_batch_norms_`` gives a module's
batch norms the group.

Tensor parallelism (``parallel/gspmd.py``): ``copy_to_model_group`` before a
column-parallel layer and ``reduce_from_model_group`` after a row-parallel
one carry the model group's two collectives, each differentiable the way its
place needs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.parallel.distributed import sum_over


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


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over a process group, differentiable: the backward sums the
    cotangents of every rank."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModelGroup(torch.autograd.Function):
    """Tensor parallelism's entry (Megatron's ``f``): identity forward; the
    backward sums the cotangent over the model group, since each rank's
    column shard of the next layer sees only its part of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return sum_over(g, ctx.group).to(g.dtype), None


class _ReduceFromModelGroup(torch.autograd.Function):
    """Tensor parallelism's exit (Megatron's ``g``): the partial products of
    a row-parallel layer summed over the model group (float32); the backward
    passes the cotangent on unchanged, since every rank uses the sum whole.
    ``_AllReduceSum`` would sum the cotangent again: k times the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.dtype = x.dtype
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype), None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, group)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Flax ``BatchNorm(momentum=0.9, epsilon=eps)`` over the channel axis of
    ``[N, C]`` or ``[N, C, H, W]``; float32 parameters and statistics. With a
    process group as ``group``, training mode takes cross-replica statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps=eps, momentum=1.0 - FLAX_MOMENTUM)
        self.group = None

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        x32 = x.to(torch.float32)
        local = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
        mean, mean2 = _AllReduceSum.apply(local, self.group) / tdist.get_world_size(self.group)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean.detach() * self.momentum)
            self.running_var.mul_(FLAX_MOMENTUM).add_(var.detach() * self.momentum)
        return y.to(x.dtype)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"expected a 2D or 4D input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if self.group is not None:
            return self._sync_forward(x)
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


def sync_batch_norms_(module: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm`` under ``module`` the process group ``group``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module


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
