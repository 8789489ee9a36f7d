"""MobileNet V1/V2 backbones returning C1..C5 (counterpart of
``maskrcnn_tf2_tpu/models/backbones/mobilenet.py``).

Every conv is a "SAME" conv without bias followed by a batch norm with
epsilon 1e-3, named ``{site}_conv`` / ``{site}_bn`` as in the flax tree; the
depthwise convs group by their channel count. NCHW tensors.

- ``MobileNetV1``: ``stem`` and ``b1``..``b13``, each a depthwise site
  ``b{i}_dw`` and a pointwise ``b{i}_pw``, relu6 after every batch norm. C1 is
  taken after ``b1`` (stride 2), C2..C5 after ``b3``, ``b5``, ``b11``, ``b13``.
- ``MobileNetV2``: ``stem`` and ``block0``..``block16`` inverted residuals
  (``expand`` when the ratio is not 1, ``dw``, then ``project`` without an
  activation; the input is added when the stride is 1 and the width is
  unchanged). C1..C5 are the inputs of the stride-2 blocks and the last
  block's output; the classifier's 1280-wide head conv is not built.

``quant`` (``config.quant_mode``) makes every block's conv a quantizable
site (``models/quant.py::add_site``: depthwise ones record in ``calib`` and
stay in floating point in ``int8`` unless ``MASKRCNN_TPU_INT8_DW=1``), its
amax ``{site}_x_amax`` beside it; the stem stays in floating point.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import BatchNorm, SameConv2d, relu6
from maskrcnn_tf2_tpu_torch.models.quant import add_site, call_site

BN_EPS = 1e-3


def add_conv_bn(module: nn.Module, name: str, cin: int, cout: int, kernel: int, stride: int = 1,
                groups: int = 1, quant: str = "off") -> None:
    """Register ``{name}_conv`` and ``{name}_bn`` on ``module``, and with
    ``quant`` the site's ``{name}_x_amax``."""
    add_site(module, f"{name}_conv", quant, SameConv2d, cin, cout, kernel, stride, bias=False, groups=groups,
             amax=f"{name}_x_amax", dw_switch=True)
    module.add_module(f"{name}_bn", BatchNorm(cout, eps=BN_EPS))


def conv_bn(module: nn.Module, name: str, x: torch.Tensor, act=relu6) -> torch.Tensor:
    x = call_site(module, f"{name}_conv", x)
    x = getattr(module, f"{name}_bn")(x)
    return act(x) if act is not None else x


def endpoints_by_stride(x: torch.Tensor, blocks: List[nn.Module]) -> Dict[str, torch.Tensor]:
    """Run ``blocks`` (each with a ``stride``) from a stride-2 ``x``: C1..C4
    are the inputs of the stride-2 blocks, C5 the last output."""
    endpoints = []
    for block in blocks:
        if block.stride == 2:
            endpoints.append(x)
        x = block(x)
    endpoints.append(x)
    return {f"C{i + 1}": e for i, e in enumerate(endpoints)}


def channels_by_stride(cin: int, blocks: List[nn.Module]) -> tuple:
    """The widths of C2..C5 that ``endpoints_by_stride`` returns."""
    widths = []
    for block in blocks:
        if block.stride == 2:
            widths.append(cin)
        cin = block.out_channels
    return tuple(widths[1:] + [cin])


class MobileNetV1(nn.Module):
    # (features, stride) of b1..b13, and the blocks whose outputs are C1..C5
    PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    ENDPOINTS = (1, 3, 5, 11, 13)

    def __init__(self, alpha: float = 1.0, quant: str = "off"):
        super().__init__()
        self.alpha = alpha

        def c(ch):
            return max(8, int(ch * alpha))

        add_conv_bn(self, "stem", 3, c(32), 3, 2)
        cin = c(32)
        for i, (features, stride) in enumerate(self.PLAN, start=1):
            add_conv_bn(self, f"b{i}_dw", cin, cin, 3, stride, groups=cin, quant=quant)
            add_conv_bn(self, f"b{i}_pw", cin, c(features), 1, quant=quant)
            cin = c(features)
        self.endpoint_channels = tuple(c(self.PLAN[i - 1][0]) for i in self.ENDPOINTS[1:])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = conv_bn(self, "stem", x)
        endpoints = {}
        for i in range(1, len(self.PLAN) + 1):
            x = conv_bn(self, f"b{i}_pw", conv_bn(self, f"b{i}_dw", x))
            if i in self.ENDPOINTS:
                endpoints[f"C{len(endpoints) + 1}"] = x
        return endpoints


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, expand: int = 6, quant: str = "off"):
        super().__init__()
        self.stride, self.out_channels = stride, features
        self.has_expand = expand != 1
        mid = cin * expand
        if self.has_expand:
            add_conv_bn(self, "expand", cin, mid, 1, quant=quant)
        add_conv_bn(self, "dw", mid, mid, 3, stride, groups=mid, quant=quant)
        add_conv_bn(self, "project", mid, features, 1, quant=quant)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self, "expand", x) if self.has_expand else x
        y = conv_bn(self, "project", conv_bn(self, "dw", y), act=None)
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    # (expand, features, repeats, first stride)
    SCHEDULE = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                (6, 320, 1, 1)]

    def __init__(self, alpha: float = 1.0, quant: str = "off"):
        super().__init__()
        self.alpha = alpha

        def c(ch):
            return max(8, int(ch * alpha + 4) // 8 * 8)

        add_conv_bn(self, "stem", 3, c(32), 3, 2)
        self.blocks: List[str] = []
        cin = c(32)
        for expand, features, repeats, first_stride in self.SCHEDULE:
            for r in range(repeats):
                name = f"block{len(self.blocks)}"
                self.add_module(name, InvertedResidual(cin, c(features), first_stride if r == 0 else 1, expand,
                                                       quant=quant))
                self.blocks.append(name)
                cin = c(features)
        self.endpoint_channels = channels_by_stride(c(32), [getattr(self, n) for n in self.blocks])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return endpoints_by_stride(conv_bn(self, "stem", x), [getattr(self, n) for n in self.blocks])
