"""ResNet-family backbones (ResNet, SE-ResNet, ResNeXt, SE-ResNeXt, SENet154)
returning C1..C5.

Counterpart of ``maskrcnn_tf2_tpu/models/backbones/resnet.py``: one parametric
residual builder covers the fifteen ResNet-family keys. Module names follow
the flax parameter tree (``stem`` or ``stem1``..``stem3``,
``stage{s}_block{b}``, ``conv1``.., ``downsample``, each a ``conv`` + ``bn``
pair, and ``se`` with ``fc1``/``fc2``) so the weight bridge maps paths one to
one. Tensors are NCHW. Stride-2 layers pad as flax "SAME" does
(``models/layers.py``), the 3x3/2 max-pool pads with -inf, a bottleneck
strides on its 3x3 conv, and a grouped bottleneck groups that conv alone.
Squeeze-excite scales the last conv's batch-norm output, before the residual
add. The space-to-depth stem of the JAX package is a TPU rewrite of the same
7x7 conv and is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import (BatchNorm, Linear, SameConv2d, activation, same_pad,
                                                  squeeze_excite)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = SameConv2d(cin, cout, kernel, stride, bias=False, groups=groups)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class SqueezeExcite(nn.Module):
    """``fc1`` to ``max(c // 16, 1)``, ReLU, ``fc2`` back to ``c``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = Linear(channels, hidden)
        self.fc2 = Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.fc1, self.fc2, F.relu)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, act, use_se: bool = False):
        super().__init__()
        self.act = act
        self.conv1 = ConvBN(cin, features, 3, stride)
        self.conv2 = ConvBN(features, features, 3)
        if use_se:
            self.se = SqueezeExcite(features)
        if cin != features or stride != 1:
            self.downsample = ConvBN(cin, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.act(self.conv1(x)))
        if hasattr(self, "se"):
            y = self.se(y)
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return self.act(y + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, act, use_se: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        self.act = act
        width = int(features * (base_width / 64.0)) * groups
        out = features * 4
        self.conv1 = ConvBN(cin, width, 1)
        self.conv2 = ConvBN(width, width, 3, stride, groups=groups)
        self.conv3 = ConvBN(width, out, 1)
        if use_se:
            self.se = SqueezeExcite(out)
        if cin != out or stride != 1:
            self.downsample = ConvBN(cin, out, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.conv1(x))
        y = self.act(self.conv2(y))
        y = self.conv3(y)
        if hasattr(self, "se"):
            y = self.se(y)
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return self.act(y + shortcut)


class ResNet(nn.Module):
    """``block``: 'basic' | 'bottleneck'; ``stage_sizes``: blocks per stage;
    ``groups``/``base_width``: the bottleneck's grouped 3x3 (ResNeXt);
    ``use_se``: squeeze-excite in every block; ``deep_stem``: SENet154's three
    3x3 convs (to 64, 64 and 128 channels) in place of the 7x7.
    ``endpoint_channels`` are the widths of C2..C5."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic", groups: int = 1, base_width: int = 64,
                 use_se: bool = False, deep_stem: bool = False, leaky_relu: bool = False):
        super().__init__()
        self.act = activation(leaky_relu)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        grouping = {} if block == "basic" else dict(groups=groups, base_width=base_width)
        if deep_stem:
            self.stem1 = ConvBN(3, 64, 3, 2)
            self.stem2 = ConvBN(64, 64, 3)
            self.stem3 = ConvBN(64, 128, 3)
            self.stem_names = ["stem1", "stem2", "stem3"]
            cin = 128
        else:
            self.stem = ConvBN(3, 64, 7, 2)
            self.stem_names = ["stem"]
            cin = 64
        features = 64
        self.stage_names = []
        channels = []
        for s, num_blocks in enumerate(stage_sizes):
            names = []
            for i in range(num_blocks):
                stride = 2 if (i == 0 and s > 0) else 1
                name = f"stage{s + 1}_block{i + 1}"
                self.add_module(name, block_cls(cin, features, stride, self.act, use_se=use_se, **grouping))
                cin = features * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)
            channels.append(cin)
            features *= 2
        self.endpoint_channels = tuple(channels)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        for name in self.stem_names:
            x = self.act(getattr(self, name)(x))
        endpoints = {"C1": x}
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for s, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            endpoints[f"C{s + 2}"] = x
        return endpoints


# name -> constructor kwargs; the JAX package's fifteen ResNet-family keys
RESNET_VARIANTS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block="basic"),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck"),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck"),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck"),
    "seresnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic", use_se=True),
    "seresnet34": dict(stage_sizes=(3, 4, 6, 3), block="basic", use_se=True),
    "seresnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck", use_se=True),
    "seresnet101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck", use_se=True),
    "seresnet152": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck", use_se=True),
    "resnext50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck", groups=32, base_width=4),
    "resnext101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck", groups=32, base_width=4),
    "seresnext50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck", groups=32, base_width=4, use_se=True),
    "seresnext101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck", groups=32, base_width=4, use_se=True),
    "senet154": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck", groups=64, base_width=4, use_se=True,
                     deep_stem=True),
}
