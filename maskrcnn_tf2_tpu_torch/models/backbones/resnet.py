"""Plain ResNet backbones (resnet18/34/50/101/152) returning C1..C5.

Counterpart of ``maskrcnn_tf2_tpu/models/backbones/resnet.py`` for the plain
variants. Module names follow the flax parameter tree (``stem``,
``stage{s}_block{b}``, ``conv1``.., ``downsample``, each a ``conv`` + ``bn``
pair) so the weight bridge maps paths one to one. Tensors are NCHW. Stride-2
layers pad as flax "SAME" does (``models/layers.py``), the 3x3/2 max-pool
pads with -inf, and a bottleneck strides on its 3x3 conv. The space-to-depth
stem of the JAX package is a TPU rewrite of the same 7x7 conv and is not
ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import SameConv2d, activation, batch_norm, same_pad


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.conv = SameConv2d(cin, cout, kernel, stride, bias=False)
        self.bn = batch_norm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, act):
        super().__init__()
        self.act = act
        self.conv1 = ConvBN(cin, features, 3, stride)
        self.conv2 = ConvBN(features, features, 3)
        if cin != features or stride != 1:
            self.downsample = ConvBN(cin, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.act(self.conv1(x)))
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return self.act(y + shortcut)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, act):
        super().__init__()
        self.act = act
        out = features * 4
        self.conv1 = ConvBN(cin, features, 1)
        self.conv2 = ConvBN(features, features, 3, stride)
        self.conv3 = ConvBN(features, out, 1)
        if cin != out or stride != 1:
            self.downsample = ConvBN(cin, out, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.conv1(x))
        y = self.act(self.conv2(y))
        y = self.conv3(y)
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        return self.act(y + shortcut)


class ResNet(nn.Module):
    """``block``: 'basic' | 'bottleneck'; ``stage_sizes``: blocks per stage."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic", leaky_relu: bool = False):
        super().__init__()
        self.act = activation(leaky_relu)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.stem = ConvBN(3, 64, 7, 2)
        cin, features = 64, 64
        self.stage_names = []
        for s, num_blocks in enumerate(stage_sizes):
            names = []
            for i in range(num_blocks):
                stride = 2 if (i == 0 and s > 0) else 1
                name = f"stage{s + 1}_block{i + 1}"
                self.add_module(name, block_cls(cin, features, stride, self.act))
                cin = features * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)
            features *= 2
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.act(self.stem(x))
        endpoints = {"C1": x}
        x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        for s, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            endpoints[f"C{s + 2}"] = x
        return endpoints


RESNET_VARIANTS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block="basic"),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck"),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck"),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck"),
}
