"""EfficientNet B0-B7 backbones returning C1..C5 (counterpart of
``maskrcnn_tf2_tpu/models/backbones/efficientnet.py``; the port keeps its own
copies of ``EFFICIENTNET_PARAMS``, ``_BLOCK_ARGS``, ``round_filters`` and
``round_repeats``).

The compound-scaling recipe: a 3x3/2 ``stem``, then MBConv blocks numbered
globally ``block0``.. (``expand`` when the ratio is not 1, a depthwise ``dw``
of 3x3 or 5x5, squeeze-excite ``se_reduce``/``se_expand``, ``project``
without an activation, the input added when the stride is 1 and the width
unchanged), swish after every other batch norm, batch-norm epsilon 1e-3.
C1..C5 are taken by stride as in MobileNet V2; there is no head conv.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.models.backbones.mobilenet import (add_conv_bn, channels_by_stride, conv_bn,
                                                               endpoints_by_stride)
from maskrcnn_tf2_tpu_torch.models.layers import Linear, squeeze_excite, swish

# (width_coefficient, depth_coefficient)
EFFICIENTNET_PARAMS = {
    "efficientnetb0": (1.0, 1.0),
    "efficientnetb1": (1.0, 1.1),
    "efficientnetb2": (1.1, 1.2),
    "efficientnetb3": (1.2, 1.4),
    "efficientnetb4": (1.4, 1.8),
    "efficientnetb5": (1.6, 2.2),
    "efficientnetb6": (1.8, 2.6),
    "efficientnetb7": (2.0, 3.1),
}

# (kernel, stride, expand, features, repeats)
_BLOCK_ARGS = [
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
]


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


class MBConv(nn.Module):
    def __init__(self, cin: int, kernel: int, stride: int, expand: int, features: int, se_ratio: float = 0.25):
        super().__init__()
        self.stride, self.out_channels = stride, features
        self.has_expand = expand != 1
        mid = cin * expand
        if self.has_expand:
            add_conv_bn(self, "expand", cin, mid, 1)
        add_conv_bn(self, "dw", mid, mid, kernel, stride, groups=mid)
        se_ch = max(1, int(cin * se_ratio))  # counts the block's input channels, not the expanded ones
        self.se_reduce = Linear(mid, se_ch)
        self.se_expand = Linear(se_ch, mid)
        add_conv_bn(self, "project", mid, features, 1)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_bn(self, "expand", x, act=swish) if self.has_expand else x
        y = conv_bn(self, "dw", y, act=swish)
        y = squeeze_excite(y, self.se_reduce, self.se_expand, swish)
        y = conv_bn(self, "project", y, act=None)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    def __init__(self, width: float = 1.0, depth: float = 1.0):
        super().__init__()
        self.width, self.depth = width, depth
        stem = round_filters(32, width)
        add_conv_bn(self, "stem", 3, stem, 3, 2)
        self.blocks: List[str] = []
        cin = stem
        for kernel, first_stride, expand, features, repeats in _BLOCK_ARGS:
            features = round_filters(features, width)
            for r in range(round_repeats(repeats, depth)):
                name = f"block{len(self.blocks)}"
                self.add_module(name, MBConv(cin, kernel, first_stride if r == 0 else 1, expand, features))
                self.blocks.append(name)
                cin = features
        self.endpoint_channels = channels_by_stride(stem, [getattr(self, n) for n in self.blocks])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = conv_bn(self, "stem", x, act=swish)
        return endpoints_by_stride(x, [getattr(self, n) for n in self.blocks])
