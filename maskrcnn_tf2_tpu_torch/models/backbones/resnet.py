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

``quant`` (``config.quant_mode``, ``models/quant.py``) makes every block conv
a quantizable site with its ``x_amax``; the stem stays in floating point. The
quantized residual stream: a block's output, quantized once against its
``out_amax``, reaches the next block as a ``QTensor``, whose ``conv1`` and
``downsample`` take it as it is and whose identity shortcut adds it
dequantized. ``calib`` records ``out_amax`` for every block. In ``int8`` a
block emits a ``QTensor`` when ``MASKRCNN_TPU_INT8_QRES`` is not ``0`` and it
is not its stage's last, or, for a stage's last block (the C endpoints),
when ``MASKRCNN_TPU_INT8_QC`` is not ``0`` either; a block whose
``out_amax`` the loaded ``state_dict`` lacks (a calibration from before the
residual stream) keeps its floating-point output, and leaves ``out_amax``
out of its own ``state_dict``.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import (BatchNorm, Linear, SameConv2d, activation, same_pad,
                                                  squeeze_excite)
from maskrcnn_tf2_tpu_torch.models.quant import QTensor, add_amax, add_site, call_site, quantize_input, record_amax_


def _qres_on() -> bool:
    return os.environ.get("MASKRCNN_TPU_INT8_QRES", "1") != "0"


def _qc_on() -> bool:
    return _qres_on() and os.environ.get("MASKRCNN_TPU_INT8_QC", "1") != "0"


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1, quant: str = "off"):
        super().__init__()
        add_site(self, "conv", quant, SameConv2d, cin, cout, kernel, stride, bias=False, groups=groups, amax="x_amax")
        self.bn = BatchNorm(cout)

    def forward(self, x) -> torch.Tensor:
        return self.bn(call_site(self, "conv", x))


class _Block(nn.Module):
    """The quantized residual stream's bookkeeping of a block's output."""

    def _init_quant(self, quant: str) -> None:
        self.quant = quant
        if quant != "off":
            add_amax(self, "out_amax")

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.quant == "int8":  # a calibration without out_amax keeps the float edge
            if prefix + "out_amax" in state_dict:
                self._non_persistent_buffers_set.discard("out_amax")
            else:
                self._non_persistent_buffers_set.add("out_amax")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _out(self, out: torch.Tensor, emit_q: bool):
        if not emit_q:
            return out
        if self.quant == "calib":
            record_amax_(self.out_amax, out)
            return out
        if "out_amax" in self._non_persistent_buffers_set:
            return out
        xq, s = quantize_input(out, self.out_amax)
        return QTensor(xq, s, out.dtype)

    @staticmethod
    def _identity(x) -> torch.Tensor:
        return x.dequantize() if isinstance(x, QTensor) else x


class SqueezeExcite(nn.Module):
    """``fc1`` to ``max(c // 16, 1)``, ReLU, ``fc2`` back to ``c``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = Linear(channels, hidden)
        self.fc2 = Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.fc1, self.fc2, F.relu)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, act, use_se: bool = False, quant: str = "off"):
        super().__init__()
        self.act = act
        self._init_quant(quant)
        self.conv1 = ConvBN(cin, features, 3, stride, quant=quant)
        self.conv2 = ConvBN(features, features, 3, quant=quant)
        if use_se:
            self.se = SqueezeExcite(features)
        if cin != features or stride != 1:
            self.downsample = ConvBN(cin, features, 1, stride, quant=quant)

    def forward(self, x, emit_q: bool = False):
        y = self.conv2(self.act(self.conv1(x)))
        if hasattr(self, "se"):
            y = self.se(y)
        shortcut = self.downsample(x) if hasattr(self, "downsample") else self._identity(x)
        return self._out(self.act(y + shortcut), emit_q)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, act, use_se: bool = False, groups: int = 1,
                 base_width: int = 64, quant: str = "off"):
        super().__init__()
        self.act = act
        self._init_quant(quant)
        width = int(features * (base_width / 64.0)) * groups
        out = features * 4
        self.conv1 = ConvBN(cin, width, 1, quant=quant)
        self.conv2 = ConvBN(width, width, 3, stride, groups=groups, quant=quant)
        self.conv3 = ConvBN(width, out, 1, quant=quant)
        if use_se:
            self.se = SqueezeExcite(out)
        if cin != out or stride != 1:
            self.downsample = ConvBN(cin, out, 1, stride, quant=quant)

    def forward(self, x, emit_q: bool = False):
        y = self.act(self.conv1(x))
        y = self.act(self.conv2(y))
        y = self.conv3(y)
        if hasattr(self, "se"):
            y = self.se(y)
        shortcut = self.downsample(x) if hasattr(self, "downsample") else self._identity(x)
        return self._out(self.act(y + shortcut), emit_q)


class ResNet(nn.Module):
    """``block``: 'basic' | 'bottleneck'; ``stage_sizes``: blocks per stage;
    ``groups``/``base_width``: the bottleneck's grouped 3x3 (ResNeXt);
    ``use_se``: squeeze-excite in every block; ``deep_stem``: SENet154's three
    3x3 convs (to 64, 64 and 128 channels) in place of the 7x7.
    ``endpoint_channels`` are the widths of C2..C5. ``quant``: the blocks'
    convs only; in ``int8`` C2..C5 may come out as ``QTensor``s."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "basic", groups: int = 1, base_width: int = 64,
                 use_se: bool = False, deep_stem: bool = False, leaky_relu: bool = False, quant: str = "off"):
        super().__init__()
        self.act = activation(leaky_relu)
        self.quant = quant
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
                self.add_module(name, block_cls(cin, features, stride, self.act, use_se=use_se, quant=quant,
                                                **grouping))
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
        qres = self.quant == "calib" or (self.quant == "int8" and _qres_on())
        qc = self.quant == "calib" or (self.quant == "int8" and _qc_on())
        for s, names in enumerate(self.stage_names):
            for i, name in enumerate(names):
                last = i == len(names) - 1
                x = getattr(self, name)(x, emit_q=(qres and not last) or (qc and last))
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
