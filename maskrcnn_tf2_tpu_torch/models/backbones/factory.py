"""Backbone factory: name -> module returning C1..C5 (counterpart of
``maskrcnn_tf2_tpu/models/backbones/factory.py``).

The JAX package's 25 keys: the fifteen ResNet-family variants, MobileNet V1
and V2, and EfficientNet B0-B7. Every backbone exposes ``endpoint_channels``,
the widths of C2..C5 that the FPN's laterals take. ``leaky_relu`` reaches the
ResNet family only, as in the JAX package.
"""

from __future__ import annotations

from torch import nn

from maskrcnn_tf2_tpu_torch.models.backbones.efficientnet import EFFICIENTNET_PARAMS, EfficientNet
from maskrcnn_tf2_tpu_torch.models.backbones.mobilenet import MobileNetV1, MobileNetV2
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import RESNET_VARIANTS, ResNet


def backbone_names():
    return sorted(RESNET_VARIANTS) + ["mobilenet", "mobilenetv2"] + sorted(EFFICIENTNET_PARAMS)


def get_backbone(name: str, leaky_relu: bool = False) -> nn.Module:
    name = name.lower()
    if name in RESNET_VARIANTS:
        return ResNet(leaky_relu=leaky_relu, **RESNET_VARIANTS[name])
    if name == "mobilenet":
        return MobileNetV1()
    if name == "mobilenetv2":
        return MobileNetV2()
    if name in EFFICIENTNET_PARAMS:
        width, depth = EFFICIENTNET_PARAMS[name]
        return EfficientNet(width=width, depth=depth)
    raise ValueError(f"unknown backbone '{name}'; available: {backbone_names()}")
