"""Backbone factory: name -> module returning C1..C5.

The port has the plain ResNets so far. The JAX package's other keys (SE and
ResNeXt variants, SENet154, MobileNet V1/V2, EfficientNet B0-B7) are queued
in ROADMAP.md and raise here by name.
"""

from __future__ import annotations

from torch import nn

from maskrcnn_tf2_tpu_torch.models.backbones.resnet import RESNET_VARIANTS, ResNet


def backbone_names():
    return sorted(RESNET_VARIANTS)


def get_backbone(name: str, leaky_relu: bool = False) -> nn.Module:
    name = name.lower()
    if name in RESNET_VARIANTS:
        return ResNet(leaky_relu=leaky_relu, **RESNET_VARIANTS[name])
    raise ValueError(
        f"backbone '{name}' is not ported to PyTorch yet; the port has "
        f"{backbone_names()} (the rest of the zoo is queued in ROADMAP.md)"
    )
