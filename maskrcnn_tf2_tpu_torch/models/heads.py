"""ROI heads: FPN classifier and mask head (counterpart of
``models/heads.py``; the int8 paths are not ported).

Both take pooled features channels-last, ``[B, N, P, P, C]``, as
``ops.roi_align`` returns them. The classifier's first FC consumes the (P, P,
C) flatten order of the JAX package's kernel ``[P*P*C, F]`` unchanged. Given
``class_ids``, the mask head computes only each ROI's GT-class column of its
final 1x1 projection (the JAX package's ``_MaskProj``, the ``mask_train_slim``
training path) and returns ``[B, N, 2P, 2P]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTranspose2d, Linear, SameConv2d, activation


class FPNClassifierHead(nn.Module):
    """Pooled ROIs -> (logits, probs, deltas): FC on the pooled patch (1024) +
    BN + act, FC (1024) + BN + act, then class logits and per-class deltas."""

    def __init__(self, in_channels: int, num_classes: int, pool_size: int = 7,
                 fc_size: int = 1024, leaky_relu: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.act = activation(leaky_relu)
        self.mrcnn_class_conv1 = Linear(pool_size * pool_size * in_channels, fc_size)
        self.mrcnn_class_bn1 = BatchNorm(fc_size)
        self.mrcnn_class_conv2 = Linear(fc_size, fc_size)
        self.mrcnn_class_bn2 = BatchNorm(fc_size)
        self.mrcnn_class_logits = Linear(fc_size, num_classes)
        self.mrcnn_bbox_fc = Linear(fc_size, num_classes * 4)

    def forward(self, roi_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n = roi_features.shape[:2]
        x = roi_features.reshape(b * n, -1)
        x = self.act(self.mrcnn_class_bn1(self.mrcnn_class_conv1(x)))
        x = self.act(self.mrcnn_class_bn2(self.mrcnn_class_conv2(x)))
        logits = self.mrcnn_class_logits(x).reshape(b, n, self.num_classes).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        deltas = self.mrcnn_bbox_fc(x).reshape(b, n, self.num_classes, 4).to(torch.float32)
        return logits, probs, deltas


class FPNMaskHead(nn.Module):
    """Pooled ROIs -> per-class sigmoid masks ``[B, N, 2P, 2P, num_classes]``:
    4x (3x3 conv + BN + act), a 2x2/2 transposed conv + act, a 1x1 conv.
    With ``class_ids [B, N]`` only that class's column: ``[B, N, 2P, 2P]``."""

    def __init__(self, in_channels: int, num_classes: int, conv_channels: int = 256,
                 leaky_relu: bool = False):
        super().__init__()
        self.act = activation(leaky_relu)
        cin = in_channels
        for i in range(1, 5):
            self.add_module(f"mrcnn_mask_conv{i}", SameConv2d(cin, conv_channels, 3))
            self.add_module(f"mrcnn_mask_bn{i}", BatchNorm(conv_channels))
            cin = conv_channels
        self.mrcnn_mask_deconv = ConvTranspose2d(conv_channels, conv_channels, 2, stride=2)
        self.mrcnn_mask = Conv2d(conv_channels, num_classes, 1)

    def forward(self, roi_features: torch.Tensor, class_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, p, _, c = roi_features.shape
        x = roi_features.reshape(b * n, p, p, c).permute(0, 3, 1, 2)
        for i in range(1, 5):
            conv = getattr(self, f"mrcnn_mask_conv{i}")
            bn = getattr(self, f"mrcnn_mask_bn{i}")
            x = self.act(bn(conv(x)))
        x = self.act(self.mrcnn_mask_deconv(x))
        if class_ids is not None:
            cls = class_ids.reshape(b * n).long()
            cols = self.mrcnn_mask.weight[cls, :, 0, 0].to(x.dtype)  # [B*N, C]
            x = torch.einsum("nchw,nc->nhw", x, cols) + self.mrcnn_mask.bias[cls].to(x.dtype)[:, None, None]
            return torch.sigmoid(x.to(torch.float32)).reshape(b, n, 2 * p, 2 * p)
        x = torch.sigmoid(self.mrcnn_mask(x).to(torch.float32))
        return x.permute(0, 2, 3, 1).reshape(b, n, 2 * p, 2 * p, -1)
