"""Region Proposal Network head (counterpart of the dense mode of ``models/rpn.py``).

One weight-shared head over every pyramid level: a 3x3 conv + relu, then the
class and box 1x1 convs applied as one fused conv over the shared feature.
The prediction is permuted to channels-last before the reshape, so anchors
come out row-major per level with ratios fastest, the order of
``ops.anchors``. The slim mode of the JAX package is a TPU rewrite of the
same funnel and is not ported.

With ``quant`` (``config.quant_mode``) the shared 3x3 conv is a quantizable
site (``models/quant.py``) with one ``rpn_conv_shared_x_amax`` for every level:
``calib`` records over all of them, ``int8`` runs the int8 kernel once a
level. The 1x1 predictions stay in floating point.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import Conv2d, SameConv2d
from maskrcnn_tf2_tpu_torch.models.quant import add_site, call_site


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, anchors_per_location: int = 3, conv_channels: int = 512,
                 quant: str = "off"):
        super().__init__()
        self.k = anchors_per_location
        add_site(self, "rpn_conv_shared", quant, SameConv2d, in_channels, conv_channels, 3)
        self.rpn_class_raw = Conv2d(conv_channels, 2 * self.k, 1)
        self.rpn_bbox_pred = Conv2d(conv_channels, 4 * self.k, 1)

    def forward(self, features: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``[B, C, H_l, W_l]`` levels -> ``(logits [B, A, 2], probs [B, A, 2],
        deltas [B, A, 4])``, all float32."""
        k = self.k
        dtype = features[0].dtype
        w = torch.cat([self.rpn_class_raw.weight, self.rpn_bbox_pred.weight], dim=0).to(dtype)
        bias = torch.cat([self.rpn_class_raw.bias, self.rpn_bbox_pred.bias], dim=0).to(dtype)
        logits_all, bbox_all = [], []
        for f in features:
            b = f.shape[0]
            shared = F.relu(call_site(self, "rpn_conv_shared", f))
            pred = F.conv2d(shared, w, bias).permute(0, 2, 3, 1)  # [B, H, W, 6k]
            logits_all.append(pred[..., : 2 * k].reshape(b, -1, 2))
            bbox_all.append(pred[..., 2 * k :].reshape(b, -1, 4))
        rpn_logits = torch.cat(logits_all, dim=1).to(torch.float32)
        rpn_probs = torch.softmax(rpn_logits, dim=-1)
        rpn_bbox = torch.cat(bbox_all, dim=1).to(torch.float32)
        return rpn_logits, rpn_probs, rpn_bbox
