"""Feature Pyramid Network top-down pathway (counterpart of ``models/fpn.py``).

1x1 laterals on C2..C5, nearest 2x upsample + add, 3x3 "SAME" output convs,
and P6 = P5[:, :, ::2, ::2] (flax's 1x1/2 VALID max-pool). NCHW tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import SameConv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Tuple[int, int, int, int], out_channels: int = 256):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        self.fpn_c5p5 = nn.Conv2d(c5, out_channels, 1)
        self.fpn_c4p4 = nn.Conv2d(c4, out_channels, 1)
        self.fpn_c3p3 = nn.Conv2d(c3, out_channels, 1)
        self.fpn_c2p2 = nn.Conv2d(c2, out_channels, 1)
        self.fpn_p2 = SameConv2d(out_channels, out_channels, 3)
        self.fpn_p3 = SameConv2d(out_channels, out_channels, 3)
        self.fpn_p4 = SameConv2d(out_channels, out_channels, 3)
        self.fpn_p5 = SameConv2d(out_channels, out_channels, 3)

    def forward(self, endpoints: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Returns ``([P2..P6] for the RPN, [P2..P5] for the heads)``."""
        up = lambda x: F.interpolate(x, scale_factor=2, mode="nearest")
        p5 = self.fpn_c5p5(endpoints["C5"])
        p4 = self.fpn_c4p4(endpoints["C4"]) + up(p5)
        p3 = self.fpn_c3p3(endpoints["C3"]) + up(p4)
        p2 = self.fpn_c2p2(endpoints["C2"]) + up(p3)
        p2, p3, p4, p5 = self.fpn_p2(p2), self.fpn_p3(p3), self.fpn_p4(p4), self.fpn_p5(p5)
        p6 = p5[:, :, ::2, ::2]
        return [p2, p3, p4, p5, p6], [p2, p3, p4, p5]
