"""Feature Pyramid Network top-down pathway (counterpart of ``models/fpn.py``).

1x1 laterals on C2..C5, nearest 2x upsample + add, 3x3 "SAME" output convs,
and P6 = P5[:, :, ::2, ::2] (flax's 1x1/2 VALID max-pool). NCHW tensors.

With ``quant`` (``config.quant_mode``) the eight convs are quantizable sites
(``models/quant.py``), each with its ``{name}_x_amax``. A C endpoint that
comes pre-quantized (a ``QTensor`` from the backbone's stage-last block) feeds
its lateral with the producer's scale, and the lateral's own amax is not read.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maskrcnn_tf2_tpu_torch.models.layers import Conv2d, SameConv2d
from maskrcnn_tf2_tpu_torch.models.quant import add_site, call_site


class FPN(nn.Module):
    def __init__(self, in_channels: Tuple[int, int, int, int], out_channels: int = 256, quant: str = "off"):
        super().__init__()
        c2, c3, c4, c5 = in_channels

        def site(name, cin, kernel):  # a 1x1 "SAME" conv pads nothing
            add_site(self, name, quant, Conv2d if kernel == 1 else SameConv2d, cin, out_channels, kernel)

        site("fpn_c5p5", c5, 1)
        site("fpn_c4p4", c4, 1)
        site("fpn_c3p3", c3, 1)
        site("fpn_c2p2", c2, 1)
        for name in ("fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"):
            site(name, out_channels, 3)

    def forward(self, endpoints: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Returns ``([P2..P6] for the RPN, [P2..P5] for the heads)``."""
        up = lambda x: F.interpolate(x, scale_factor=2, mode="nearest")
        p5 = call_site(self, "fpn_c5p5", endpoints["C5"])
        p4 = call_site(self, "fpn_c4p4", endpoints["C4"]) + up(p5)
        p3 = call_site(self, "fpn_c3p3", endpoints["C3"]) + up(p4)
        p2 = call_site(self, "fpn_c2p2", endpoints["C2"]) + up(p3)
        p2, p3, p4, p5 = (call_site(self, f"fpn_p{i}", p) for i, p in zip((2, 3, 4, 5), (p2, p3, p4, p5)))
        p6 = p5[:, :, ::2, ::2]
        return [p2, p3, p4, p5, p6], [p2, p3, p4, p5]
