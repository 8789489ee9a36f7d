"""Proposal generation: exact top-k scored anchors -> delta decode -> clip -> NMS.

Counterpart of the dense ``generate_proposals`` in
``maskrcnn_tf2_tpu/ops/proposal.py``, batched over images (one NMS launch for
the batch). The top-k is exact and breaks ties by lowest index, as
``lax.top_k`` does; the binned top-k of the JAX package is a TPU rewrite.
Scores, deltas and boxes are float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from maskrcnn_tf2_tpu_torch.ops.boxes import apply_box_deltas, clip_boxes
from maskrcnn_tf2_tpu_torch.ops.nms import nms_padded_boxes
from maskrcnn_tf2_tpu_torch.utils import profiling

# Clamp log-size deltas before exp so an untrained RPN cannot produce inf
# boxes (detectron's BBOX_XFORM_CLIP = log(1000/16)).
DELTA_CLIP = 4.135166556742356


def top_k_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-``k`` along the last axis, ties by lowest index."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
def generate_proposals(
    rpn_probs: torch.Tensor,  # [B, A, 2] (bg, fg) softmax
    rpn_deltas: torch.Tensor,  # [B, A, 4]
    anchors: torch.Tensor,  # [A, 4] normalized
    rpn_bbox_std: Sequence[float],
    pre_nms_limit: int,
    proposal_count: int,
    nms_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(proposals [B, proposal_count, 4] normalized, zero-padded,
    valid [B, proposal_count] bool)``."""
    scores = rpn_probs[..., 1].to(torch.float32)
    profiling.host_sync(scores.device)  # the constant below, copied from the host
    std = torch.tensor(rpn_bbox_std, dtype=torch.float32, device=scores.device)
    deltas = rpn_deltas.to(torch.float32) * std
    pre = min(pre_nms_limit, scores.shape[1])
    top_scores, top_idx = top_k_stable(scores, pre)
    idx4 = top_idx[..., None].expand(-1, -1, 4)
    top_deltas = torch.gather(deltas, 1, idx4)
    top_anchors = anchors.to(torch.float32)[top_idx]
    top_deltas = torch.clamp(top_deltas, -DELTA_CLIP, DELTA_CLIP)
    boxes = apply_box_deltas(top_anchors, top_deltas)
    boxes = clip_boxes(boxes, [0.0, 0.0, 1.0, 1.0])
    out_boxes, _, out_valid = nms_padded_boxes(
        boxes, top_scores, proposal_count, nms_threshold, presorted=True
    )
    return out_boxes, out_valid
