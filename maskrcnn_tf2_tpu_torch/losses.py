"""The five Mask R-CNN losses and the size-normalized L2 term (counterpart of
``maskrcnn_tf2_tpu/losses.py``).

Every loss computes in float32 whatever the compute dtype; an empty selection
gives 0 through a masked mean. The JAX package's one-hot contractions that
pick a class channel are plain gathers here (the same values: the one-hot
weights are 0 and 1).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import torch
from torch import nn

_EPS = 1e-7
_BN = nn.modules.batchnorm._BatchNorm


def smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    diff = torch.abs(diff)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(torch.float32)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def rpn_class_loss(rpn_logits: torch.Tensor, rpn_match: torch.Tensor) -> torch.Tensor:
    """Objectness cross-entropy over non-neutral anchors. ``[B, A, 2]``, ``[B, A]``."""
    anchor_class = (rpn_match == 1).to(torch.float32)
    logp = torch.log_softmax(rpn_logits.to(torch.float32), dim=-1)
    ce = -(anchor_class * logp[..., 1] + (1.0 - anchor_class) * logp[..., 0])
    return _masked_mean(ce, rpn_match != 0)


def rpn_bbox_loss(rpn_deltas_pred: torch.Tensor, target_deltas: torch.Tensor, rpn_match: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 over positive anchors. ``[B, A, 4]``, ``[B, A, 4]``, ``[B, A]``."""
    loss = torch.sum(
        smooth_l1(rpn_deltas_pred.to(torch.float32) - target_deltas.to(torch.float32)), dim=-1
    ) / 4.0
    return _masked_mean(loss, rpn_match == 1)


def mrcnn_class_loss(logits: torch.Tensor, target_class_ids: torch.Tensor, active_class_ids: torch.Tensor) -> torch.Tensor:
    """Cross-entropy, erased where the predicted class is inactive in the
    image's dataset; mean over the rest with an epsilon guard.
    ``[B, T, C]``, ``[B, T]``, ``[B, C]``."""
    logits = logits.to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, target_class_ids.long()[..., None])[..., 0]
    pred_class = torch.argmax(logits, dim=-1)
    pred_active = torch.gather(active_class_ids.to(torch.float32), 1, pred_class)
    return torch.sum(ce * pred_active) / (torch.sum(pred_active) + _EPS)


def mrcnn_bbox_loss(deltas_pred: torch.Tensor, target_deltas: torch.Tensor, target_class_ids: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 at the GT class's deltas of positive ROIs.
    ``[B, T, C, 4]``, ``[B, T, 4]``, ``[B, T]``."""
    cls = target_class_ids.long()
    picked = torch.gather(deltas_pred.to(torch.float32), 2, cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    loss = torch.mean(smooth_l1(picked - target_deltas.to(torch.float32)), dim=-1)
    return _masked_mean(loss, cls > 0)


def mrcnn_mask_loss(masks_pred: torch.Tensor, target_masks: torch.Tensor, target_class_ids: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on the GT class's mask of positive ROIs.

    ``masks_pred``: sigmoid probabilities ``[B, K, H, W, C]``, or ``[B, K, H,
    W]`` when the head already took the GT class's channel; K may be fewer
    than the T target slots (positives come first).
    """
    k = masks_pred.shape[1]
    cls = target_class_ids[:, :k].long()
    target_masks = target_masks[:, :k]
    if masks_pred.dim() == 4:
        picked = masks_pred.to(torch.float32)
    else:
        b, _, h, w, _ = masks_pred.shape
        picked = torch.gather(masks_pred.to(torch.float32), 4,
                              cls[..., None, None, None].expand(b, k, h, w, 1))[..., 0]
    # jnp.clip's gradient: a sigmoid saturated exactly onto a bound passes
    # half (min/max split ties), where torch.clamp would pass all of it
    lo, hi = picked.new_tensor(_EPS), picked.new_tensor(1.0 - _EPS)
    picked = torch.minimum(torch.maximum(picked, lo), hi)
    target = target_masks.to(torch.float32)
    bce = -(target * torch.log(picked) + (1.0 - target) * torch.log(1.0 - picked))
    bce = torch.mean(bce, dim=(-1, -2))
    return _masked_mean(bce, cls > 0)


def batchnorm_module_paths(model: nn.Module) -> FrozenSet[str]:
    """Names of the model's batch-norm modules (the precise set for
    ``l2_reg_loss``; a name that merely contains "bn" is not one)."""
    return frozenset(name for name, m in model.named_modules() if isinstance(m, _BN))


def l2_reg_loss(
    model: nn.Module,
    weight_decay: float,
    include_batchnorm: bool = False,
    skip_prefixes: Tuple[str, ...] = (),
) -> torch.Tensor:
    """``weight_decay * sum over weight tensors of mean(square(w))``, skipping
    batch-norm scale and bias unless ``include_batchnorm``, every bias, and
    the top-level modules in ``skip_prefixes`` (frozen ones). One term per
    parameter: the port's parameters are one to one with the flax leaves."""
    bn_paths = batchnorm_module_paths(model)
    total = None
    for name, param in model.named_parameters():
        module_path, _, leaf = name.rpartition(".")
        if module_path.split(".")[0] in skip_prefixes:
            continue
        if not include_batchnorm and module_path in bn_paths:
            continue
        if leaf == "bias":
            continue
        term = torch.mean(torch.square(param.to(torch.float32)))
        total = term if total is None else total + term
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=next(model.parameters()).device)
    return weight_decay * total


def compute_losses(
    outputs: Dict[str, torch.Tensor],
    rpn_match: torch.Tensor,
    rpn_target_deltas: torch.Tensor,
    active_class_ids: torch.Tensor,
    config,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted total of the five losses with the reference's mode switches:
    ``use_rpn_rois=False`` drops the RPN losses, ``tune_rpn_model_only`` keeps
    only them."""
    w = config.loss_weights
    losses: Dict[str, torch.Tensor] = {}
    if config.use_rpn_rois or config.tune_rpn_model_only:
        losses["rpn_class_loss"] = w[0] * rpn_class_loss(outputs["rpn_logits"], rpn_match)
        losses["rpn_bbox_loss"] = w[1] * rpn_bbox_loss(outputs["rpn_bbox"], rpn_target_deltas, rpn_match)
    if not config.tune_rpn_model_only:
        losses["mrcnn_class_loss"] = w[2] * mrcnn_class_loss(
            outputs["mrcnn_class_logits"], outputs["target_class_ids"], active_class_ids)
        losses["mrcnn_bbox_loss"] = w[3] * mrcnn_bbox_loss(
            outputs["mrcnn_deltas"], outputs["target_deltas"], outputs["target_class_ids"])
        losses["mrcnn_mask_loss"] = w[4] * mrcnn_mask_loss(
            outputs["mrcnn_masks"], outputs["target_masks"], outputs["target_class_ids"])
    total = sum(losses.values())
    losses["loss_sum"] = total
    return total, losses
