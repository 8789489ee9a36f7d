"""The single-device training and evaluation steps (counterpart of
``maskrcnn_tf2_tpu/train/train_step.py``).

One step: RPN targets on the device, the forward with ``train=True``
(detection targets, both ROIAlign kernels through their autograd Function),
the five losses plus the size-normalized L2 term, the backward, the optimizer
update and the non-finite guard. Where the JAX package returns a new
immutable state, the port updates the model's parameters, its batch-norm
statistics and the optimizer state in place and returns the same
``TrainState`` with its step advanced. The guard reads the loss on the host
(one synchronisation per step) and, when it fails, restores the batch-norm
statistics and leaves the parameters and the optimizer state as they were.

Randomness: a step's uniform draws (``ops.targets.draw_uniforms``) come
from the ``torch.Generator`` passed as ``rng``; a caller may pass the draws
themselves as ``draws`` instead, as the parity tests do with JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.losses import compute_losses, l2_reg_loss
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.ops.augment import device_augment
from maskrcnn_tf2_tpu_torch.ops.image import parse_image_meta
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms, rpn_targets
from maskrcnn_tf2_tpu_torch.train.optimizer import OptState, build_optimizer
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

Batch = Mapping[str, torch.Tensor]
_BN = torch.nn.modules.batchnorm._BatchNorm


@dataclass
class TrainState:
    step: int
    model: MaskRCNN  # float32 parameters and batch-norm statistics
    opt_state: OptState


def create_train_state(config: MaskRCNNConfig, rng: torch.Generator, device: DeviceLike = None) -> TrainState:
    """A model with seeded random weights (``weights.lecun_init_``, drawn on
    the CPU from ``rng``) and a fresh optimizer state. Load other weights
    with ``state.model.load_state_dict`` before the first step."""
    if config.backbone_init_weights not in (None, "", "none", "random"):
        raise ValueError("pretrained backbone weights are not ported yet: load them with "
                         "weights.flax_to_state_dict and state.model.load_state_dict")
    model = lecun_init_(MaskRCNN(config, device=device), rng)
    return TrainState(0, model, build_optimizer(config).init(list(model.parameters())))


def _frozen_prefixes(config: MaskRCNNConfig):
    return tuple(name for flag, name in [
        (config.frozen_backbone, "backbone"),
        (config.frozen_rpn_model, "rpn"),
        (config.frozen_cls_head, "classifier"),
        (config.frozen_mask_head, "mask_head"),
    ] if flag)


def _bn_stats(model: MaskRCNN) -> List[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, _BN) for t in (m.running_mean, m.running_var)]


def _loss(model: MaskRCNN, batch: Batch, draws: Mapping[str, torch.Tensor], config: MaskRCNNConfig,
          augment: bool = False):
    """Total loss and the named losses (``l2_loss`` among them). ``augment``
    (the training step's) applies ``device_augment`` first when the config
    asks for it, before the RPN targets, as the JAX step does."""
    if augment and config.augment_on_device:
        batch = device_augment(batch, draws, flip=config.augment_flip, scale_jitter=config.augment_scale_jitter,
                               photometric=config.augment_photometric)
    rpn = rpn_targets(model.anchors, batch["gt_class_ids"], batch["gt_boxes"], draws["rpn_pos"],
                      draws["rpn_neg"], config.rpn_train_anchors_per_image, config.rpn_bbox_std_dev)
    outputs = model(batch["images"], batch["image_meta"], batch["gt_class_ids"], batch["gt_boxes"],
                    batch["gt_masks"], input_rois=batch.get("input_rois"), train=True, draws=draws)
    active = parse_image_meta(batch["image_meta"].to(torch.float32))["active_class_ids"]
    total, losses = compute_losses(outputs, rpn.match, rpn.deltas, active, config)
    l2 = l2_reg_loss(model, config.weight_decay, config.l2_reg_batchnorm, _frozen_prefixes(config))
    losses["l2_loss"] = l2
    return total + l2, losses


def _draws(config, batch, rng, draws):
    if draws is not None:
        return draws
    if rng is None:
        raise ValueError("pass a torch.Generator as rng, or the step's draws")
    rois = batch.get("input_rois")
    return draw_uniforms(config, batch["images"].shape[0], rng, batch["images"].device,
                         num_rois=None if config.use_rpn_rois else rois.shape[1])


def make_train_step(config: MaskRCNNConfig):
    """``train_step(state, batch, rng=None, draws=None) -> (state, losses)``.

    ``batch``: ``images [B, H, W, 3]``, ``image_meta [B, M]``,
    ``gt_class_ids [B, G]``, ``gt_boxes [B, G, 4]``, ``gt_masks [B, G, mh,
    mw]`` (images and masks uint8 or float) and, when ``use_rpn_rois=False``,
    ``input_rois [B, R, 4]``, all on the model's device. With
    ``augment_on_device`` the step augments the batch (``ops/augment.py``).
    Frozen modules get zero gradients, so that the optimizer state advances
    for them as optax's does.
    """
    if config.quant_mode != "off":
        raise ValueError("quant_mode is inference-only post-training quantization; train with quant_mode='off'")
    if config.nonfinite_guard not in ("off", "loss", "full"):
        raise ValueError(f"nonfinite_guard {config.nonfinite_guard!r}")
    opt = build_optimizer(config)

    def train_step(state: TrainState, batch: Batch, rng: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
        model = state.model
        params = list(model.parameters())
        stats = _bn_stats(model)
        saved = [t.clone() for t in stats] if config.nonfinite_guard != "off" else None
        total, losses = _loss(model, batch, _draws(config, batch, rng, draws), config, augment=True)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        updates, new_opt_state = opt.update(grads, state.opt_state, params)
        ok = True
        if config.nonfinite_guard != "off":
            finite = torch.isfinite(total.detach())
            if config.nonfinite_guard == "full":
                finite = finite & torch.stack([torch.isfinite(u).all() for u in updates]).all()
            ok = bool(finite)
        if ok:
            with torch.no_grad():
                torch._foreach_add_(params, updates)
            state.opt_state = new_opt_state
        else:
            with torch.no_grad():
                for t, s in zip(stats, saved):
                    t.copy_(s)
        state.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_finite"] = torch.tensor(float(ok), device=total.device)
        return state, losses

    return train_step


def make_eval_step(config: MaskRCNNConfig):
    """``eval_step(state, batch, rng=None, draws=None) -> losses``: the same
    losses as a training step, without the augmentation, the L2 term, the
    update, or any change to the batch-norm statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, rng: Optional[torch.Generator] = None,
                  draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        stats = _bn_stats(state.model)
        saved = [t.clone() for t in stats]
        _, losses = _loss(state.model, batch, _draws(config, batch, rng, draws), config)
        for t, s in zip(stats, saved):
            t.copy_(s)
        del losses["l2_loss"]
        return losses

    return eval_step
