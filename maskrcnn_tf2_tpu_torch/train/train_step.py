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

Data parallelism (JAX ``train_step.py:150-333``): given a process group, each
rank runs the step on its own rows with its own draws (the loop seeds a
generator per rank, where the JAX step folds the axis index into its key),
then ONE all-reduce (``fused_all_reduce_mean``) averages the gradients, the
total and the named losses, the per-rank running batch-norm statistics when
``sync_bn`` is off (with it they are already equal on every rank), and the
preemption flag of ``batch["preempt"]`` (its mean > 0 when some rank was
signalled). The update and the optimizer then run on equal values on every
rank, so the ranks stay replicated. The non-finite guard decides on the
reduced total, so every rank takes or skips the update together (the JAX
step tests each shard's local total: a divergence by design). The step uses
``torch.autograd.grad`` on a parameter list and places the all-reduce by
hand, as the JAX package does; ``DistributedDataParallel`` is not used.

Tensor parallelism (``mesh``, a ``parallel.mesh.Mesh2D``; JAX
``parallel/gspmd.py``): the state is placed on the mesh
(``parallel.gspmd.place_state``), ``batch`` and the draws are this rank's
data rank's, and the model ranks of one data rank compute the same losses.
The gradients go in two fused buffers: the replicated leaves' with the total
and the losses averaged over the world (the copies on a model group's ranks
are nominally equal, so this is the mean over the data ranks, and it leaves
every rank the same bits), the shards' over their data group. Each data
rank's losses are its share of the global-batch losses (each divided by the
global count of its items) times the number of data ranks, so these means
are the global batch's losses and gradients, as JAX's partitioned
global-batch step computes them. A shard's L2
term is ``sum(w**2) / N_full`` with its gradient kept local, and the terms
are summed over the model group for ``l2_loss``; ``clipnorm`` sums the
shards' squares there too; the guard is decided over the world. The batch
norms take the data group's statistics (``place_state`` gives it to them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as tdist

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device
from maskrcnn_tf2_tpu_torch.losses import compute_losses, l2_reg_loss
from maskrcnn_tf2_tpu_torch.models.backbones.pretrained import init_backbone_weights
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.ops.augment import device_augment
from maskrcnn_tf2_tpu_torch.ops.image import parse_image_meta
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms, rpn_targets
from maskrcnn_tf2_tpu_torch.parallel import distributed, gspmd
from maskrcnn_tf2_tpu_torch.train.optimizer import OptState, build_optimizer
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

Batch = Mapping[str, torch.Tensor]
_BN = torch.nn.modules.batchnorm._BatchNorm


@dataclass
class TrainState:
    step: int
    model: MaskRCNN  # float32 parameters and batch-norm statistics
    opt_state: OptState


def create_train_state(config: MaskRCNNConfig, rng: torch.Generator, device: DeviceLike = None,
                       group=None) -> TrainState:
    """A model with seeded random weights (``weights.lecun_init_``, drawn on
    the CPU from ``rng``), its backbone then loaded from
    ``config.backbone_init_weights`` when that names pretrained weights
    (``models/backbones/pretrained.py``), moved to ``device``, and a fresh
    optimizer state. ``group`` is the process group of ``config.sync_bn``."""
    device = resolve_device(device)
    model = lecun_init_(MaskRCNN(config, device="cpu", group=group), rng)
    init_backbone_weights(model, config)
    model.to(device)
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
    asks for it, before the RPN targets, as the JAX step does. On a model
    placed on a mesh the losses are normalized over the global batch and
    scaled by the data ranks' number, the total holds this rank's shards' L2
    terms (their gradient), and ``l2_loss`` every shard's (summed over the
    model group)."""
    if augment and config.augment_on_device:
        batch = device_augment(batch, draws, flip=config.augment_flip, scale_jitter=config.augment_scale_jitter,
                               photometric=config.augment_photometric)
    rpn = rpn_targets(model.anchors, batch["gt_class_ids"], batch["gt_boxes"], draws["rpn_pos"],
                      draws["rpn_neg"], config.rpn_train_anchors_per_image, config.rpn_bbox_std_dev)
    outputs = model(batch["images"], batch["image_meta"], batch["gt_class_ids"], batch["gt_boxes"],
                    batch["gt_masks"], input_rois=batch.get("input_rois"), train=True, draws=draws)
    active = parse_image_meta(batch["image_meta"].to(torch.float32))["active_class_ids"]
    mesh = gspmd.mesh_of(model)
    if mesh is None or mesh.n_data == 1:
        total, losses = compute_losses(outputs, rpn.match, rpn.deltas, active, config)
    else:  # each data rank's share of the global-batch losses, times n_data: the world mean is their sum
        total, losses = compute_losses(outputs, rpn.match, rpn.deltas, active, config,
                                       reduce_count=lambda n: distributed.sum_over(n, mesh.data_group))
        total, losses = total * mesh.n_data, {k: v * mesh.n_data for k, v in losses.items()}
    if mesh is None:
        l2 = l2_reg_loss(model, config.weight_decay, config.l2_reg_batchnorm, _frozen_prefixes(config))
        losses["l2_loss"] = l2
        return total + l2, losses
    sizes = gspmd.full_sizes(model)
    l2 = l2_reg_loss(model, config.weight_decay, config.l2_reg_batchnorm, _frozen_prefixes(config),
                     select=lambda name: name not in sizes)
    l2_shard = l2_reg_loss(model, config.weight_decay, config.l2_reg_batchnorm, _frozen_prefixes(config),
                           select=lambda name: name in sizes, sizes=sizes)
    losses["l2_loss"] = l2.detach() + distributed.sum_over(l2_shard, mesh.model_group)
    return total + l2 + l2_shard, losses


def _draws(config, batch, rng, draws):
    if draws is not None:
        return draws
    if rng is None:
        raise ValueError("pass a torch.Generator as rng, or the step's draws")
    rois = batch.get("input_rois")
    return draw_uniforms(config, batch["images"].shape[0], rng, batch["images"].device,
                         num_rois=None if config.use_rpn_rois else rois.shape[1])


def fused_all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over ``group``'s ranks of every tensor, in ONE all-reduce
    (JAX ``fused_pmean``): each is flattened into one float32 buffer, the
    buffer summed across ranks and divided by their number, then split back
    into the tensors' shapes and dtypes. Bit-equal to a per-tensor mean for
    float32 tensors."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    tdist.all_reduce(flat, group=group)
    flat /= tdist.get_world_size(group)
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def make_train_step(config: MaskRCNNConfig, group=None, mesh=None):
    """``train_step(state, batch, rng=None, draws=None) -> (state, losses)``.

    ``batch``: ``images [B, H, W, 3]``, ``image_meta [B, M]``,
    ``gt_class_ids [B, G]``, ``gt_boxes [B, G, 4]``, ``gt_masks [B, G, mh,
    mw]`` (images and masks uint8 or float) and, when ``use_rpn_rois=False``,
    ``input_rois [B, R, 4]``, all on the model's device; optionally
    ``preempt``, a float tensor whose max joins the losses as ``preempt``.
    With ``augment_on_device`` the step augments the batch
    (``ops/augment.py``). Frozen modules get zero gradients, so that the
    optimizer state advances for them as optax's does.

    With ``group`` (a process group) the step is data-parallel: ``batch`` is
    this rank's rows, ``rng``/``draws`` its own, and the losses returned are
    the means over the ranks (see the module's docstring).

    With ``mesh`` (then ``group`` is not used) the step is tensor-parallel:
    ``state`` must be placed on it (``parallel.gspmd.make_gspmd_train_step``);
    see the module's docstring.
    """
    if mesh is not None and config.sync_bn:
        raise ValueError("gspmd mode takes global-batch batch-norm statistics by construction: sync_bn must be False")
    if config.quant_mode != "off":
        raise ValueError("quant_mode is inference-only post-training quantization; train with quant_mode='off'")
    if config.nonfinite_guard not in ("off", "loss", "full"):
        raise ValueError(f"nonfinite_guard {config.nonfinite_guard!r}")
    opt = build_optimizer(config)
    if mesh is not None and config.clipnorm is not None:  # each shard's squares counted once over its model group
        shards = gspmd.shard_indices(MaskRCNN(config, device="meta"))
        opt = build_optimizer(config, gspmd.sum_squares_fn(shards, mesh))

    def train_step(state: TrainState, batch: Batch, rng: Optional[torch.Generator] = None,
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
        model = state.model
        if gspmd.mesh_of(model) is not mesh:
            raise ValueError("the state is not placed on the step's mesh (parallel.gspmd.place_state)")
        params = list(model.parameters())
        stats = _bn_stats(model)
        saved = [t.clone() for t in stats] if config.nonfinite_guard != "off" else None
        batch = dict(batch)
        preempt = batch.pop("preempt", None)
        total, losses = _loss(model, batch, _draws(config, batch, rng, draws), config, augment=True)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        total = total.detach()
        losses = {k: v.detach() for k, v in losses.items()}
        if preempt is not None:
            losses["preempt"] = preempt.detach().to(torch.float32).max()
        if mesh is not None:
            total = losses["loss_sum"] + losses["l2_loss"]  # every shard's L2 term
            shards = gspmd.shard_indices(model)
            repl = [i for i in range(len(grads)) if i not in shards]
            names = list(losses)
            out = fused_all_reduce_mean([grads[i] for i in repl] + [total] + [losses[k] for k in names], mesh.world)
            sharded = [grads[i] for i in shards]
            if mesh.n_data > 1:
                sharded = fused_all_reduce_mean(sharded, mesh.data_group)
            grads = list(grads)
            for i, g in zip(repl + list(shards), out[:len(repl)] + sharded):
                grads[i] = g
            total = out[len(repl)]
            losses = dict(zip(names, out[len(repl) + 1:]))
        elif group is not None:
            names, n = list(losses), len(grads)
            reduce_stats = stats if not config.sync_bn else []
            out = fused_all_reduce_mean(grads + [total] + [losses[k] for k in names] + reduce_stats, group)
            grads, total = out[:n], out[n]
            losses = dict(zip(names, out[n + 1:n + 1 + len(names)]))
            with torch.no_grad():
                for t, r in zip(reduce_stats, out[n + 1 + len(names):]):
                    t.copy_(r)
        updates, new_opt_state = opt.update(grads, state.opt_state, params)
        ok = True
        if config.nonfinite_guard != "off":
            finite = torch.isfinite(total)
            if config.nonfinite_guard == "full":
                finite = finite & torch.stack([torch.isfinite(u).all() for u in updates]).all()
            if mesh is not None:  # a shard's update can be non-finite on one model rank alone
                finite = distributed.sum_over((~finite).to(torch.float32), mesh.world) == 0
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
        losses["grad_finite"] = torch.tensor(float(ok), device=total.device)
        return state, losses

    return train_step


def make_eval_step(config: MaskRCNNConfig, group=None, mesh=None):
    """``eval_step(state, batch, rng=None, draws=None) -> losses``: the same
    losses as a training step, without the augmentation, the L2 term, the
    update, or any change to the batch-norm statistics. With ``group`` the
    losses are the means over the ranks, in one all-reduce; with ``mesh``
    (a state placed on it, this rank's data rank's rows) over its world."""
    group = mesh.world if mesh is not None else group

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, rng: Optional[torch.Generator] = None,
                  draws: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        stats = _bn_stats(state.model)
        saved = [t.clone() for t in stats]
        _, losses = _loss(state.model, batch, _draws(config, batch, rng, draws), config)
        for t, s in zip(stats, saved):
            t.copy_(s)
        del losses["l2_loss"]
        if group is not None:
            names = list(losses)
            losses = dict(zip(names, fused_all_reduce_mean([losses[k] for k in names], group)))
        return losses

    return eval_step

