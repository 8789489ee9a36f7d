"""Tensor parallelism of the classifier head inside data-parallel training
(counterpart of ``maskrcnn_tf2_tpu/parallel/gspmd.py``).

The JAX package jits its unmodified global-batch step with ``in_shardings``
over a ``(data, model)`` mesh, and XLA's SPMD partitioner inserts every
collective. PyTorch has no partitioner: here the layout is an explicit
``parallel.mesh.Mesh2D`` of process groups, and each collective is placed by
hand:

- the classifier head's FC1 is column-parallel and FC2 row-parallel over the
  model group, with one sum of FC2's partial products before its bias
  (``models/heads.py``, ``models/layers.py``); ``_TP_RULES`` names the split
  dimension of each sharded leaf;
- every batch norm takes its statistics over the data group: global-batch
  statistics, as the partitioned global-batch program computes them, so the
  gspmd mode has sync-BN semantics without ``config.sync_bn`` (which must
  stay False); each loss divides by the global batch's count of its items
  (``losses.py``'s ``reduce_count``), so the data ranks' losses add up to
  the global-batch loss;
- the training step (``train/train_step.py`` with ``mesh``) averages the
  replicated gradients over the world and the shards' over their data group,
  sums the shards' L2 terms and, for ``clipnorm``, their squares over the
  model group, and decides the non-finite guard over the world.

The ranks of one model group run the same images with the same draws (the
loop seeds a step's draws by the data rank), so their ROIs agree and each FC1
shard sees the same rows. The state is always built whole and then sliced
(``place_state``), as the JAX package keeps its full-shape initialization: a
shard initialized alone would draw FC2 at the wrong fan-in.
``gather_state_dict`` puts it back together with one all-reduce of the
shards' bits over the model group (``all_gather`` is not used: gloo lacks it
for CUDA tensors).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.heads import FPNClassifierHead
from maskrcnn_tf2_tpu_torch.models.layers import BatchNorm
from maskrcnn_tf2_tpu_torch.parallel import distributed
from maskrcnn_tf2_tpu_torch.parallel.mesh import Mesh2D, shard_batch

# Trailing names of the classifier head's sharded leaves -> the dimension of
# the port's (PyTorch-layout, [out, in]) tensor that is split over the model
# group. Every other leaf, FC2's bias among them, is whole on every rank.
_TP_RULES: Tuple[Tuple[Tuple[str, str], int], ...] = (
    # FC1: column-parallel, fc/k output features a rank
    (("mrcnn_class_conv1", "weight"), 0),
    (("mrcnn_class_conv1", "bias"), 0),
    # its batch norm is per feature, so it shards with them
    (("mrcnn_class_bn1", "weight"), 0),
    (("mrcnn_class_bn1", "bias"), 0),
    (("mrcnn_class_bn1", "running_mean"), 0),
    (("mrcnn_class_bn1", "running_var"), 0),
    # FC2: row-parallel, fc/k input features a rank; partial sums reduced
    (("mrcnn_class_conv2", "weight"), 1),
)


def shard_dim(name: str) -> Optional[int]:
    """The split dimension of the state-dict entry ``name``, or None for a
    replicated one."""
    keys = tuple(name.split(".")[-2:])
    return next((dim for pattern, dim in _TP_RULES if keys == pattern), None)


def mesh_of(model) -> Optional[Mesh2D]:
    """The mesh a model's head is split over (None: unsharded)."""
    return getattr(model.classifier, "tp", None)


def shard_indices(model) -> Dict[int, int]:
    """``{position in model.parameters(): split dim}`` of the sharded parameters."""
    return {i: d for i, (name, _) in enumerate(model.named_parameters()) if (d := shard_dim(name)) is not None}


def full_sizes(model) -> Dict[str, int]:
    """``{parameter name: element count of the whole leaf}`` of a placed
    model's shards (the sizes ``losses.l2_reg_loss`` divides by)."""
    mesh = mesh_of(model)
    k = 1 if mesh is None else mesh.n_model
    return {name: p.numel() * k for name, p in model.named_parameters() if shard_dim(name) is not None}


def _slice(t: torch.Tensor, dim: int, mesh: Mesh2D) -> torch.Tensor:
    n = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * n, n).clone(memory_format=torch.contiguous_format)


def _head(config: MaskRCNNConfig, tp: Optional[Mesh2D], device) -> FPNClassifierHead:
    return FPNClassifierHead(config.top_down_pyramid_size, config.num_classes, config.pool_size,
                             config.fpn_cls_fc_layers_size, leaky_relu=config.cls_head_leaky_relu, tp=tp).to(device)


def _check(config: MaskRCNNConfig, mesh: Mesh2D) -> None:
    if config.sync_bn:
        raise ValueError("gspmd mode computes global-batch batch-norm statistics by construction; config.sync_bn is "
                         "the data-parallel path's flag and must stay False")
    if mesh.n_model != config.tp_shards:
        raise ValueError(f"a mesh of {mesh.n_model} model ranks for tp_shards={config.tp_shards}")


def place_state(state, mesh: Mesh2D, config: MaskRCNNConfig):
    """Slice a whole ``TrainState`` into this rank's shards, in place, and
    return it: the head's sharded parameters and batch-norm statistics
    (``_TP_RULES``) and every optimizer slot that mirrors a sharded
    parameter; every batch norm takes the data group when it has several
    ranks. The parameters keep their order, so the optimizer's slot lists
    stay aligned."""
    _check(config, mesh)
    model = state.model
    if mesh_of(model) is not None:
        raise ValueError("the state is already placed on a mesh")
    device = next(model.parameters()).device
    head = _head(config, mesh, device)
    head.load_state_dict({k: v if (d := shard_dim(k)) is None else _slice(v, d, mesh)
                          for k, v in model.classifier.state_dict().items()})
    dims = shard_indices(model)
    model.classifier = head
    state.opt_state = state.opt_state._replace(slots={
        k: [t if i not in dims else _slice(t, dims[i], mesh) for i, t in enumerate(ts)]
        for k, ts in state.opt_state.slots.items()})
    for m in model.modules():
        if isinstance(m, BatchNorm) and mesh.n_data > 1:
            m.group = mesh.data_group
    return state


def _gather(shards: List[Tuple[torch.Tensor, int]], mesh: Mesh2D) -> List[torch.Tensor]:
    """The whole tensors of ``shards`` (each with its split dim) on every
    rank of the model group: each rank writes its shard's bits into zeroed
    buffers of the whole shapes, and one integer all-reduce (sum) of them,
    exact in any order, fills in the others'."""
    if not shards:
        return []
    device = distributed.small_tensor_device(mesh.model_group, shards[0][0].device)
    fulls = []
    for t, dim in shards:
        if t.element_size() != 4:
            raise TypeError(f"a {t.dtype} shard: the gather moves 4-byte words")
        shape = list(t.shape)
        shape[dim] *= mesh.n_model
        full = torch.zeros(shape, dtype=t.dtype, device=device)
        full.narrow(dim, mesh.model_rank * t.shape[dim], t.shape[dim]).copy_(t)
        fulls.append(full)
    flat = torch.cat([f.reshape(-1).view(torch.int32) for f in fulls])
    tdist.all_reduce(flat, group=mesh.model_group)
    out, off = [], 0
    for (t, _), f in zip(shards, fulls):
        n = f.numel()
        out.append(flat[off:off + n].view(t.dtype).reshape(f.shape).to(t.device))
        off += n
    return out


def gather_state_dict(state, mesh: Mesh2D) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[torch.Tensor]]]:
    """The whole state on every rank: ``(model state dict, optimizer slots)``
    with each shard put back into its leaf's full shape, bit for bit.
    Every rank of the model group calls it. The replicated entries are the
    state's own tensors, as ``state_dict()`` gives them: copy them to keep
    them past the next step."""
    model = state.model
    sd = model.state_dict()
    keys = [k for k in sd if shard_dim(k) is not None]
    dims = shard_indices(model)
    slots = state.opt_state.slots
    slot_keys = [(k, i) for k in slots for i in dims]
    whole = _gather([(sd[k], shard_dim(k)) for k in keys] + [(slots[k][i], dims[i]) for k, i in slot_keys], mesh)
    sd = dict(sd)
    sd.update(zip(keys, whole[:len(keys)]))
    slots = {k: list(ts) for k, ts in slots.items()}
    for (k, i), t in zip(slot_keys, whole[len(keys):]):
        slots[k][i] = t
    return sd, slots


def unplace_(state, config: MaskRCNNConfig):
    """Give a placed state whole-shaped head leaves and slots again, in
    place (their values are not the shards': a full state is loaded into
    them next, as ``train.checkpoint.restore`` does); the batch norms keep
    their groups. Returns the state."""
    model = state.model
    dims = shard_indices(model)
    k = mesh_of(model).n_model
    model.classifier = _head(config, None, next(model.parameters()).device)

    def whole(t, dim):
        shape = list(t.shape)
        shape[dim] *= k
        return t.new_zeros(shape)

    state.opt_state = state.opt_state._replace(slots={
        name: [t if i not in dims else whole(t, dims[i]) for i, t in enumerate(ts)]
        for name, ts in state.opt_state.slots.items()})
    return state


def sum_squares_fn(shards: Dict[int, int], mesh: Mesh2D) -> Callable[[List[torch.Tensor]], torch.Tensor]:
    """``clipnorm``'s sum of squares under the mesh: the replicated leaves'
    squares plus the shards' summed over the model group, so that each
    shard counts once."""

    def sum_squares(g: List[torch.Tensor]) -> torch.Tensor:
        repl = sum(torch.sum(t * t) for i, t in enumerate(g) if i not in shards)
        part = sum(torch.sum(t * t) for i, t in enumerate(g) if i in shards)
        return repl + distributed.sum_over(part, mesh.model_group)

    return sum_squares


def make_gspmd_train_step(config: MaskRCNNConfig, mesh: Mesh2D, state):
    """``(train_step, placed_state)``: the step of ``train_step.
    make_train_step(config, mesh=mesh)`` over this rank's rows of the
    global batch (``shard_global_batch``) with its data rank's draws, and
    ``state`` placed on the mesh (``place_state``, unless it already is)."""
    from maskrcnn_tf2_tpu_torch.train.train_step import make_train_step

    _check(config, mesh)
    if mesh_of(state.model) is None:
        state = place_state(state, mesh, config)
    elif mesh_of(state.model) is not mesh:
        raise ValueError("the state is placed on another mesh")
    return make_train_step(config, mesh=mesh), state


def make_gspmd_eval_step(config: MaskRCNNConfig, mesh: Mesh2D, state):
    """The validation-loss step over the same layout (``state`` must be
    placed on ``mesh``); the losses are means over the world."""
    from maskrcnn_tf2_tpu_torch.train.train_step import make_eval_step

    _check(config, mesh)
    if mesh_of(state.model) is not mesh:
        raise ValueError("place the state on the mesh first (make_gspmd_train_step or place_state)")
    return make_eval_step(config, mesh=mesh)


def shard_global_batch(batch, mesh: Mesh2D, config: MaskRCNNConfig) -> dict:
    """This rank's rows of a global batch: its data rank's block (the model
    ranks of one data rank take the same rows)."""
    if config.batch_size % mesh.n_data:
        raise ValueError(f"batch_size {config.batch_size} does not split over {mesh.n_data} data ranks")
    return shard_batch(batch, mesh.data_rank, mesh.n_data)
