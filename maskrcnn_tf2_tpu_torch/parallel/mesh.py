"""Data-parallel helpers (counterpart of ``maskrcnn_tf2_tpu/parallel/mesh.py``).

Where the JAX package places a batch on a device mesh and shards it along the
``data`` axis, the port runs one process per card and passes the process
group explicitly (``train_step.make_train_step(config, group)``). Every rank
builds the same state from the same seed, as the JAX package's hosts do, and
``check_replicated`` proves it with one all-reduce.

``Mesh2D`` (``make_mesh_2d``, the counterpart of the JAX package's
``parallel/gspmd.py::make_mesh_2d``) lays ranks out as ``(data, model)``
for tensor parallelism: an explicit value, passed on to whatever needs it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as tdist
from torch import nn

from maskrcnn_tf2_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh2D:
    """This rank's place in a ``(data, model)`` layout of ranks and the
    process groups of its row and column: ``model_group`` holds the
    ``n_model`` ranks that share one data shard and split the classifier
    head; ``data_group`` the ``n_data`` ranks that hold the same head shard
    on different data. ``world`` spans the whole layout."""

    world: object
    data_group: object
    model_group: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int


def make_mesh_2d(n_data: int, n_model: int, group=None) -> Optional[Mesh2D]:
    """Lay the first ``n_data * n_model`` ranks of ``group`` (default: the
    world) out as JAX reshapes its devices: rank ``r`` has model index ``r %
    n_model`` and data index ``r // n_model``, so a model group is
    consecutive ranks (the NVLink neighbours on a host of several cards).

    Every rank of the world calls it, and creates every subgroup in the same
    order, as ``torch.distributed.new_group`` requires; a rank outside the
    layout gets None. ``group`` must span the world."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"a ({n_data}, {n_model}) mesh")
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh_2d needs an initialized process group (parallel.distributed.initialize)")
    world_ranks = list(range(tdist.get_world_size()))
    ranks = world_ranks if group is None else tdist.get_process_group_ranks(group)
    if ranks != world_ranks:
        raise ValueError("make_mesh_2d lays out the world's ranks: every rank of the world creates the subgroups")
    size = n_data * n_model
    if size > len(ranks):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {size} ranks; the group has {len(ranks)}")
    ranks = ranks[:size]
    me = tdist.get_rank()
    world = tdist.new_group(ranks) if size < len(world_ranks) else (group or tdist.group.WORLD)
    data_groups = [tdist.new_group(ranks[m::n_model]) for m in range(n_model)]
    model_groups = [tdist.new_group(ranks[d * n_model:(d + 1) * n_model]) for d in range(n_data)]
    if me not in ranks:
        return None
    i = ranks.index(me)
    d, m = divmod(i, n_model)
    return Mesh2D(world, data_groups[m], model_groups[d], n_data, n_model, d, m)


def shard_batch(global_batch: Mapping[str, torch.Tensor], rank: int, size: int) -> dict:
    """Rank ``rank``'s rows of a host batch: the ``rank``-th of ``size``
    contiguous blocks along the leading axis (``P(axis)`` over a mesh)."""
    out = {}
    for k, v in global_batch.items():
        if v.shape[0] % size:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {size} ranks")
        b = v.shape[0] // size
        out[k] = v[rank * b:(rank + 1) * b]
    return out


_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def tensor_checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of ``t``'s raw bits: of its words, and of its words
    weighted by their position (mod 65521), so that a flipped bit or two
    swapped elements change it."""
    words = t.detach().contiguous().reshape(-1).view(_BITS[t.element_size()]).to(torch.int64)
    weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return torch.stack([words.sum(), (words * weights).sum()])


def state_checksum(model: nn.Module, select: Optional[Callable[[str], bool]] = None) -> torch.Tensor:
    """``tensor_checksum`` of each tensor of the state dict whose name
    ``select`` accepts, back to back."""
    sums = [tensor_checksum(t) for name, t in model.state_dict().items() if select is None or select(name)]
    return torch.cat(sums) if sums else torch.zeros(0, dtype=torch.int64)


def check_equal(c: torch.Tensor, group, what: str) -> None:
    """Raise unless the checksum ``c`` is equal on every rank of ``group``:
    one MAX all-reduce of ``[c, -c]`` gives each entry's largest and
    smallest value across the ranks."""
    if not len(c):
        return
    both = torch.cat([c, -c]).to(distributed.small_tensor_device(group, c.device))
    tdist.all_reduce(both, op=tdist.ReduceOp.MAX, group=group)
    hi, lo = both[: len(c)], -both[len(c):]
    differ = int((hi != lo).sum())
    if differ:
        raise RuntimeError(f"{what} differs across the {distributed.world_size(group)} ranks "
                           f"in {differ} of {len(c)} checksum entries")


def check_replicated(model: nn.Module, group, what: str = "state", mesh: Optional[Mesh2D] = None) -> None:
    """Raise unless every rank of ``group`` holds the same state, bit for bit
    (``state_checksum``, ``check_equal``).

    Under a ``mesh`` (tensor parallelism) a leaf is one of two classes: a
    replicated leaf is equal on every rank of ``mesh.world``, a shard of the
    classifier head (``parallel/gspmd.py``) on every rank of its data group."""
    if mesh is None:
        check_equal(state_checksum(model), group, what)
        return
    from maskrcnn_tf2_tpu_torch.parallel.gspmd import shard_dim

    check_equal(state_checksum(model, lambda name: shard_dim(name) is None), mesh.world, what)
    check_equal(state_checksum(model, lambda name: shard_dim(name) is not None), mesh.data_group,
                f"{what} (the head's shards)")
