"""Data-parallel helpers (counterpart of ``maskrcnn_tf2_tpu/parallel/mesh.py``).

Where the JAX package places a batch on a device mesh and shards it along the
``data`` axis, the port runs one process per card and passes the process
group explicitly (``train_step.make_train_step(config, group)``). Every rank
builds the same state from the same seed, as the JAX package's hosts do, and
``check_replicated`` proves it with one all-reduce.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as tdist
from torch import nn

from maskrcnn_tf2_tpu_torch.parallel import distributed


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


def state_checksum(model: nn.Module) -> torch.Tensor:
    """Two int64 sums of the raw bits of each tensor of the state dict: of
    the words, and of the words weighted by their position (mod 65521), so
    that a flipped bit or two swapped elements change it."""
    sums = []
    for t in model.state_dict().values():
        words = t.detach().reshape(-1).view(_BITS[t.element_size()]).to(torch.int64)
        weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
        sums += [words.sum(), (words * weights).sum()]
    return torch.stack(sums)


def check_replicated(model: nn.Module, group, what: str = "state") -> None:
    """Raise unless every rank of ``group`` holds the same state, bit for bit
    (``state_checksum``): one MAX all-reduce of ``[checksum, -checksum]``
    gives the largest and smallest value of each entry across ranks."""
    c = state_checksum(model)
    both = torch.cat([c, -c]).to(distributed.small_tensor_device(group, c.device))
    tdist.all_reduce(both, op=tdist.ReduceOp.MAX, group=group)
    hi, lo = both[: len(c)], -both[len(c):]
    differ = int((hi != lo).sum())
    if differ:
        raise RuntimeError(f"{what} differs across the {distributed.world_size(group)} ranks "
                           f"in {differ} of {len(c)} checksum entries")
