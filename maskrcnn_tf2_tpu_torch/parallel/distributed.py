"""The process group of a data-parallel run (counterpart of
``maskrcnn_tf2_tpu/parallel/distributed.py``).

One process per card. ``initialize`` reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) where no
argument is given, and brings up ``torch.distributed`` with NCCL for a card
and gloo for the CPU; it never falls back from one backend to the other.
Everything downstream takes the group it returns as an argument: the
training step's all-reduce, the sync batch norms, the loader's shard, the
checkpoints and the loop.

Usage (per process, e.g. under ``torchrun --nproc_per_node N``)::

    from maskrcnn_tf2_tpu_torch.parallel import distributed as dist
    group = dist.initialize()                 # None in a plain single process
    state = train_model(cfg, train_ds, val_ds, group=group, device=dist.local_device())
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def local_device(device_type: str = "cuda") -> torch.device:
    """``cuda:{LOCAL_RANK}`` (0 without torchrun), through ``resolve_device``:
    it raises when no card is visible. ``device_type="cpu"`` gives the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return resolve_device(f"cuda:{_env_int('LOCAL_RANK') or 0}")


def check_nccl_devices(local_world_size: int, device_count: int) -> None:
    """NCCL takes one rank per card: raise when the ranks of one host
    outnumber its cards."""
    if local_world_size > device_count:
        raise RuntimeError(
            f"{local_world_size} ranks on this host but {device_count} CUDA device(s): NCCL refuses two ranks on "
            "one card; start one rank per card, or pass backend='gloo' to share a card")


def initialize(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device: DeviceLike = None,
):
    """Join the process group; returns it (``torch.distributed``'s default
    group), or None for a single process with nothing set.

    Idempotent: a second call returns the group already initialized.
    ``device`` is this rank's device (default ``local_device()``); the
    backend defaults to ``nccl`` for a card and ``gloo`` for the CPU. Under
    NCCL the rank's card becomes the current device, and a host with more
    ranks than cards raises. Every collective of the group, a barrier
    included, fails after ``timeout_s`` instead of waiting unbounded."""
    if tdist.is_initialized():
        return tdist.group.WORLD
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world_size is None:
        if rank is not None or init_method is not None:
            raise ValueError("initialize: a rank or init_method without a world size")
        return None
    if rank is None:
        raise ValueError("initialize: a world size without a rank (set RANK or pass rank=)")
    device = local_device() if device is None else resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
        check_nccl_devices(_env_int("LOCAL_WORLD_SIZE") or 1, torch.cuda.device_count())
        torch.cuda.set_device(device)
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("initialize: pass init_method= or set MASTER_ADDR and MASTER_PORT")
        init_method = f"tcp://{addr}:{port}"
    tdist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                             timeout=datetime.timedelta(seconds=timeout_s))
    return tdist.group.WORLD


def is_initialized() -> bool:
    return tdist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a group)."""
    return tdist.get_rank(group) if tdist.is_initialized() else 0


def world_size(group=None) -> int:
    """The number of ranks in ``group`` (1 without a group)."""
    return tdist.get_world_size(group) if tdist.is_initialized() else 1


def is_primary(group=None) -> bool:
    """Rank 0 writes checkpoints and metrics."""
    return rank(group) == 0


def barrier(name: str = "", group=None) -> None:
    """Wait for every rank of ``group`` (no-op without one). Under NCCL the
    barrier runs on this rank's current card. ``name`` labels a failure."""
    if not tdist.is_initialized():
        return
    try:
        if tdist.get_backend(group) == "nccl":
            tdist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier(group=group)
    except Exception as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {rank(group)}: {e}") from e


def small_tensor_device(group, device) -> torch.device:
    """Where a small control tensor (a flag, a checksum) of ``group`` goes:
    the host under gloo (which reduces every op there), ``device`` under NCCL."""
    return torch.device("cpu") if tdist.get_backend(group) == "gloo" else torch.device(device)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks in float32 (gloo reduces no
    bfloat16 on a card), on ``x``'s device, without gradient; ``x`` itself
    is left as it is. A scalar travels through ``small_tensor_device``."""
    if x.dim() == 0:
        y = x.detach().reshape(1).to(small_tensor_device(group, x.device), torch.float32, copy=True)
        tdist.all_reduce(y, group=group)
        return y.to(x.device).reshape(())
    y = x.detach().to(torch.float32, copy=True).contiguous()
    tdist.all_reduce(y, group=group)
    return y


def destroy() -> None:
    """Leave the process group (no-op when none)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def host_shard(order: np.ndarray, index: int, count: int) -> np.ndarray:
    """This process's slice of a shared-seed shuffled order: ``order[index::count]``
    (disjoint across processes, their union the order, sizes within one)."""
    return order[index::count]
