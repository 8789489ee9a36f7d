"""The training loop, ``train_model`` (counterpart of
``maskrcnn_tf2_tpu/train/loop.py``).

Epochs over ``prefetch_to_device(DataLoader.epoch())``, validation through
the eval step with the loss means summed on the device and read once, the
ReduceLROnPlateau scheduler (its state saved with each checkpoint), best-only
checkpoints, SIGTERM preemption with a checkpoint after the in-flight step,
and resume. The JAX package's persistent XLA compile cache
(``utils/compile_cache.py``) has no counterpart: eager PyTorch compiles
nothing but the CUDA kernels, which ``kernels/_build.py`` builds once into
its own directory.

Data parallelism (JAX ``loop.py:99-230, 297-372``): with a process group
(passed as ``group``, or the one ``parallel.distributed.initialize`` brought
up) each rank loads its shard of every global batch and runs the
data-parallel steps (``train_step.make_train_step(config, group)``);
validation is sharded the same way. The ranks build the same state from the
same seed and check it with one all-reduce; only the primary rank writes
checkpoints, calls ``metric_writer`` and prints. Every rank runs the same
number of steps an epoch (the loader cycles its shard to fill it).
Preemption: a SIGTERM on any rank rides the next step's fused all-reduce as a
flag. The port reads each step's losses on the host anyway (the guard), so it
acts on the CURRENT step's flag, where the JAX loop acts on the previous
step's to keep its dispatch asynchronous: every rank stops after the same
step. A flag raised during the epoch's last step is caught by one more
all-reduce at the epoch's end.

Tensor parallelism (JAX ``loop.py:143-170``): with ``parallel_mode="gspmd"``
and a group of several ranks, the ranks form a ``(data, model)`` mesh of
``tp_shards`` model ranks (``parallel/gspmd.py``); the state is built whole,
restored whole, then placed. The loader shards by the data rank, the draws
are seeded by it (a model group must draw the same ROIs), checkpoints are
gathered whole, and the preemption flag and the validation losses are
reduced over the world. With no group, or one rank, the loop trains on one
device, as the JAX loop does with one device, and says so. A group that
``tp_shards`` does not divide, or a batch its data ranks do not, raises.

Randomness: the draws of the step at ``global_step`` come from a
``torch.Generator`` seeded by ``(rng_seed, global_step)``, and by the rank
too on ranks other than 0 (``step_generator``, the counterpart of
``fold_in(fold_in(rng, global_step), axis_index)``), and the loader replays
the shuffles of the epochs already trained, so a run resumed at an epoch
boundary draws what the unbroken run drew.
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as tdist

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader, prefetch_to_device
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.parallel import distributed, gspmd
from maskrcnn_tf2_tpu_torch.parallel.mesh import check_replicated, make_mesh_2d
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.optimizer import set_learning_rate
from maskrcnn_tf2_tpu_torch.train.train_step import TrainState, create_train_state, make_eval_step, make_train_step


class PlateauScheduler:
    """ReduceLROnPlateau: the learning rate times ``factor`` after
    ``patience`` epochs without a new best. ``state_dict``/``load_state_dict``
    carry it through checkpoints, so a resumed run continues its LR
    trajectory."""

    def __init__(self, factor: float, patience: int, base_lr: float):
        self.factor = factor
        self.patience = patience
        self.lr = base_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best - 1e-7:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "best": self.best, "bad_epochs": float(self.bad_epochs)}

    def load_state_dict(self, d: Dict[str, float]):
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.bad_epochs = int(d["bad_epochs"])


def step_generator(rng_seed: int, global_step: int, rank: int = 0) -> torch.Generator:
    """The generator of the step at ``global_step``'s draws on ``rank`` (the
    data rank under tensor parallelism); rank 0 draws what a single process
    draws."""
    entropy = [rng_seed, global_step] + ([rank] if rank else [])
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _eval_generator(rng_seed: int) -> torch.Generator:
    """Every eval batch draws from the same seed, as the JAX loop passes its
    one base key to each eval step."""
    seed = np.random.SeedSequence([rng_seed]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def train_model(
    config: MaskRCNNConfig,
    train_dataset,
    val_dataset=None,
    state: Optional[TrainState] = None,
    augment_fn=None,
    metric_writer: Optional[Callable[[int, Dict[str, float]], None]] = None,
    checkpoint_base: Optional[str] = None,
    profile_steps: Optional[tuple] = None,
    resume: bool = True,
    steps_per_epoch: Optional[int] = None,
    rng_seed: int = 0,
    device: DeviceLike = None,
    history: Optional[List[Dict[str, float]]] = None,
    group=None,
) -> TrainState:
    """Train for ``config.epochs`` epochs on ``device`` (the card unless
    ``"cpu"``); returns the final ``TrainState``.

    ``metric_writer(global_step, losses)`` is called every
    ``config.log_per_steps`` steps. ``profile_steps=(first, last)`` traces
    those global steps with ``torch.profiler`` into the checkpoint directory.
    ``steps_per_epoch`` caps an epoch. A list passed as ``history`` gets one
    dict per finished epoch: its metrics (train means, ``val_*`` means),
    ``lr``, ``steps``, ``seconds`` and ``images_per_s`` (the whole epoch's,
    validation and checkpoint included), ``train_seconds`` (its training
    steps') and ``loader_wait_s`` (the part of those the loop waited for the
    next batch).

    ``group``: the process group of a data-parallel run (default: the one
    ``parallel.distributed`` initialized, if any); see the module's
    docstring. ``config.batch_size`` is then the global batch.
    """
    if group is None and distributed.is_initialized():
        group = tdist.group.WORLD
    mesh = None
    if config.parallel_mode == "gspmd":
        mesh = _gspmd_mesh(config, group)
        if mesh is None:
            print("gspmd with no process group of several ranks: training on one device")
            group = None
    if state is None:
        state = create_train_state(config, torch.Generator().manual_seed(rng_seed), device=device,
                                   group=None if mesh is not None else group)
    device = next(state.model.parameters()).device
    sched = PlateauScheduler(config.reduce_lr_factor, config.reduce_lr_patience, config.learning_rate)
    manager = ckpt_lib.make_manager(config, checkpoint_base)
    pre_manager = ckpt_lib.make_preempt_manager(config, checkpoint_base)
    start_epoch = 0
    if resume:  # from whichever manager holds the newest checkpoint
        state, start_epoch, extra = ckpt_lib.restore(ckpt_lib.pick_resume_manager(manager, pre_manager), state,
                                                     extra_template=sched.state_dict())
        if extra is not None:
            sched.load_state_dict(extra)
            state.opt_state = set_learning_rate(state.opt_state, sched.lr)
    if mesh is not None and gspmd.mesh_of(state.model) is None:
        gspmd.place_state(state, mesh, config)
    if group is not None:
        distributed.barrier("train_model state", group)
        check_replicated(state.model, group, "the initial state", mesh=mesh)
    data_rank, data_count = _data_shard(group, mesh)
    train_loader = DataLoader(train_dataset, config, shuffle=True, augment_fn=augment_fn,
                              process_index=data_rank, process_count=data_count)
    train_loader.skip_epochs(start_epoch)

    # SIGTERM (a preemption notice) sets a flag; the loop checkpoints after
    # the step in flight and returns, and resume=True continues from there.
    # siginterrupt(False) resumes a system call the signal interrupts instead
    # of failing it.
    preempt = {"hit": False}

    def _mark_preempt(signum, frame):
        preempt["hit"] = True
        print(f"signal {signum}: checkpointing after the in-flight step", flush=True)

    installed, prev_handler = False, None
    try:
        prev_handler = signal.signal(signal.SIGTERM, _mark_preempt)
        installed = True
        signal.siginterrupt(signal.SIGTERM, False)
    except ValueError:  # not the main thread: no handler
        pass
    anomaly = torch.autograd.set_detect_anomaly(True) if config.debug_nans else contextlib.nullcontext()
    try:
        with anomaly:
            return _epoch_loop(config, state, train_loader, val_dataset, manager, pre_manager, sched,
                               metric_writer, checkpoint_base, profile_steps, steps_per_epoch, rng_seed,
                               start_epoch, preempt, device, history, group, mesh)
    finally:  # a raise in the loop must not leave the handler installed
        if installed:
            signal.signal(signal.SIGTERM, signal.SIG_DFL if prev_handler is None else prev_handler)


def _gspmd_mesh(config: MaskRCNNConfig, group):
    """The ``(data, model)`` mesh of a gspmd run over ``group``'s ranks, or
    None when there is no group of several ranks."""
    world = distributed.world_size(group) if group is not None else 1
    if world == 1:
        return None
    tp = config.tp_shards
    if world % tp:
        raise ValueError(f"tp_shards={tp} does not divide the {world} ranks of the group")
    if config.batch_size % (world // tp):
        raise ValueError(f"batch_size {config.batch_size} does not split over {world // tp} data ranks")
    mesh = make_mesh_2d(world // tp, tp, group)
    if distributed.rank(group) == 0:
        print(f"gspmd over {world} ranks: ({config.mesh_data_axis}={world // tp}, {config.mesh_model_axis}={tp})")
    return mesh


def _data_shard(group, mesh):
    """``(index, count)`` of this rank's data shard: the loader's shard and
    the draws are the data rank's."""
    if mesh is not None:
        return mesh.data_rank, mesh.n_data
    return distributed.rank(group), distributed.world_size(group)


def _means(sums: Optional[Dict[str, torch.Tensor]], n: int) -> Dict[str, float]:
    """Loss sums on the device -> means on the host, in one read."""
    if not sums:
        return {}
    values = torch.stack([v.to(torch.float32) for v in sums.values()]).tolist()
    return {k: v / n for k, v in zip(sums, values)}


def _any_rank(flag: bool, group, device) -> bool:
    """True on every rank when ``flag`` is True on some rank (one all-reduce)."""
    t = torch.tensor([1.0 if flag else 0.0], device=distributed.small_tensor_device(group, device))
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)


def _epoch_loop(config, state, train_loader, val_dataset, manager, pre_manager, sched, metric_writer,
                checkpoint_base, profile_steps, steps_per_epoch, rng_seed, start_epoch, preempt, device, history,
                group, mesh):
    if mesh is not None:
        train_step, state = gspmd.make_gspmd_train_step(config, mesh, state)
        eval_step = gspmd.make_gspmd_eval_step(config, mesh, state)
    else:
        train_step = make_train_step(config, group)
        eval_step = make_eval_step(config, group)
    rank, world = distributed.rank(group), distributed.world_size(group)
    primary = rank == 0
    data_rank, data_count = _data_shard(group, mesh)
    profiler = None
    for epoch in range(start_epoch, config.epochs):
        t0 = time.perf_counter()
        agg, spe, wait = None, 0, 0.0  # losses summed on the device: one read at the epoch's end
        # every rank runs the same number of steps: each cycles its shard to fill the global count
        fixed = (steps_per_epoch or train_loader.steps_per_epoch) if world > 1 else None
        batches = prefetch_to_device(train_loader.epoch(fixed_steps=fixed), config.prefetch_size, device)
        stop = False
        with contextlib.closing(batches):
            while not (steps_per_epoch and spe >= steps_per_epoch):
                t_wait = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                global_step = state.step
                if primary and profile_steps and global_step == profile_steps[0]:
                    profiler = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else []))
                    profiler.start()
                if group is not None:  # this rank's SIGTERM rides the step's all-reduce
                    batch["preempt"] = torch.tensor([1.0 if preempt["hit"] else 0.0], device=device)
                state, losses = train_step(state, batch, rng=step_generator(rng_seed, global_step, data_rank))
                if group is not None:
                    stop = float(losses.pop("preempt")) > 0  # the mean over the ranks: > 0 if any was signalled
                if profiler is not None and global_step == profile_steps[1]:
                    profiler.stop()
                    profiler.export_chrome_trace(f"{ckpt_lib.checkpoint_dir(config, checkpoint_base)}/"
                                                 f"trace_steps_{profile_steps[0]}_{profile_steps[1]}.json")
                    profiler = None
                spe += 1
                agg = losses if agg is None else {k: agg[k] + v for k, v in losses.items()}
                if primary and metric_writer and spe % config.log_per_steps == 0:
                    metric_writer(state.step, {k: float(v) for k, v in losses.items()})
                if group is None:  # checked last: a signal inside metric_writer stops after this step
                    stop = preempt["hit"]
                if stop:
                    break
        train_seconds = time.perf_counter() - t0
        metrics = _means(agg, spe)
        if not stop:  # a signal during the epoch's last step
            stop = _any_rank(preempt["hit"], group, device) if group is not None else preempt["hit"]
        if stop:
            # the partial epoch's checkpoint keeps every step taken; resume
            # starts at the next epoch
            ckpt_lib.save(pre_manager, state, epoch, metrics, extra=sched.state_dict(), group=group)
            print(f"rank {rank}: " * (world > 1) + f"preempted at epoch {epoch + 1} step {spe}: checkpoint saved")
            return state
        if val_dataset is not None:
            val_loader = DataLoader(val_dataset, config, shuffle=False, process_index=data_rank,
                                    process_count=data_count)
            val_fixed = val_loader.steps_per_epoch if world > 1 else None
            val_agg, val_n = None, 0
            if val_fixed != 0:  # a validation set smaller than a global batch: every rank skips it
                for vb in prefetch_to_device(val_loader.epoch(fixed_steps=val_fixed), config.prefetch_size, device):
                    vl = eval_step(state, vb, rng=_eval_generator(rng_seed))
                    val_agg = vl if val_agg is None else {k: val_agg[k] + v for k, v in vl.items()}
                    val_n += 1
            metrics.update({f"val_{k}": v for k, v in _means(val_agg, val_n).items()})

        new_lr = sched.update(metrics.get("val_loss_sum", metrics.get("loss_sum", 0.0)))
        state.opt_state = set_learning_rate(state.opt_state, new_lr)
        ckpt_lib.save(manager, state, epoch, metrics, extra=sched.state_dict(), group=group)
        dt = time.perf_counter() - t0
        ips = spe * config.batch_size / dt
        if history is not None:
            history.append(dict(metrics, epoch=epoch, lr=new_lr, steps=spe, seconds=dt, images_per_s=ips,
                                train_seconds=train_seconds, loader_wait_s=wait))
        if primary:
            print(f"epoch {epoch + 1}/{config.epochs} loss={metrics.get('loss_sum', float('nan')):.4f} "
                  + (f"val_loss={metrics['val_loss_sum']:.4f} " if "val_loss_sum" in metrics else "")
                  + f"lr={new_lr:.2e} {ips:.2f} img/s, waited {wait:.2f} s of {dt:.2f} s for the loader")
    return state
