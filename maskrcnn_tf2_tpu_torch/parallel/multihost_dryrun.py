"""Localhost multi-process dryrun and launcher (counterpart of
``maskrcnn_tf2_tpu/parallel/multihost_dryrun.py``).

``launch(target, nprocs, args)`` runs ``target(rank, nprocs, init_method,
*args)`` in ``nprocs`` processes started with the ``spawn`` method, against a
free localhost port, and returns their results by rank. Every wait has a
deadline: a rank that raises, dies or outlives ``timeout_s`` kills the
others, and ``launch`` raises with its traceback. The tests and
``chip_smoke.py`` drive their multi-rank checks through it.

The dryrun itself (``python -m maskrcnn_tf2_tpu_torch.parallel.multihost_dryrun``,
gloo ranks on the CPU) checks on every rank:

  1. the loader's shards partition the dataset: a real all-reduce of one-hot
     ownership counts every index once;
  2. an all-reduce against its closed form;
  3. with ``--full-model``, the data-parallel training step at a tiny
     configuration gives a finite loss and replicated states;
  4. with ``--preempt``, the preemption drill: SIGTERM to rank 1 after the
     second step of a two-epoch ``train_model`` run; every rank stops after
     the same step, the primary alone writes the one preemption checkpoint,
     and a resumed run completes the second epoch on every rank.
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import socket
import tempfile
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from maskrcnn_tf2_tpu_torch.parallel import distributed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(target, rank, nprocs, init_method, args, results, num_threads):
    torch.set_num_threads(num_threads)
    try:
        out = target(rank, nprocs, init_method, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which kills the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.destroy()


def launch(target, nprocs: int = 2, args: tuple = (), timeout_s: float = 300.0, num_threads: int = 1) -> list:
    """Run ``target(rank, nprocs, init_method, *args)`` on ``nprocs`` spawned
    ranks, each with ``num_threads`` intra-op threads (the ranks share one
    host); returns ``[result of rank 0, ...]`` or raises (a rank's error,
    death or timeout), leaving no rank running. ``target`` must be importable
    by the spawned processes (a module-level function); a script that calls
    ``launch`` keeps its top-level code under ``if __name__ == "__main__"``,
    since each rank imports it again."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_run, args=(target, r, nprocs, init_method, args, results, num_threads))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    done, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(done) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(done))} did not finish in {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)  # a result may still be in the pipe
                    if results.empty():
                        raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                           "without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            done[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [done[r] for r in range(nprocs)]


def tiny_config(**over):
    """A tiny float32 configuration (64 px ResNet-18, 64-wide heads)."""
    from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig

    base = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64,
                rpn_anchor_scales=(8, 16, 24, 32, 48), pre_nms_limit=128, post_nms_rois_training=32,
                post_nms_rois_inference=32, train_rois_per_image=8, max_gt_instances=8, num_classes=4,
                backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64,
                mask_conv_channels=64, compute_dtype="float32", log_per_steps=1, prefetch_size=1)
    base.update(over)
    return MaskRCNNConfig(**base)


def worker(rank: int, size: int, init_method: str, full_model: bool = False) -> dict:
    """Checks 1-3 of the module's docstring on one gloo rank of the CPU."""
    group = distributed.initialize("gloo", rank, size, init_method, timeout_s=120, device="cpu")
    if distributed.initialize("gloo", rank, size, init_method, device="cpu") is not group:
        raise AssertionError("initialize is not idempotent")
    # (1) the loader's shards partition the order, counted by an all-reduce
    from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
    from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset

    ds = SyntheticShapesDataset()
    ds.load_shapes(16 * size, 64, 64, seed=3)
    ds.prepare()
    cfg = tiny_config(batch_size=2 * size)
    loader = DataLoader(ds, cfg, shuffle=True, seed=7, process_index=rank, process_count=size)
    order = np.arange(len(ds))
    np.random.RandomState(7).shuffle(order)
    owned = torch.zeros(len(ds))
    owned[torch.from_numpy(distributed.host_shard(order, rank, size))] = 1.0
    tdist.all_reduce(owned, group=group)
    if not torch.equal(owned, torch.ones(len(ds))):
        raise AssertionError(f"ownership counts {owned.tolist()}")
    if loader.batch_size != 2 or loader.steps_per_epoch != len(ds) // (2 * size):
        raise AssertionError((loader.batch_size, loader.steps_per_epoch))
    # (2) an all-reduce against its closed form
    v = torch.tensor([float(rank + 1)])
    tdist.all_reduce(v, group=group)
    if float(v) != size * (size + 1) / 2:
        raise AssertionError(float(v))
    out = {"rank": rank, "owned": int(owned.sum())}
    # (3) the data-parallel training step
    if full_model:
        from maskrcnn_tf2_tpu_torch.parallel.mesh import check_replicated
        from maskrcnn_tf2_tpu_torch.train.loop import step_generator
        from maskrcnn_tf2_tpu_torch.train.synthetic import synthetic_batch
        from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state, make_train_step

        cfg = tiny_config(batch_size=size, sync_bn=True)
        state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu", group=group)
        batch = synthetic_batch(cfg, 1, rank, "cpu")
        step = make_train_step(cfg, group)
        state, losses = step(state, batch, rng=step_generator(0, 0, rank))
        loss = float(losses["loss_sum"])
        if not np.isfinite(loss):
            raise AssertionError(losses)
        check_replicated(state.model, group, "the state after a step")
        out["loss_sum"] = loss
    return out


def signal_self_on(trigger: str) -> threading.Thread:
    """A thread that sends SIGTERM to this process's main thread once
    ``trigger`` exists (delivered to the main thread, never to a
    communication thread)."""

    def watch():
        while not os.path.exists(trigger):
            time.sleep(0.005)
        signal.pthread_kill(threading.main_thread().ident, signal.SIGTERM)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def preempt_worker(rank: int, size: int, init_method: str, workdir: str) -> dict:
    """The preemption drill of the module's docstring on one rank: rank 0's
    metric writer marks its second step, and rank 1 signals itself on that
    mark. Returns the step each rank stopped at and after the resume."""
    from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
    from maskrcnn_tf2_tpu_torch.parallel.mesh import check_replicated
    from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
    from maskrcnn_tf2_tpu_torch.train.loop import train_model

    group = distributed.initialize("gloo", rank, size, init_method, timeout_s=120, device="cpu")
    cfg = tiny_config(batch_size=size, epochs=2, checkpoints_dir=workdir)
    h = cfg.image_shape[0]
    ds = SyntheticShapesDataset()
    ds.load_shapes(4 * size, h, h, seed=3)  # 4 global steps an epoch
    ds.prepare()
    trigger = os.path.join(workdir, "sigterm_rank1")
    writes = []

    def writer(step, metrics):
        writes.append(step)
        if len(writes) == 2:
            open(trigger, "w").close()

    if rank == 1:
        signal_self_on(trigger)
    state = train_model(cfg, ds, metric_writer=writer, resume=False, device="cpu", group=group)
    stopped = int(state.step)
    steps = torch.tensor([stopped, -stopped], dtype=torch.float64)
    tdist.all_reduce(steps, op=tdist.ReduceOp.MAX, group=group)
    if steps[0] != -steps[1]:
        raise AssertionError(f"the ranks stopped at steps {float(steps[0])} and {-float(steps[1])}")
    pre_dir = os.path.join(ckpt_lib.checkpoint_dir(cfg), "preempt")
    pre_files = sorted(f for f in os.listdir(pre_dir) if f.endswith(".pt"))
    if pre_files != ["ckpt_0.pt"] or ckpt_lib.make_manager(cfg).latest_step() is not None:
        raise AssertionError(f"preemption checkpoints {pre_files}")
    if rank == 0 and writes != list(range(1, stopped + 1)):
        raise AssertionError(f"rank 0 wrote metrics at {writes}")
    if rank != 0 and writes:
        raise AssertionError(f"rank {rank} wrote metrics")
    resumed = train_model(cfg, ds, resume=True, device="cpu", group=group)
    check_replicated(resumed.model, group, "the resumed state")
    if int(resumed.step) != stopped + 4 or ckpt_lib.make_manager(cfg).latest_step() != 1:
        raise AssertionError(f"resumed to step {int(resumed.step)} from {stopped}")
    return {"rank": rank, "stopped": stopped, "resumed": int(resumed.step)}


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--full-model", action="store_true")
    ap.add_argument("--preempt", action="store_true", help="run the preemption drill")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    out = launch(worker, args.num_processes, (args.full_model,), args.timeout)
    print(f"multihost dryrun OK: {args.num_processes} gloo ranks, disjoint shards, all-reduce verified"
          + (f", loss_sum={out[0]['loss_sum']:.4f}" if args.full_model else ""))
    if args.preempt:
        with tempfile.TemporaryDirectory() as workdir:
            out = launch(preempt_worker, args.num_processes, (workdir,), args.timeout)
        print(f"preemption drill OK: every rank stopped at step {out[0]['stopped']} and resumed to "
              f"step {out[0]['resumed']}")


if __name__ == "__main__":
    main()
