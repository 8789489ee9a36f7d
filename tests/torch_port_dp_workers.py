"""Rank functions of the port's multi-process tests, run on gloo ranks of the
CPU through ``parallel.multihost_dryrun.launch``. The spawned ranks import
this module, so it imports no JAX: inputs come in as numpy arrays and
results go back as numpy arrays."""

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.layers import BatchNorm, sync_batch_norms_
from maskrcnn_tf2_tpu_torch.parallel import distributed
from maskrcnn_tf2_tpu_torch.train.train_step import (create_train_state, fused_all_reduce_mean, make_eval_step,
                                                     make_train_step)


def _join(rank, size, init_method):
    return distributed.initialize("gloo", rank, size, init_method, timeout_s=60, device="cpu")


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def port_state(cfg, state_dict, group):
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu", group=group)
    state.model.load_state_dict(_t(state_dict))
    return state


def _steps(cfg, state_dict, group, batch, draws, eval_draws):
    """The eval step's losses, then two data-parallel training steps from
    ``state_dict``: the state and losses after each, and the reduced
    gradients of the first as the optimizer saw them (its first adamax
    moment, ``mu = (1 - b1) * g`` from zero)."""
    state = port_state(cfg, state_dict, group)
    eval_losses = make_eval_step(cfg, group)(state, batch, draws=eval_draws)
    step = make_train_step(cfg, group)
    names = [n for n, _ in state.model.named_parameters()]
    states, step_losses, mu = [], [], None
    for _ in range(2):
        state, lo = step(state, batch, draws=draws)
        if mu is None:
            mu = {n: m.numpy().copy() for n, m in zip(names, state.opt_state.slots["mu"])}
        states.append(_np(state.model.state_dict()))
        step_losses.append(_np(lo))
    return {"mu": mu, "eval": _np(eval_losses), "losses": step_losses, "states": states}


def _guard(cfg, state_dict, group, rank, batch, draws):
    """Rank 1's batch holds a NaN pixel: the reduced loss is not finite, so
    every rank skips the update. Returns the state before and after, and the
    step's losses."""
    batch = {k: v.clone() for k, v in batch.items()}
    if rank == 1:
        batch["images"][0, 5, 5, 0] = float("nan")
    state = port_state(cfg, state_dict, group)
    before = _np(state.model.state_dict())
    count = state.opt_state.count
    state, losses = make_train_step(cfg, group)(state, batch, draws=draws)
    return {"before": before, "after": _np(state.model.state_dict()), "losses": _np(losses),
            "count": (count, state.opt_state.count), "step": state.step}


def _world_one(cfg, state_dict, group, batch, draws):
    """Two data-parallel steps on a group of one rank against two of
    ``make_train_step`` on the same state: ``{name: bit-equal}`` over the
    state, the losses and the optimizer's slots."""
    out = {}
    for name, g in (("dp", group), ("plain", None)):
        state = port_state(cfg, state_dict, None)
        for _ in range(2):
            state, losses = make_train_step(cfg, g)(state, _t(batch), draws=_t(draws))
        out[name] = (_np(state.model.state_dict()), _np(losses), state.opt_state.slots)
    (sd_dp, lo_dp, slots_dp), (sd, lo, slots) = out["dp"], out["plain"]
    equal = {k: bool(np.array_equal(sd_dp[k], v)) for k, v in sd.items()}
    equal.update({f"loss:{k}": bool(np.array_equal(lo_dp[k], v, equal_nan=True)) for k, v in lo.items()})
    equal.update({f"slot:{k}:{i}": bool(torch.equal(a, b)) for k in slots for i, (a, b)
                  in enumerate(zip(slots_dp[k], slots[k]))})
    return equal


def dp_all(rank, size, init_method, configs, state_dict, batches, draws, eval_draws, leaves, one):
    """Everything ``test_torch_port_parallel`` asks of one gloo group, on
    rank ``rank``: ``fused_all_reduce_mean`` of this rank's ``leaves``;
    ``_steps`` under each of ``configs`` (``{key: config dict}``); the guard
    under the first; and, on rank 0 in a group of its own, ``_world_one`` on
    ``one = (batch, draws)``."""
    group = _join(rank, size, init_method)
    out = {"fused": [t.numpy() for t in fused_all_reduce_mean([torch.from_numpy(x) for x in leaves[rank]], group)]}
    batch, d, ed = _t(batches[rank]), _t(draws[rank]), _t(eval_draws[rank])
    for key, cfg_dict in configs.items():
        out[key] = _steps(MaskRCNNConfig.from_dict(cfg_dict), state_dict, group, batch, d, ed)
    cfg = MaskRCNNConfig.from_dict(next(iter(configs.values())))
    out["guard"] = _guard(cfg, state_dict, group, rank, batch, d)
    alone, _ = torch.distributed.new_subgroups(1)
    if rank == 0:
        out["world_one"] = _world_one(cfg, state_dict, alone, *one)
    return out


def sync_bn(rank, size, init_method, x, weight, bias, stats, cot, dims):
    """A ``BatchNorm`` with the group over this rank's rows of ``x``: its
    output, input gradient (of ``sum(y * cot)``) and running statistics."""
    group = _join(rank, size, init_method)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
    sync_batch_norms_(bn, group).train()
    b = x.shape[0] // size
    xs = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_(True)
    if dims == 4:
        xs = xs.contiguous(memory_format=torch.channels_last)
    y = bn(xs)
    (gx,) = torch.autograd.grad((y * torch.from_numpy(cot[rank * b:(rank + 1) * b])).sum(), xs)
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "mean": bn.running_mean.numpy().copy(),
            "var": bn.running_var.numpy().copy()}


def train_run(rank, size, init_method, cfg_dict, root, resume):
    """``train_model`` on synthetic shapes under the group, from scratch or
    resumed from ``root``'s newest checkpoint. Returns the history, the
    final state and the epochs whose checkpoint this rank wrote."""
    from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
    from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
    from maskrcnn_tf2_tpu_torch.train.loop import train_model

    writes = []
    save = ckpt_lib.CheckpointManager.save
    ckpt_lib.CheckpointManager.save = lambda self, step, *a: (writes.append(step), save(self, step, *a))
    group = _join(rank, size, init_method)
    cfg = MaskRCNNConfig.from_dict(cfg_dict)
    h, w, _ = cfg.image_shape
    ds, val = SyntheticShapesDataset(), SyntheticShapesDataset()
    ds.load_shapes(8, h, w, seed=5)
    val.load_shapes(4, h, w, seed=6)
    ds.prepare()
    val.prepare()
    history = []
    state = train_model(cfg, ds, val, resume=resume, device="cpu", history=history, group=group,
                        checkpoint_base=root)
    return {"history": history, "state": _np(state.model.state_dict()), "step": state.step, "writes": writes}


def cli_run(rank, size, init_method, argv, tiny):
    """``cli.coco_train.main(argv)`` as ``torchrun`` would start it: the
    rank's environment set, the widths made tiny through the CLI's
    ``coco_config``."""
    import os

    from maskrcnn_tf2_tpu_torch.cli import coco_train
    from maskrcnn_tf2_tpu_torch.config import coco_config

    host, port = init_method[len("tcp://"):].rsplit(":", 1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size),
                      MASTER_ADDR=host, MASTER_PORT=port)
    coco_train.coco_config = lambda **kw: coco_config(**{**tiny, **kw})
    state = coco_train.main(argv)
    return {"step": state.step, "state": _np(state.model.state_dict()),
            "sync": [m.group is not None for m in state.model.modules() if isinstance(m, BatchNorm)]}


def fail_on_rank_one(rank, size, init_method):
    _join(rank, size, init_method)
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()  # rank 0 waits for a rank that never comes


def hang_on_rank_one(rank, size, init_method):
    import time

    if rank == 1:
        time.sleep(600)
    return rank
