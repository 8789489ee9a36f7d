"""Rank functions of the port's tensor-parallel tests (``test_torch_port_gspmd``),
run on four gloo ranks of the CPU through ``parallel.multihost_dryrun.launch``.
The spawned ranks import this module, so it imports no JAX: inputs come in as
numpy arrays and results go back as numpy arrays and checksums.

The world of four ranks is the DP2xTP2 mesh; ranks 0 and 1 are also a DP1xTP2
mesh (``make_mesh_2d(1, 2)``: the first two ranks, as JAX takes the first
devices), while rank 2 restores the checkpoint into one process."""

import os

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.layers import _AllReduceSum, copy_to_model_group, reduce_from_model_group
from maskrcnn_tf2_tpu_torch.parallel import distributed, gspmd
from maskrcnn_tf2_tpu_torch.parallel.mesh import check_replicated, make_mesh_2d, state_checksum
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.train_step import make_train_step

from torch_port_dp_workers import _np, _t, port_state

TIMEOUT_S = 300  # ranks 2 and 3 wait at a barrier while 0 and 1 run the DP1xTP2 cases


def _rows(arrays, mesh):
    """The data rank's rows of global arrays, as tensors."""
    n = mesh.n_data if mesh is not None else 1
    i = mesh.data_rank if mesh is not None else 0
    out = {}
    for k, v in arrays.items():
        b = v.shape[0] // n
        out[k] = torch.from_numpy(np.array(v[i * b:(i + 1) * b]))
    return out


def _checksums(model):
    """The bits of the replicated leaves and of the shards, as two checksums."""
    return (state_checksum(model, lambda k: gspmd.shard_dim(k) is None).numpy(),
            state_checksum(model, lambda k: gspmd.shard_dim(k) is not None).numpy())


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.classifier.state_dict().items()}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8) if t.is_floating_point() else t


def place_and_gather(cfg, state_dict, mesh):
    """A whole state with seeded optimizer slots, placed, then gathered:
    this rank's shards (by state-dict name) and whether every gathered
    tensor equals the whole state's bit for bit."""
    state = port_state(cfg, state_dict, None)
    gen = torch.Generator().manual_seed(5)
    slots = {k: [torch.randn(t.shape, generator=gen) for t in ts] for k, ts in state.opt_state.slots.items()}
    state.opt_state = state.opt_state._replace(slots=slots)
    whole_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    whole_slots = {k: [t.clone() for t in ts] for k, ts in slots.items()}
    gspmd.place_state(state, mesh, cfg)
    shards = _np({k: v for k, v in state.model.state_dict().items() if gspmd.shard_dim(k) is not None})
    sd, gathered = gspmd.gather_state_dict(state, mesh)
    equal = [torch.equal(_bits(sd[k]), _bits(v)) for k, v in whole_sd.items()]
    equal += [torch.equal(_bits(a), _bits(b)) for k in whole_slots for a, b in zip(gathered[k], whole_slots[k])]
    return {"shards": shards, "equal": (sum(equal), len(equal)), "shapes": _shapes(state.model)}


def operators(mesh):
    """A two-layer FC on seeded tensors, whole in one process and split over
    the model group (FC1 by output rows, FC2 by input columns) with
    ``copy_to_model_group`` and ``reduce_from_model_group``, and once more
    with ``_AllReduceSum`` as the exit: the gradients of the input and of
    every weight, each side's, sliced to this rank's shard."""
    gen = torch.Generator().manual_seed(3)
    x, w1, b1 = torch.randn(6, 10, generator=gen), torch.randn(8, 10, generator=gen), torch.randn(8, generator=gen)
    w2, b2, cot = torch.randn(5, 8, generator=gen), torch.randn(5, generator=gen), torch.randn(6, 5, generator=gen)
    k, m = mesh.n_model, mesh.model_rank
    cols = slice(m * 8 // k, (m + 1) * 8 // k)

    def grads(split, exit_op=None):
        leaves = [t.clone().requires_grad_(True) for t in
                  ((x, w1[cols], b1[cols], w2[:, cols], b2) if split else (x, w1, b1, w2, b2))]
        xs, a, ab, c, cb = leaves
        if split:
            h = torch.relu(F.linear(copy_to_model_group(xs, mesh.model_group), a, ab))
            y = exit_op(F.linear(h, c), mesh.model_group) + cb
        else:
            y = F.linear(torch.relu(F.linear(xs, a, ab)), c, cb)
        g = torch.autograd.grad((y * cot).sum(), leaves)
        return {"x": g[0], "w1": g[1] if split else g[1][cols], "b1": g[2] if split else g[2][cols],
                "w2": g[3] if split else g[3][:, cols], "b2": g[4]}

    whole, tp = grads(False), grads(True, reduce_from_model_group)
    naive = grads(True, lambda t, g: _AllReduceSum.apply(t, g))
    return {name: (whole[name].numpy(), tp[name].numpy(), naive[name].numpy()) for name in whole}


def tp_steps(cfg, state_dict, mesh, batch, draws, eval_draws=None, steps=2, root=None, keep=False):
    """``steps`` gspmd steps from the bridged whole state on ``mesh`` (the
    eval step's losses first, when ``eval_draws`` is given), with the
    replicated leaves and the shards checked after each step
    (``check_replicated``) and their checksums kept. With ``root`` the
    state after the first step is saved there (epoch 0). Every rank gathers
    the whole state after the first step; with ``keep`` it comes back, with
    its first adamax moments (by parameter name)."""
    state = port_state(cfg, state_dict, None)
    step, state = gspmd.make_gspmd_train_step(cfg, mesh, state)
    b, d = _rows(batch, mesh), _rows(draws, mesh)
    out = {"losses": [], "sums": [], "shapes": _shapes(state.model)}
    if eval_draws is not None:
        out["eval"] = _np(gspmd.make_gspmd_eval_step(cfg, mesh, state)(state, b, draws=_rows(eval_draws, mesh)))
    names = [n for n, _ in state.model.named_parameters()]
    for i in range(steps):
        state, lo = step(state, b, draws=d)
        out["losses"].append(_np(lo))
        check_replicated(state.model, None, f"the state after step {i}", mesh=mesh)
        out["sums"].append(_checksums(state.model))
        if i == 0:
            sd, slots = gspmd.gather_state_dict(state, mesh)  # a collective: every rank
            if keep:
                out["whole"] = _np(sd)
                out["mu"] = {n: m.numpy().copy() for n, m in zip(names, slots["mu"])}
            if root:
                ckpt_lib.save(ckpt_lib.make_manager(cfg, root), state, 0, {"loss_sum": 1.0})
    return out


def guard(cfg, state_dict, mesh, batch, draws):
    """A NaN pixel in data rank 1's image: every rank skips the update.
    Whether each rank's state is unchanged, and the losses."""
    batch = {k: np.array(v) for k, v in batch.items()}
    batch["images"][1, 5, 5, 0] = np.nan
    state = port_state(cfg, state_dict, None)
    step, state = gspmd.make_gspmd_train_step(cfg, mesh, state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, losses = step(state, _rows(batch, mesh), draws=_rows(draws, mesh))
    after = state.model.state_dict()
    return {"unchanged": all(torch.equal(after[k], v) for k, v in before.items()),
            "count": state.opt_state.count, "losses": _np(losses)}


def _saved(cfg, root):
    manager = ckpt_lib.make_manager(cfg, root)
    return manager.restore(manager.latest_step(), map_location="cpu")


def _equal_to_saved(sd, slots, saved):
    eq = [torch.equal(sd[k], v) for k, v in saved["model"].items()]
    eq += [torch.equal(a, b) for k in saved["opt_state"]["slots"]
           for a, b in zip(slots[k], saved["opt_state"]["slots"][k])]
    return sum(eq), len(eq)


def restore_onto(cfg, state_dict, mesh, root, batch, draws):
    """The checkpoint restored into a fresh state placed on ``mesh`` (or
    into one process, ``mesh=None``): whether the whole state it holds
    equals the saved one bit for bit, and its next step's losses."""
    state = port_state(cfg, state_dict, None)
    if mesh is not None:
        gspmd.place_state(state, mesh, cfg)
    state, start, _ = ckpt_lib.restore(ckpt_lib.make_manager(cfg, root), state)
    if mesh is not None:
        sd, slots = gspmd.gather_state_dict(state, mesh)
        step = make_train_step(cfg, mesh=mesh)
    else:
        sd, slots = state.model.state_dict(), state.opt_state.slots
        step = make_train_step(cfg)
    equal = _equal_to_saved(sd, slots, _saved(cfg, root))
    _, losses = step(state, _rows(batch, mesh), draws=_rows(draws, mesh))
    return {"start": start, "equal": equal, "losses": _np(losses), "step": state.step}


def placed_back(cfg, state_dict, mesh, root, batch, draws):
    """The checkpoint restored into one process's state, that state then
    placed on ``mesh``: its next step's losses."""
    state = port_state(cfg, state_dict, None)
    state, _, _ = ckpt_lib.restore(ckpt_lib.make_manager(cfg, root), state)
    step, state = gspmd.make_gspmd_train_step(cfg, mesh, state)
    _, losses = step(state, _rows(batch, mesh), draws=_rows(draws, mesh))
    return _np(losses)


def loop(loop_cfg, root):
    """``train_model`` in gspmd mode over the world: 1 epoch of 2 steps with
    validation. The checkpoint rank 0 wrote (whole shapes), the step, and
    whether this rank wrote one."""
    from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
    from maskrcnn_tf2_tpu_torch.train.loop import train_model

    cfg = MaskRCNNConfig.from_dict(loop_cfg)
    h = cfg.image_shape[0]
    ds, val = SyntheticShapesDataset(), SyntheticShapesDataset()
    ds.load_shapes(8, h, h, seed=5)
    val.load_shapes(2, h, h, seed=6)
    ds.prepare()
    val.prepare()
    writes = []
    save = ckpt_lib.CheckpointManager.save
    ckpt_lib.CheckpointManager.save = lambda self, step, *a: (writes.append(step), save(self, step, *a))
    try:
        state = train_model(cfg, ds, val, steps_per_epoch=2, resume=False, device="cpu", checkpoint_base=root)
    finally:
        ckpt_lib.CheckpointManager.save = save
    tdist.barrier()
    saved = _saved(cfg, root)
    return {"step": state.step, "writes": writes, "shapes": _shapes(state.model),
            "saved": {k: tuple(v.shape) for k, v in saved["model"].items() if k.startswith("classifier.")},
            "slots": {k: [tuple(t.shape) for t in ts] for k, ts in saved["opt_state"]["slots"].items()},
            "data_rank": gspmd.mesh_of(state.model).data_rank}


def tp_all(rank, size, init_method, configs, state_dict, batch, draws, eval_draws, root):
    """Everything ``test_torch_port_gspmd`` asks of the four ranks."""
    distributed.initialize("gloo", rank, size, init_method, timeout_s=TIMEOUT_S, device="cpu")
    mesh22 = make_mesh_2d(2, 2)
    mesh12 = make_mesh_2d(1, 2)  # ranks 0 and 1; None on 2 and 3
    cfg, bn_cfg, clip_cfg = (MaskRCNNConfig.from_dict(configs[k]) for k in ("tp", "tp_bn", "clipnorm"))
    out = {"rank": rank, "coords": (mesh22.data_rank, mesh22.model_rank)}
    out["place"] = place_and_gather(cfg, state_dict, mesh22)
    out["ops"] = operators(mesh22)
    out["dp2"] = tp_steps(cfg, state_dict, mesh22, batch, draws, eval_draws, keep=rank == 0)
    dp2 = os.path.join(root, "dp2")
    out["dp2_bn"] = tp_steps(bn_cfg, state_dict, mesh22, batch, draws, root=dp2, keep=rank == 0)
    out["guard"] = guard(bn_cfg, state_dict, mesh22, batch, draws)
    out["clipnorm"] = tp_steps(clip_cfg, state_dict, mesh22, batch, draws, steps=1, keep=rank == 0)
    if mesh12 is not None:
        out["dp1"] = tp_steps(cfg, state_dict, mesh12, batch, draws, eval_draws, keep=rank == 0)
        out["restore_dp1"] = restore_onto(bn_cfg, state_dict, mesh12, dp2, batch, draws)
    elif rank == 2:
        out["restore_one"] = restore_onto(bn_cfg, state_dict, None, dp2, batch, draws)
    tdist.barrier()
    out["placed_back"] = placed_back(bn_cfg, state_dict, mesh22, dp2, batch, draws)
    out["loop"] = loop(configs["loop"], os.path.join(root, "loop"))
    return out
