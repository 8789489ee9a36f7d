"""Checkpoints of a training run (counterpart of
``maskrcnn_tf2_tpu/train/checkpoint.py``, which uses orbax managers).

The same contract in PyTorch's idiom: a ``CheckpointManager`` per directory
keeps one file per saved epoch (``torch.save`` to a temporary file, then
``os.replace``) and a small JSON index of the epochs and their metrics. The
main manager keeps the ``max_to_keep`` best checkpoints by ``val_loss_sum``
(else ``loss_sum``), the lowest first, when ``save_best_only`` is set, else
the newest; the preemption manager keeps the newest one, unranked. A
checkpoint holds the model's ``state_dict`` (float32 master weights and
batch-norm statistics), the optimizer state, the step and an optional
``extra`` dict of floats (the LR plateau's state). The directory is named
``maskrcnn_{backbone}_{md5[:8]}`` as the JAX package names it; orbax
checkpoints are not read.

In a data-parallel run (``group``) the ranks hold the same state: only the
primary rank writes, the others wait at a barrier until the file is there,
and every rank restores the same file. A state placed on a tensor-parallel
mesh (``parallel/gspmd.py``) holds a shard of the classifier head: every rank
joins ``gather_state_dict``, and world rank 0 writes the WHOLE state, so a
checkpoint never depends on the layout that wrote it. ``restore`` loads a
whole state into any layout: into a placed state it loads the whole leaves,
then slices them again (``place_state``), the counterpart of the JAX
package's restore across topologies.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.parallel import distributed, gspmd
from maskrcnn_tf2_tpu_torch.train.optimizer import OptState
from maskrcnn_tf2_tpu_torch.train.train_step import TrainState

_INDEX = "index.json"


def _write_atomic(path: str, write: Callable) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


class CheckpointManager:
    """Epoch checkpoints in ``directory`` with their metrics. ``best_fn``
    ranks a checkpoint by its metrics (kept lowest first); without it the
    newest ``max_to_keep`` are kept."""

    def __init__(self, directory: str, max_to_keep: int, best_fn: Optional[Callable[[Dict], float]] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.best_fn = best_fn
        os.makedirs(directory, exist_ok=True)
        index = os.path.join(directory, _INDEX)
        self._entries: List[Dict] = []
        if os.path.exists(index):
            with open(index) as f:
                self._entries = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(e["step"] for e in self._entries)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Dict[str, float]:
        return next(e["metrics"] for e in self._entries if e["step"] == step)

    def save(self, step: int, payload: Dict, metrics: Dict[str, float]) -> None:
        _write_atomic(self._path(step), lambda f: torch.save(payload, f))
        entries = [e for e in self._entries if e["step"] != step] + [{"step": step, "metrics": metrics}]
        if self.best_fn is not None:
            keep = sorted(entries, key=lambda e: (self.best_fn(e["metrics"]), -e["step"]))[: self.max_to_keep]
        else:
            keep = sorted(entries, key=lambda e: -e["step"])[: self.max_to_keep]
        keep = sorted(keep, key=lambda e: e["step"])
        _write_atomic(os.path.join(self.directory, _INDEX), lambda f: f.write(json.dumps(keep).encode()))
        for e in entries:
            if e not in keep:
                os.remove(self._path(e["step"]))
        self._entries = keep

    def restore(self, step: int, map_location) -> Dict:
        return torch.load(self._path(step), map_location=map_location, weights_only=True)


def checkpoint_dir(config: MaskRCNNConfig, base: Optional[str] = None) -> str:
    base = base or config.checkpoints_dir
    return os.path.abspath(os.path.join(base, f"maskrcnn_{config.backbone}_{config.md5()[:8]}"))


def _monitor(metrics: Dict[str, float]) -> float:
    return metrics.get("val_loss_sum", metrics.get("loss_sum", 0.0))


def make_manager(config: MaskRCNNConfig, base: Optional[str] = None, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(checkpoint_dir(config, base), max_to_keep,
                             best_fn=_monitor if config.save_best_only else None)


def make_preempt_manager(config: MaskRCNNConfig, base: Optional[str] = None) -> CheckpointManager:
    """Preemption (partial-epoch) checkpoints: their own subdirectory, one
    kept, no ranking, so that a partial epoch's train loss neither competes
    with nor evicts the epoch checkpoints."""
    return CheckpointManager(os.path.join(checkpoint_dir(config, base), "preempt"), max_to_keep=1)


def pick_resume_manager(manager: CheckpointManager, preempt_manager: Optional[CheckpointManager]):
    """The manager holding the newest checkpoint; ties go to the main one
    (its checkpoint saw the whole epoch)."""
    main_step = manager.latest_step()
    pre_step = preempt_manager.latest_step() if preempt_manager else None
    if pre_step is not None and (main_step is None or pre_step > main_step):
        return preempt_manager
    return manager


def save(manager: CheckpointManager, state: TrainState, epoch: int, metrics: Dict, extra: Optional[Dict] = None,
         group=None):
    """Save ``state`` as epoch ``epoch``'s checkpoint, with ``extra`` (floats).
    With ``group``, the primary rank writes and every rank returns after it.
    A state placed on a mesh is gathered whole first, on every rank of the
    mesh (``group`` is then its world)."""
    model_sd, slots = state.model.state_dict(), state.opt_state.slots
    mesh = gspmd.mesh_of(state.model)
    if mesh is not None:
        model_sd, slots = gspmd.gather_state_dict(state, mesh)
        group = mesh.world
    if group is not None and not distributed.is_primary(group):
        distributed.barrier(f"checkpoint {epoch}", group)
        return
    opt = state.opt_state
    payload = {
        "step": int(state.step),
        "model": model_sd,
        "opt_state": {"count": int(opt.count), "hyperparams": dict(opt.hyperparams), "slots": slots},
    }
    if extra:
        payload["extra"] = {k: float(v) for k, v in extra.items()}
    manager.save(epoch, payload, {k: float(v) for k, v in metrics.items()})
    if group is not None:
        distributed.barrier(f"checkpoint {epoch}", group)


def restore(
    manager: CheckpointManager,
    state: TrainState,
    step: Optional[int] = None,
    extra_template: Optional[Dict] = None,
) -> Tuple[TrainState, int, Optional[Dict]]:
    """Load the latest (or the given) checkpoint into ``state``, on its
    model's device: ``(state, start_epoch, extra)``. Without a checkpoint,
    ``(state, 0, None)``; ``extra`` is None when ``extra_template`` is None
    or the checkpoint has none. A state placed on a mesh is placed again
    after the load (this rank's shards of the whole state)."""
    target = step if step is not None else manager.latest_step()
    if target is None:
        return state, 0, None
    payload = manager.restore(target, map_location=next(state.model.parameters()).device)
    mesh = gspmd.mesh_of(state.model)
    if mesh is not None:
        gspmd.unplace_(state, state.model.config)
    state.model.load_state_dict(payload["model"])
    opt = payload["opt_state"]
    state.opt_state = OptState(opt["count"], dict(opt["hyperparams"]), opt["slots"])
    state.step = payload["step"]
    if mesh is not None:
        gspmd.place_state(state, mesh, state.model.config)
    extra = payload.get("extra") if extra_template is not None else None
    return state, int(target) + 1, extra
