"""TensorBoard scalar writer (counterpart of
``maskrcnn_tf2_tpu/utils/tb_writer.py``), through
``torch.utils.tensorboard``. Pass the returned callable as ``metric_writer``
to ``train_model``; it is None when the ``tensorboard`` package is absent,
as the JAX package's is without tensorflow."""

from __future__ import annotations

from typing import Callable, Dict, Optional


def make_tb_writer(logdir: str) -> Optional[Callable[[int, Dict[str, float]], None]]:
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # torch raises this when tensorboard is not installed
        return None
    writer = SummaryWriter(logdir)

    def write(step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            writer.add_scalar(k, v, global_step=step)
        writer.flush()

    return write
