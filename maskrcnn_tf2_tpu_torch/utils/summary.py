"""Model summary: parameter counts (counterpart of
``maskrcnn_tf2_tpu/utils/summary.py``; for the same configuration the string
``summarize`` returns equals the JAX package's)."""

from __future__ import annotations

from torch import nn

_BN = nn.modules.batchnorm._BatchNorm


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def summarize(model: nn.Module, per_module: bool = True) -> str:
    """Per top-level module parameter counts (sorted by name), the total, and
    the batch norms' running mean and variance entries (the flax
    ``batch_stats``)."""
    lines = []
    if per_module:
        for name, child in sorted(model.named_children()):
            n = count_params(child)
            if n:
                lines.append(f"  {name:20s} {n:>12,d}")
    stats = sum(m.running_mean.numel() + m.running_var.numel() for m in model.modules()
                if isinstance(m, _BN) and m.running_mean is not None)
    lines.append(f"Total params:        {count_params(model):>12,d}")
    lines.append(f"BatchNorm stats:     {stats:>12,d}")
    return "\n".join(lines)
