"""The arithmetic that the per-layer readers (``layer_metrics/<metric>.py``)
share. Each reader takes the traced window (``benchmark.trace.Trace``) and
returns a number, or None when the window holds nothing for it to read."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark import flops
from benchmark.bounds import BF16_DENSE_FLOPS
from benchmark.trace import bound_ms


def median_ms(trace, span: str) -> Optional[float]:
    d = trace.spans.durations(span)
    return statistics.median(d) * 1e3 if d else None


def roofline(trace, rng: str) -> Optional[float]:
    """Percent: the calls' summed bound over the device time of every kernel
    launched inside their ranges."""
    calls = trace.calls.get(rng, [])
    device_s = trace.range_device_s.get(rng, 0.0)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound_ms(rng, c) for c in calls) / 1e3 / device_s


def idle_share(trace) -> Optional[float]:
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace) -> Optional[float]:
    """Percent of the card's dense bf16 peak that the model FLOPs of the
    window's images take over the window."""
    work = trace.work
    if not work.get("images") or work.get("seconds", 0) <= 0:
        return None
    return 100.0 * work["images"] * flops.inference_per_image(trace.cfg) / work["seconds"] / BF16_DENSE_FLOPS
