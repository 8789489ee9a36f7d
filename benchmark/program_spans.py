"""The arithmetic that the readers of the program's own spans and counters
share (``maskrcnn_tf2_tpu_torch/utils/profiling.py``: ``span``, ``count``,
``recorded``). Each reads what the program recorded inside the traced window
(``trace.window``, on ``time.perf_counter``'s clock, the clock of the
program's spans) and returns None when the window holds none of what it
reads, or when the program records nothing (a program without the tracer)."""

from __future__ import annotations

import statistics
from typing import Optional


def window_records(trace):
    """The program's ``Recorded`` spans and counts inside the window, or None."""
    try:
        from maskrcnn_tf2_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None or trace is None or trace.window[1] <= trace.window[0]:
        return None
    return recorded(*trace.window)


def median_span_ms(trace, name: str) -> Optional[float]:
    """Median duration of the window's spans ``name``, ms."""
    rec = window_records(trace)
    d = [(s.end - s.start) / 1e6 for s in rec.spans if s.name == name] if rec else []
    return statistics.median(d) if d else None


def counts_per_span(trace, counter: str, span: str) -> Optional[float]:
    """The window's counts of ``counter`` (their ``n`` summed) over its spans
    ``span``."""
    rec = window_records(trace)
    spans = sum(s.name == span for s in rec.spans) if rec else 0
    if not spans:
        return None
    return sum(c.n for c in rec.counts if c.name == counter) / spans


def median_us_per_unit(trace, name: str) -> Optional[float]:
    """Median, over the window's spans ``name`` with a work count ``n > 0``,
    of the span's duration over ``n``, microseconds."""
    rec = window_records(trace)
    d = [(s.end - s.start) / 1e3 / s.n for s in rec.spans if s.name == name and s.n] if rec else []
    return statistics.median(d) if d else None
