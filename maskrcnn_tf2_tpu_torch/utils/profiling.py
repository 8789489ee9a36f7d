"""Profile any callable and read its device time by op name without
TensorBoard (counterpart of ``maskrcnn_tf2_tpu/utils/profiling.py``), and the
port's own tracer.

``trace(fn)`` runs ``fn`` under ``torch.profiler`` (CPU activities on every
thread, and CUDA activities when a card is visible) and writes a
``*.trace.json.gz`` Chrome trace; ``top_ops`` sums the complete (``"X"``)
events of every such trace in a directory by name. The device's events are
those the CUDA activity writes: kernels, copies and memsets. ``idle_gaps``
finds the longest stretches with none of them running, each labelled with
what the program was doing then.

The tracer marks the serving path from inside (``predictor.py``,
``export/inference.py``, ``models/``, ``ops/``):

- ``with span(name, batch=None) as s:`` opens the profiler range
  ``"mrcnn::" + name`` (a function-scope range, ``_RecordFunctionFast``: it
  keeps the interpreter lock, and unlike ``record_function``'s user ranges
  it has no copy on the device's timeline, where it would read as device
  activity) and records ``(name, batch, parent, thread, start,
  end, n)`` in memory: ``start`` and ``end`` on ``time.perf_counter_ns``'s
  clock, ``parent`` the innermost span open on the same thread, ``batch``
  the id of the batch worked on (passed on worker threads, else the
  parent's), ``n`` a work count the body may set (``s.n = masks``);
- ``count(name, n=1)`` records ``(name, time, span, batch, thread, n)``;
  ``host_sync(device, n)`` counts ``HOST_SYNC`` for each call that makes the
  host wait for a CUDA device.

Both do nothing unless a ``torch.profiler`` profile is running, and nothing
while ``torch.export`` or ``torch.compile`` traces (the graphs stay as they
are): the off path reads one flag and returns a shared no-op context. Records
go into one bounded buffer (``BUFFER_SIZE``; the oldest are dropped, and
counted); ``recorded(start_s, end_s)`` returns those inside a
``time.perf_counter`` window.

Operators: run the work under ``trace`` (or any ``torch.profiler``
profile), then read ``recorded()`` for the spans and counts, and
``idle_gaps(trace_dir)`` for where the device waited.
"""

from __future__ import annotations

import collections
import glob
import gzip
import itertools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_RANGE_CATEGORIES = ("cpu_op", "user_annotation")
PREFIX = "mrcnn::"
HOST_SYNC = "host_sync"
NO_SPAN = "no program span"
BUFFER_SIZE = 1 << 18


def trace(fn: Callable[[], None], trace_dir: str | None = None) -> str:
    """Run ``fn`` under the profiler and write its trace into ``trace_dir``
    (default: a new ``mrcnn_trace_*`` temporary directory), which is
    returned."""
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="mrcnn_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread's ranges: the stream's ingress worker, the replicas' threads
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{os.getpid()}.{time.time_ns()}.trace.json.gz"))
    return trace_dir


def _trace_events(trace_dir: str):
    """The event list of each ``*.trace.json.gz`` under ``trace_dir``."""
    for path in sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True)):
        with gzip.open(path, "rt") as f:
            yield json.load(f).get("traceEvents", [])


def top_ops(trace_dir: str, k: int = 25, device_only: bool = True) -> List[Tuple[str, float]]:
    """The ``k`` names with the largest summed event duration (us), largest
    first, over every ``*.trace.json.gz`` under ``trace_dir``; with
    ``device_only``, only the device's events (none on the CPU)."""
    totals: dict = defaultdict(float)
    for events in _trace_events(trace_dir):
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            if device_only and str(ev.get("cat", "")).lower() not in DEVICE_CATEGORIES:
                continue
            totals[ev["name"]] += ev["dur"]
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]


def print_top_ops(trace_dir: str, k: int = 25):
    for name, us in top_ops(trace_dir, k):
        print(f"{us / 1e3:10.3f} ms  {name[:120]}")


class Gap(NamedTuple):
    """A stretch of a trace with no kernel, copy or memset running."""

    label: str  # the innermost program span the launching thread was in, or NO_SPAN
    seconds: float
    start_us: float  # on the trace's clock


def _file_gaps(events: List[dict]) -> List[Gap]:
    timed = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev and "ts" in ev]
    if not timed:
        return []
    device, launcher = [], {}
    ranges: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for ev in timed:
        cat = str(ev.get("cat", "")).lower()
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((start, end, corr))
        elif cat in LAUNCH_CATEGORIES and corr is not None:
            launcher[corr] = ev.get("tid")
        elif cat in HOST_RANGE_CATEGORIES and str(ev.get("name", "")).startswith(PREFIX):
            ranges[ev.get("tid")].append((start, end, ev["name"][len(PREFIX):]))
    if not device:
        return []
    trace_start = min(float(ev["ts"]) for ev in timed)
    trace_end = max(float(ev["ts"]) + float(ev["dur"]) for ev in timed)

    def label(at: float, corr) -> str:
        inside = [r for r in ranges.get(launcher.get(corr), ()) if r[0] <= at <= r[1]]
        return min(inside, key=lambda r: (r[1] - r[0], -r[0]))[2] if inside else NO_SPAN

    device.sort(key=lambda d: (d[0], d[1]))
    gaps, busy_end, last = [], trace_start, None
    for start, end, corr in device:
        if start > busy_end:
            gaps.append(Gap(label((busy_end + start) / 2, corr), (start - busy_end) / 1e6, busy_end))
        if last is None or end >= busy_end:
            last = corr  # the work that ends latest so far
        busy_end = max(busy_end, end)
    if trace_end > busy_end:
        gaps.append(Gap(label((busy_end + trace_end) / 2, last), (trace_end - busy_end) / 1e6, busy_end))
    return gaps


def idle_gaps(trace_dir: str, k: int = 10) -> List[Gap]:
    """The ``k`` longest stretches, longest first, over every
    ``*.trace.json.gz`` under ``trace_dir``, in which no kernel, copy or
    memset runs on the device (the union of the device's intervals, so
    overlapping work counts once), from the trace's first event to its last.
    Each gap is labelled with the innermost ``mrcnn::`` range open, at the
    gap's midpoint, on the thread that launched the device work ending the
    gap (the launch matched through the kernel's ``correlation``); a gap that
    no work ends takes the thread that launched the work before it. Without
    such a range the label is ``NO_SPAN``. ``[]`` on a trace with no device
    events (the CPU)."""
    gaps = [g for events in _trace_events(trace_dir) for g in _file_gaps(events)]
    return sorted(gaps, key=lambda g: (-g.seconds, g.start_us))[:k]


# ---------------------------------------------------------------- the tracer


class SpanRecord(NamedTuple):
    name: str
    batch: Optional[int]
    parent: Optional[str]
    thread: int  # threading.get_native_id(), the Chrome trace's tid
    start: int  # time.perf_counter_ns()
    end: int
    n: Optional[int]


class CountRecord(NamedTuple):
    name: str
    time: int  # time.perf_counter_ns()
    span: Optional[str]  # the innermost open span on the thread
    batch: Optional[int]
    thread: int
    n: int


class Recorded(NamedTuple):
    spans: List[SpanRecord]
    counts: List[CountRecord]
    dropped: int  # records the buffer let go since it was last cleared


_records: collections.deque = collections.deque(maxlen=BUFFER_SIZE)
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_batch_ids = itertools.count()


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()
    batch = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def n(self):
        return None

    @n.setter
    def n(self, value):
        pass


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _append(record) -> None:
    global _dropped
    with _lock:
        if len(_records) == _records.maxlen:
            _dropped += 1
        _records.append(record)


class _Span:
    __slots__ = ("name", "batch", "parent", "n", "_range", "_start")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch, self.n = name, batch, None

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        stack.append(self)
        self._start = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _append(SpanRecord(self.name, self.batch, self.parent, threading.get_native_id(), self._start, end, self.n))
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager timing its block as the span ``name`` (see the
    module's docstring); the shared no-op context while tracing is off."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, batch)


def count(name: str, n: int = 1) -> None:
    """Record ``n`` occurrences of ``name`` now, under the innermost open span."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return
    stack = _stack()
    outer = stack[-1] if stack else None
    _append(CountRecord(name, time.perf_counter_ns(), outer.name if outer is not None else None,
                        outer.batch if outer is not None else None, threading.get_native_id(), n))


def host_sync(device: torch.device, n: int = 1) -> None:
    """Count ``n`` calls that make the host wait for ``device`` (copies from
    pageable host memory, fetches, event waits): only for a CUDA device."""
    if _autograd_profiler._is_profiler_enabled and device.type == "cuda":
        count(HOST_SYNC, n)


def new_batch() -> int:
    """A new batch id, unique in the process."""
    return next(_batch_ids)


def recorded(start_s: float = float("-inf"), end_s: float = float("inf")) -> Recorded:
    """The spans that start and end, and the counts made, inside the
    ``time.perf_counter`` window ``[start_s, end_s]`` (seconds), in the order
    they were recorded."""
    lo, hi = start_s * 1e9, end_s * 1e9
    with _lock:
        items, dropped = list(_records), _dropped
    return Recorded([r for r in items if isinstance(r, SpanRecord) and lo <= r.start and r.end <= hi],
                    [r for r in items if isinstance(r, CountRecord) and lo <= r.time <= hi], dropped)


def clear() -> None:
    """Empty the buffer."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
