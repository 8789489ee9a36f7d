"""Profile any callable and read its device time by op name without
TensorBoard (counterpart of ``maskrcnn_tf2_tpu/utils/profiling.py``).

``trace(fn)`` runs ``fn`` under ``torch.profiler`` (CPU activities, and CUDA
activities when a card is visible) and writes a ``*.trace.json.gz`` Chrome
trace; ``top_ops`` sums the complete (``"X"``) events of every such trace in
a directory by name. The device's events are those the CUDA activity writes:
kernels, copies and memsets.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{os.getpid()}.{time.time_ns()}.trace.json.gz"))
    return trace_dir


def top_ops(trace_dir: str, k: int = 25, device_only: bool = True) -> List[Tuple[str, float]]:
    """The ``k`` names with the largest summed event duration (us), largest
    first, over every ``*.trace.json.gz`` under ``trace_dir``; with
    ``device_only``, only the device's events (none on the CPU)."""
    totals: dict = defaultdict(float)
    for path in glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True):
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            if device_only and str(ev.get("cat", "")).lower() not in DEVICE_CATEGORIES:
                continue
            totals[ev["name"]] += ev["dur"]
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]


def print_top_ops(trace_dir: str, k: int = 25):
    for name, us in top_ops(trace_dir, k):
        print(f"{us / 1e3:10.3f} ms  {name[:120]}")
