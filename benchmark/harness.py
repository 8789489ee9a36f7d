"""What every cell shares: finding a cell's files by name, the seeded weights,
host-clock spans, the result line and the checks on the process.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its loop kind
(``loops/<kind>.py``), and each per-layer metric is read by
``layer_metrics/<metric>.py``. Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "maskrcnn_tf2_tpu")
CACHE_DIR = BENCH_DIR / ".cache"


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / kind / f"{name}.json") as f:
        return json.load(f)


def load_loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``layer_metrics/<metric>.py``'s ``read(trace) -> float | None``."""
    path = bench_dir / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_layer_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and per-layer metrics a cell reports: those that list
    it under ``workloads``, and those without that key whose end-to-end
    metric the cell reports."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) is not False]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if listed(m) or (listed(m) is None and m["moves"] in names)]
    return e2e, per


def program_config(cfg: dict):
    """The program's ``MaskRCNNConfig`` from a configuration file's keys."""
    from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig

    return MaskRCNNConfig.from_dict(cfg)


def run_config(cfg: dict, traffic: dict) -> dict:
    """The configuration as a cell runs it: the file's keys, then the mix's
    ``config_overrides`` (a serving threshold, say)."""
    return {**cfg, **traffic.get("config_overrides", {})}


# ---------------------------------------------------------------- weights


def seeded_state_dict(cfg: dict, seed: int, device) -> Dict:
    """The network's weights from ``seed``, made on ``device`` in one draw:
    every conv, transposed conv and FC kernel normal with std
    ``1/sqrt(fan_in)``, biases zero, batch norm the identity (scale 1, shift
    0, mean 0, variance 1). The names and shapes are the reference's, which
    are the port's."""
    import torch

    from benchmark.reference.model import Deconv, MaskRCNNReference

    with torch.device("meta"):
        meta = MaskRCNNReference(cfg, device="meta")
    deconv = {f"{n}.weight" for n, m in meta.named_modules() if isinstance(m, Deconv)}
    shapes = {k: v.shape for k, v in meta.state_dict().items()}
    kernels = [k for k, s in shapes.items() if k.endswith(".weight") and len(s) in (2, 4)]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(math.prod(shapes[k]) for k in kernels), generator=gen, device=device)
    out, off = {}, 0
    for k in kernels:
        s = shapes[k]
        fan_in = s[0] * s[2] * s[3] if k in deconv else math.prod(s[1:])
        out[k] = flat[off:off + math.prod(s)].view(s) / math.sqrt(fan_in)
        off += math.prod(s)
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith("running_var") or (k.endswith(".weight") and len(s) == 1):
            out[k] = torch.ones(s, device=device)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def serving_state_dict(cfg: dict, seed: int, calib_images: List, device) -> Tuple[Dict, float]:
    """The seed's weights with the class-logit kernel scaled to unit logits
    over ``calib_images`` (``reference.model.calibrate_class_logits``, in
    float32), so that the number of detections does not depend on the seed;
    and the seconds the reference took for that, which set-up leaves out."""
    from benchmark.reference import ops
    from benchmark.reference.model import calibrate_class_logits, load_reference, plain_float32

    state = seeded_state_dict(cfg, seed, device)
    sync(device)
    t = time.perf_counter()
    with plain_float32():
        ref = load_reference(cfg, state, device)
        del state
        calibrate_class_logits(ref, [ops.mold_image(img, cfg)[0] for img in calib_images])
    out = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    sync(device)
    return out, time.perf_counter() - t


# ---------------------------------------------------------------- spans


@dataclass
class Spans:
    """Host-clock spans ``(name, start, end)``, in memory; read only by the
    readers and the diagnostics. Thread-safe appends."""

    items: List[Tuple[str, float, float]] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, name: str, start: float, end: float) -> None:
        with self.lock:
            self.items.append((name, start, end))

    def durations(self, name: str) -> List[float]:
        return [e - s for n, s, e in self.items if n == name]

    def wrap(self, fn: Callable, name: str) -> Callable:
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(name, t, time.perf_counter())
        return wrapped


@contextlib.contextmanager
def patched(targets: List[Tuple[object, str, Callable]]):
    """Replace ``getattr(obj, name)`` by ``make(original)`` for each target,
    restoring the originals on exit."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    try:
        for obj, name, make in targets:
            setattr(obj, name, make(getattr(obj, name)))
        yield
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


# ---------------------------------------------------------------- the run


@dataclass
class Check:
    """One number compared: ``value`` must not exceed ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a loop hands back to ``run.py``."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak: int
    trace: Optional[object] = None  # a benchmark.trace.Trace of the traced window
    diagnostics: Dict[str, object] = field(default_factory=dict)


def forbidden_loaded() -> List[str]:
    """Top-level module names in ``sys.modules`` that the JAX side owns,
    compared whole (``maskrcnn_tf2_tpu_torch`` is not ``maskrcnn_tf2_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def set_cache_dirs() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout; the
    port's nvcc libraries already live in its ``_build/``."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(CACHE_DIR / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0


def host_rss_peak() -> int:
    """The process's peak resident host memory so far, bytes (Linux counts
    ``ru_maxrss`` in KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        return out[0].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
