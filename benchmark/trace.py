"""The traced window: ``torch.profiler`` over the measured window, profiler
ranges around the kernel-carrying ops, and the reduction of the device's
activity into busy time, idle gaps, per-range device time and top ops.

The ranges are opened around the op's Python entry (``bench::nms`` around
``ops.nms.non_max_suppression``, ``bench::roi_align`` around
``ops.roi_align.pyramid_roi_align``), and a range's device time is that of every kernel whose launch the range
encloses on its thread, so a share reads the same work whatever kernels carry
it. Each call's inputs and outputs are kept as shapes (or, for NMS, the small
index tensors its bound needs) for ``bounds.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_RANGES = ("bench::nms", "bench::roi_align")
MARK = "bench::mark"


def _meta(t):
    import torch

    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@dataclass
class Trace:
    """What the traced window recorded. Times are seconds on
    ``time.perf_counter``'s clock, except where named ``_ns``."""

    spans: object  # harness.Spans
    window: Tuple[float, float] = (0.0, 0.0)
    marks: List[float] = field(default_factory=list)
    calls: Dict[str, list] = field(default_factory=dict)  # range name -> bound arguments per call
    busy_s: float = 0.0
    range_device_s: Dict[str, float] = field(default_factory=dict)
    range_kernels: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    work: Dict[str, float] = field(default_factory=dict)  # images, steps, ... in the window
    launches: Dict[str, int] = field(default_factory=dict)  # the port's kernel launch counters over the window
    cfg: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


@contextlib.contextmanager
def op_ranges(calls: Dict[str, list]):
    """Profiler ranges around the ops that carry the hand-written kernels,
    recording what each call's bound needs."""
    from torch.profiler import record_function

    from maskrcnn_tf2_tpu_torch.models import mask_rcnn
    from maskrcnn_tf2_tpu_torch.ops import detection, nms, roi_align
    from benchmark.harness import patched

    for name in DEVICE_RANGES:
        calls.setdefault(name, [])

    def nms_wrap(fn):
        def wrapped(boxes, scores, max_output_size, iou_threshold, valid=None, presorted=False):
            with record_function("bench::nms"):
                idx, ok = fn(boxes, scores, max_output_size, iou_threshold, valid=valid, presorted=presorted)
            calls["bench::nms"].append((scores, valid, presorted, idx, ok, boxes.shape))
            return idx, ok
        return wrapped

    def roi_wrap(fn):
        def wrapped(features, boxes, pool_size, image_shape, denominator=244.0):
            with record_function("bench::roi_align"):
                out = fn(features, boxes, pool_size, image_shape, denominator)
            calls["bench::roi_align"].append(([_meta(f) for f in features], boxes.detach(), pool_size,
                                              tuple(image_shape)))
            return out
        return wrapped

    with patched([(nms, "non_max_suppression", nms_wrap), (detection, "non_max_suppression", nms_wrap),
                  (roi_align, "pyramid_roi_align", roi_wrap), (mask_rcnn, "pyramid_roi_align", roi_wrap)]):
        yield  # proposal.py reaches NMS through nms.nms_padded_boxes, which reads the patched global


def nms_bound_ms(call) -> float:
    """The bound of one ``non_max_suppression`` call: its boxes in score
    order, as greedy NMS visits them."""
    import torch

    from benchmark.bounds import nms_bound

    scores, valid, presorted, idx, ok, shape = call
    b, n = shape[0], shape[1]
    valid = torch.ones((b, n), dtype=torch.bool) if valid is None else valid.cpu()
    idx, ok = idx.long().cpu(), ok.cpu()
    if presorted:
        positions, valid_s = idx, valid
    else:
        masked = torch.where(valid, scores.float().cpu(), -1e9)
        order = torch.sort(masked, dim=1, descending=True, stable=True).indices
        rank = torch.empty_like(order).scatter_(1, order, torch.arange(n).expand(b, n))
        positions, valid_s = torch.gather(rank, 1, idx), torch.gather(valid, 1, order)
    return max(nms_bound(torch.empty((b, n, 4), device="meta"), valid_s, positions, ok))


def bound_ms(name: str, call) -> float:
    from benchmark.bounds import roi_bound

    if name == "bench::nms":
        return nms_bound_ms(call)
    return max(roi_bound(*call))


def mark(trace: "Trace") -> None:
    """A zero-length profiler range ``bench::mark`` at the window's start or
    end, stamped on ``perf_counter``'s clock too: the two marks tie the
    profiler's clock to the host spans'."""
    import time

    from torch.profiler import record_function

    t = time.perf_counter()
    with record_function(MARK):
        pass
    trace.marks.append(t)


def reduce_events(trace: Trace, events) -> None:
    """Fill ``trace`` from the profiler's raw events over the window between
    its two marks."""
    import bisect

    marks = sorted(e.start_ns() for e in events if e.name() == MARK)
    if len(marks) < 2 or len(trace.marks) < 2:
        raise RuntimeError("the traced window's marks are missing from the profile")
    start_ns, end_ns = marks[0], marks[-1]
    host_offset_ns = start_ns - int(trace.marks[0] * 1e9)
    trace.window = (trace.marks[0], trace.marks[-1])
    dev, ranges, launches = [], [], {}
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CUDA") and (e.name() in DEVICE_RANGES or e.name() == MARK):
            continue  # the profiler's device-side copy of a range spans the gaps between its kernels
        if kind.endswith("CUDA"):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.linked_correlation_id(),
                        e.correlation_id()))
        elif e.name() in DEVICE_RANGES:
            ranges.append((e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and e.correlation_id():  # a CUDA runtime or driver call
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    dev = [d for d in dev if d[1] > start_ns and d[0] < end_ns]
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, *_ in dev:
        s, e = max(s, start_ns), min(e, end_ns)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > start_ns:
                gaps.append((start_ns, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < end_ns:
            gaps.append((cur_e, end_ns))
    trace.busy_s = busy / 1e9
    by_name: Dict[str, int] = {}
    for s, e, name, *_ in dev:
        by_name[name] = by_name.get(name, 0) + (e - s)
    trace.device_ops = [(n, t / 1e9) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    spans = sorted((s * 1e9 + host_offset_ns, e * 1e9 + host_offset_ns, n) for n, s, e in trace.spans.items)

    def host_label(mid):
        best = None
        for s, e, n in spans:
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "no host span"

    gaps.sort(key=lambda g: g[0] - g[1])
    trace.idle_gaps = [(host_label((a + b) / 2), (b - a) / 1e9) for a, b in gaps[:10]]
    # a kernel belongs to a range when its launch lies inside it on the range's thread
    per_thread: Dict[int, list] = {}
    for name, tid, s, e in ranges:
        per_thread.setdefault(tid, []).append((s, e, name))
    for lst in per_thread.values():
        lst.sort()
    trace.range_device_s = {n: 0.0 for n in DEVICE_RANGES}
    trace.range_kernels = {n: 0 for n in DEVICE_RANGES}
    for s, e, _, linked, corr in dev:
        launch = launches.get(linked) or launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        lst = per_thread.get(tid, [])
        i = bisect.bisect_right(lst, (t, float("inf"), "")) - 1  # ranges of one thread do not overlap
        if i >= 0 and lst[i][0] <= t <= lst[i][1]:
            trace.range_device_s[lst[i][2]] += (e - s) / 1e9
            trace.range_kernels[lst[i][2]] += 1


def launch_counters() -> Dict[str, object]:
    """The port's own launch counters (``kernels/_build.py::count_launch``)."""
    from maskrcnn_tf2_tpu_torch.kernels import nms, roi_align

    return {"greedy_nms": nms.greedy_nms, "roi_align": roi_align.roi_align,
            "roi_align_backward": roi_align.roi_align_backward}


@contextlib.contextmanager
def traced_window(trace: Trace, enabled: bool):
    """Profile the block when ``enabled``; on exit fill ``trace`` with the
    device's activity between the block's two ``mark`` calls."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities, record_shapes=False,
                   with_stack=False, profile_memory=False)
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    with op_ranges(trace.calls):
        prof.start()
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
    trace.launches = {k: c.launches - before[k] for k, c in counters.items()}
    reduce_events(trace, prof.profiler.kineto_results.events())
