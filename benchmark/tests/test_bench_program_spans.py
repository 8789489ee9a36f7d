"""The readers of the program's own spans and counters
(``benchmark/program_spans.py`` and its four ``layer_metrics``) on a
synthetic window, on a program without the tracer, and on a traced run of
the offline loop at a tiny size on the CPU."""

import time

import pytest

from benchmark import harness, run
from benchmark.loops import offline_stream
from benchmark.tests import tiny
from benchmark.trace import Trace
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.utils.profiling import CountRecord, Recorded, SpanRecord

READERS = ("wait_ingress_ms.offline", "wait_device_ms.offline", "host_syncs.offline", "unmold_mask_us.offline")
MS = 1_000_000  # ns


def _span(name, batch, start_ms, dur_ms, n=None, parent=None):
    return SpanRecord(name, batch, parent, 7, int(start_ms * MS), int((start_ms + dur_ms) * MS), n)


def _sync(at_ms, n=1, span="forward.h2d"):
    return CountRecord("host_sync", int(at_ms * MS), span, 0, 7, n)


def _synthetic():
    """Three batches: waits 1, 3 and 2 ms for ingress and 0.5, 0.25 and 4 ms
    on the device; 9 + 9 + 10 syncs over three forwards; four images pasting
    10 masks in 15 ms, 4 in 8, 0 in 1 and 2 in 2."""
    spans = [_span("stream.wait_ingress", b, 10 * b, d) for b, d in enumerate((1, 3, 2))]
    spans += [_span("stream.wait_device", b, 10 * b + 5, d) for b, d in enumerate((0.5, 0.25, 4))]
    spans += [_span("forward", b, 10 * b + 4, 1) for b in range(3)]
    spans += [_span("unmold.masks", 0, 40 + i, d, n=n, parent="unmold")
              for i, (d, n) in enumerate(((15, 10), (8, 4), (1, 0), (2, 2)))]
    counts = [_sync(10 * b + 4, 7) for b in range(3)] + [_sync(10 * b + 4.5, 2, "forward.detection") for b in range(3)]
    counts += [_sync(25, 1, "stream.wait_device")]
    return Recorded(spans, counts, 0)


def _reader(name):
    return harness.load_reader(name)


def test_readers_on_a_synthetic_window(monkeypatch):
    asked = []

    def recorded(start_s, end_s):
        asked.append((start_s, end_s))
        return _synthetic()

    monkeypatch.setattr(profiling, "recorded", recorded)
    tr = Trace(spans=None, window=(1.5, 9.25))
    assert _reader("wait_ingress_ms.offline")(tr) == pytest.approx(2.0)
    assert _reader("wait_device_ms.offline")(tr) == pytest.approx(0.5)
    assert _reader("host_syncs.offline")(tr) == pytest.approx(28 / 3)
    assert _reader("unmold_mask_us.offline")(tr) == pytest.approx(1500.0)  # 1500, 2000, 1000 us a mask
    assert set(asked) == {(1.5, 9.25)}


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_on_nothing_to_read(monkeypatch, name):
    monkeypatch.setattr(profiling, "recorded", lambda start_s, end_s: Recorded([], [], 0))
    assert _reader(name)(Trace(spans=None, window=(1.0, 2.0))) is None
    assert _reader(name)(Trace(spans=None)) is None  # an empty window
    monkeypatch.delattr(profiling, "recorded")  # a program without the tracer
    assert _reader(name)(Trace(spans=None, window=(1.0, 2.0))) is None


def test_readers_window_the_programs_records():
    """Spans recorded under a profiler are read inside the window only."""
    import torch

    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("unmold.masks") as s:
            s.n = 4
        start = time.perf_counter()
        for n in (2, 3):
            with profiling.span("unmold.masks") as s:
                s.n = n
                time.sleep(0.002)
        end = time.perf_counter()
    got = _reader("unmold_mask_us.offline")(Trace(spans=None, window=(start, end)))
    assert 2000 / 3 <= got < 50_000


def test_traced_offline_loop_reports_the_programs_spans():
    """The offline loop traced at a tiny size on the CPU: ingress waits and
    pasted masks are read, no host sync is counted (there is no card) and
    there is no event to wait on."""
    out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, 13, 1.0, True, time.perf_counter(),
                             tiny.SERVE_LIMITS, device="cpu")
    bench = harness.load_benchmark()
    metrics = run.per_layer([m for m in bench["per_layer"] if m["name"] in READERS], out.trace)
    assert set(metrics) == {"wait_ingress_ms.offline", "host_syncs.offline", "unmold_mask_us.offline"}
    assert metrics["host_syncs.offline"]["value"] == 0.0
    assert metrics["wait_ingress_ms.offline"]["value"] >= 0 and metrics["unmold_mask_us.offline"]["value"] > 0
