"""The reader of the program's ``unmold.pool`` span (``unmold_pool_ms.offline``) on a synthetic window, and on a
program that records no such span (a program without the unmold pool, or a CPU device, whose host loop does not
use it)."""

import pytest

from benchmark import harness
from benchmark.trace import Trace
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.utils.profiling import Recorded, SpanRecord

MS = 1_000_000  # ns


def _span(name, batch, start_ms, dur_ms, n=None, parent=None):
    return SpanRecord(name, batch, parent, 7, int(start_ms * MS), int((start_ms + dur_ms) * MS), n)


def test_reads_the_median_pool_span(monkeypatch):
    spans = [_span("unmold.pool", b, 100 * b, d, n=8, parent="stream.unmold") for b, d in enumerate((20, 40, 30))]
    spans += [_span("unmold", b, 100 * b + 1, 15, n=100) for b in range(3)]  # the pool's threads' spans
    monkeypatch.setattr(profiling, "recorded", lambda start_s, end_s: Recorded(spans, [], 0))
    assert harness.load_reader("unmold_pool_ms.offline")(Trace(spans=None, window=(0.0, 1.0))) == pytest.approx(30.0)


def test_nothing_to_read_gives_none(monkeypatch):
    read = harness.load_reader("unmold_pool_ms.offline")
    host_loop = [_span("unmold", 0, 1, 15, n=100), _span("stream.unmold", 0, 0, 20)]
    monkeypatch.setattr(profiling, "recorded", lambda start_s, end_s: Recorded(host_loop, [], 0))
    assert read(Trace(spans=None, window=(0.0, 1.0))) is None
    assert read(Trace(spans=None)) is None  # an empty window
    monkeypatch.delattr(profiling, "recorded")  # a program without the tracer
    assert read(Trace(spans=None, window=(0.0, 1.0))) is None
