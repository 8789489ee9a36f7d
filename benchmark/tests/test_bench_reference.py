"""The plain reference against the port at a tiny size on the CPU, through
the benchmark's own loop: every stage of serving agrees (exactly where the
stage selects, to float32 round-off where it computes)."""

import time

from benchmark.loops import offline_stream
from benchmark.tests import tiny


def _values(outcome):
    return {c.name: c.value for c in outcome.checks}


def test_serving_stages_agree_in_float32():
    out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, 7, 1.0, True, time.perf_counter(),
                             tiny.SERVE_LIMITS, device="cpu")
    assert out.failed == 0 and all(c.ok for c in out.checks), _values(out)
    assert out.diagnostics["checked_images"] == tiny.STREAM["batch_size"] * tiny.STREAM["sample_batches"]
    assert out.trace.calls["bench::nms"] and out.trace.calls["bench::roi_align"]
    assert {n for n, _, _ in out.trace.spans.items} == {"ingress", "forward", "forward_fetch", "unmold"}


def test_serving_stages_agree_on_a_large_seed():
    out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, 2 ** 31 + 5, 1.0, False, time.perf_counter(),
                             tiny.SERVE_LIMITS, device="cpu")
    assert out.failed == 0 and all(c.ok for c in out.checks), _values(out)
