"""The offline loop keeps only the results its check reads: the sampled
forwards' images, by their index in the stream. It counts every other result
and lets it go, and its rate, failures and checks are those of a loop that
kept everything. At a tiny size on the CPU."""

import contextlib
import time
import weakref

from benchmark import serving
from benchmark.harness import patched
from benchmark.loops import offline_stream
from benchmark.tests import tiny


@contextlib.contextmanager
def window_results(hold: bool):
    """The window's results as ``Predictor.detect_stream`` yields them (its
    second call; the first is the warm-up): the results themselves when
    ``hold``, else weak references to their masks, with the most of the
    window's unsampled results alive at any yield."""
    from maskrcnn_tf2_tpu_torch import predictor as pmod

    seen = {"calls": 0, "results": [], "refs": [], "alive_max": 0}

    def make(fn):
        def wrapped(self, images, **kwargs):
            seen["calls"] += 1
            for res in fn(self, images, **kwargs):
                if seen["calls"] == 2:
                    if hold:
                        seen["results"].append(res)
                    else:
                        seen["refs"].append(weakref.ref(res["masks"]))
                        alive = sum(r() is not None for r in seen["refs"][:-1])
                        seen["alive_max"] = max(seen["alive_max"], alive)
                yield res
        return wrapped

    with patched([(pmod.Predictor, "detect_stream", make)]):
        yield seen


def test_keeps_the_sampled_results_and_counts_every_one():
    seed, bs = 2 ** 31 + 21, tiny.STREAM["batch_size"]
    _, sample = offline_stream.stream_order(seed, tiny.STREAM)
    handed = {}

    def spy(fn):
        def wrapped(capture, batches, results):
            handed.update(capture=capture, batches=batches, results=results)
            return fn(capture, batches, results)
        return wrapped

    with window_results(hold=True) as seen, patched([(serving, "items_from", spy)]):
        out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, seed, 1.0, False, time.perf_counter(),
                                 tiny.SERVE_LIMITS, device="cpu")
    everything = seen["results"]
    assert out.diagnostics["images"] == len(everything) and out.diagnostics["malformed"] == 0
    assert out.failed == out.attempted - len(everything) == 0
    kept = handed["results"]
    assert set(kept) == {k * bs + b for k in sample for b in range(bs)} and len(everything) > len(kept)
    assert all(kept[i] is everything[i] for i in kept)
    items, _ = serving.items_from(handed["capture"], handed["batches"], kept)
    all_items, _ = serving.items_from(handed["capture"], handed["batches"], dict(enumerate(everything)))
    assert [it["result"] for it in items] == [it["result"] for it in all_items]
    assert len(items) == out.diagnostics["checked_images"] == bs * len(sample)
    assert out.failed == 0 and all(c.ok for c in out.checks)


def test_lets_the_unsampled_results_go():
    """At no yield do more than two batches of the window's earlier unsampled
    results stay alive, over a window of many more."""
    seed, bs = 2 ** 31 + 22, tiny.STREAM["batch_size"]
    with window_results(hold=False) as seen:
        out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, seed, 2.0, False, time.perf_counter(),
                                 tiny.SERVE_LIMITS, device="cpu")
    assert len(seen["refs"]) == out.diagnostics["images"] > 6 * bs
    assert seen["alive_max"] <= 2 * bs + bs * tiny.STREAM["sample_batches"]
    assert out.diagnostics["host_rss_peak_bytes"] > 0
