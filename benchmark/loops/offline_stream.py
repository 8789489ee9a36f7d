"""An offline pass over a dataset through ``Predictor.detect_stream``.

The mix gives the image ``size``, the ``batch_size`` and pipeline ``depth``
of the stream, and the ``pool`` of distinct images made from the seed. The
stream cycles the pool in an order drawn from the seed and is fed until
``seconds`` have passed; what is in flight then is drained, and the rate is
every image unmolded over the whole time, drain included. A sample of the
stream's first forwards, drawn from the seed, is checked against the
reference.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import images, serving
from benchmark.harness import Outcome, Spans, memory_peak, sync
from benchmark.trace import Trace, mark, traced_window


def stream_order(seed: int, traffic: dict):
    """(the order in which the stream cycles the pool, the indices of the
    forwards whose images are checked), both drawn from the seed."""
    rs = np.random.RandomState(np.random.SeedSequence([seed, 5]).generate_state(1)[0])
    order = rs.permutation(traffic["pool"])
    return order, sorted(rs.choice(traffic["sample_from"], traffic["sample_batches"], replace=False).tolist())


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t0: float,
        limits: dict, control=None, device="cuda") -> Outcome:
    bs, depth = traffic["batch_size"], traffic["depth"]
    pool = images.image_pool(seed, [tuple(traffic["size"])], traffic["pool"])
    order, sample = stream_order(seed, traffic)

    predictor, weights, calib_s = serving.make_predictor(cfg, seed, pool[:2], control, device=device)
    for _ in predictor.detect_stream(pool[:bs * (depth + 2)], batch_size=bs, depth=depth):
        pass  # every stage of the pipeline at the window's shapes; the first call builds the kernels
    sync(device)
    setup_s = time.perf_counter() - t0 - calib_s  # the reference's calibration is not the program's set-up

    fed = []

    def feed(deadline):
        i = 0
        while time.perf_counter() < deadline:
            img = pool[order[i % len(pool)]]
            fed.append(img)
            i += 1
            yield img

    capture = serving.Capture(sample)
    spans = Spans()
    tr = Trace(spans=spans, cfg=cfg)
    results = []
    with capture.installed(), traced_window(tr, trace), \
            serving.stage_spans(spans):
        start = time.perf_counter()
        if trace:
            mark(tr)
        for res in predictor.detect_stream(feed(start + seconds), batch_size=bs, depth=depth):
            results.append(res)
        if trace:
            mark(tr)
        end = time.perf_counter()
    peak = memory_peak(device)
    tr.work = {"images": len(results), "seconds": end - start}
    del predictor

    failed = len(fed) - len(results)
    batches = {k: (fed[k * bs:(k + 1) * bs], k * bs) for k in capture.records}
    items, unjudged = serving.items_from(capture, batches, results)
    values = serving.readings(cfg, weights, items, device)
    unjudged += bs * sum(k not in capture.records for k in sample)  # a sampled batch that never ran
    checks = serving.checks(values, limits, unjudged)
    e2e = {"setup_s": setup_s, "serve_img_per_s": len(results) / (end - start)}
    diag = {"images": len(results), "batches": capture.calls, "seconds": end - start,
            "checked_images": len(items), "spans_ms": serving.span_medians(spans),
            "other_readings": {k: v for k, v in values.items() if k not in limits}, "calibration_s": calib_s,
            "detections_per_image": float(np.mean([len(r["class_ids"]) for r in results]))}
    return Outcome(e2e=e2e, attempted=len(fed), failed=failed, checks=checks, memory_peak=peak,
                   trace=tr if trace else None, diagnostics=diag)
