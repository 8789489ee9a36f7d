"""An offline pass over a dataset through ``Predictor.detect_stream``.

The mix gives the image ``size``, the ``batch_size`` and pipeline ``depth``
of the stream, and the ``pool`` of distinct images made from the seed. The
stream cycles the pool in an order drawn from the seed and is fed until
``seconds`` have passed; what is in flight then is drained, and the rate is
every image unmolded over the whole time, drain included. A sample of the
stream's first forwards, drawn from the seed, is checked against the
reference.

Like an offline pass over a data set, which writes each result and lets it
go, the loop keeps only the results of the sampled forwards' images, which
the check reads. Every other result is checked for what the API promises,
from its arrays' headers alone (``well_formed``), counted, and dropped, so
that host memory does not grow with the rate or the window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import images, serving
from benchmark.harness import Outcome, Spans, host_rss_peak, memory_peak, sync
from benchmark.trace import Trace, mark, traced_window


def stream_order(seed: int, traffic: dict):
    """(the order in which the stream cycles the pool, the indices of the
    forwards whose images are checked), both drawn from the seed."""
    rs = np.random.RandomState(np.random.SeedSequence([seed, 5]).generate_state(1)[0])
    order = rs.permutation(traffic["pool"])
    return order, sorted(rs.choice(traffic["sample_from"], traffic["sample_batches"], replace=False).tolist())


def well_formed(res: dict, shape) -> bool:
    """``res`` holds what a result promises for an image of ``shape``:
    ``masks`` a bool ndarray ``[H0, W0, N]`` for the image's own ``H0, W0``,
    and ``N`` rows of ``rois``, ``class_ids`` and ``scores``. Reads shapes
    and types only, no mask byte."""
    try:
        masks = res["masks"]
        if not (isinstance(masks, np.ndarray) and masks.dtype == np.bool_ and masks.ndim == 3
                and masks.shape[:2] == tuple(shape[:2])):
            return False
        return all(isinstance(res[k], np.ndarray) and res[k].shape[:1] == masks.shape[2:]
                   for k in ("rois", "class_ids", "scores"))
    except (KeyError, TypeError, AttributeError):
        return False


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
    keep = {k * bs + b for k in sample for b in range(bs)}  # the stream indices whose results the check reads
    kept, yielded, malformed, detections = {}, 0, 0, 0
    with capture.installed(), traced_window(tr, trace), \
            serving.stage_spans(spans):
        start = time.perf_counter()
        if trace:
            mark(tr)
        for res in predictor.detect_stream(feed(start + seconds), batch_size=bs, depth=depth):
            if well_formed(res, fed[yielded].shape):
                detections += len(res["class_ids"])
            else:
                malformed += 1
            if yielded in keep:
                kept[yielded] = res
            yielded += 1
            del res  # the loop holds no unsampled result past its turn
        if trace:
            mark(tr)
        end = time.perf_counter()
    peak = memory_peak(device)
    counted = yielded - malformed
    tr.work = {"images": counted, "seconds": end - start}
    del predictor

    failed = len(fed) - yielded + malformed
    batches = {k: (fed[k * bs:(k + 1) * bs], k * bs) for k in capture.records}
    items, unjudged = serving.items_from(capture, batches, kept)
    values = serving.readings(cfg, weights, items, device)
    unjudged += bs * sum(k not in capture.records for k in sample)  # a sampled batch that never ran
    checks = serving.checks(values, limits, unjudged)
    e2e = {"setup_s": setup_s, "serve_img_per_s": counted / (end - start)}
    diag = {"images": counted, "malformed": malformed, "batches": capture.calls,
            "seconds": end - start, "checked_images": len(items), "spans_ms": serving.span_medians(spans),
            "other_readings": {k: v for k, v in values.items() if k not in limits}, "calibration_s": calib_s,
            "detections_per_image": detections / max(counted, 1),
            "host_rss_peak_bytes": host_rss_peak()}
    return Outcome(e2e=e2e, attempted=len(fed), failed=failed, checks=checks, memory_peak=peak,
                   trace=tr if trace else None, diagnostics=diag)
