"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the loops run on the CPU at a tiny
size), the rest of the run is driven as the benchmark drives it."""

import contextlib
import time

import numpy as np
import pytest
import torch

from benchmark.harness import patched
from benchmark.loops import offline_stream
from benchmark.tests import tiny

def _correct(outcome) -> bool:
    return outcome.failed == 0 and all(c.ok for c in outcome.checks)


@contextlib.contextmanager
def altered_answer():
    """Each image's top detection gets another score where detections are made."""
    from maskrcnn_tf2_tpu_torch.models import mask_rcnn

    def make(fn):
        def wrapped(*args, **kwargs):
            det = fn(*args, **kwargs)
            det[:, 0, 5] = det[:, 0, 5] * 0.5
            return det
        return wrapped

    with patched([(mask_rcnn, "refine_detections", make)]):
        yield


def test_serving_sound_then_altered_answer_fails():
    cfg = tiny.serve_cfg()
    out = offline_stream.run({}, cfg, tiny.STREAM, 11, 1.0, False, time.perf_counter(), tiny.SERVE_LIMITS,
                             device="cpu")
    assert _correct(out)
    with altered_answer():
        out = offline_stream.run({}, cfg, tiny.STREAM, 11, 1.0, False, time.perf_counter(), tiny.SERVE_LIMITS,
                                 device="cpu")
    assert not _correct(out)


def test_serving_half_batch_left_out_fails():
    """The stream's forward runs on the first half of each batch and repeats it."""
    from maskrcnn_tf2_tpu_torch import predictor as pmod

    def make(fn):
        def wrapped(pred, molded, metas):
            h = max(len(molded) // 2, 1)
            det, masks = fn(pred, molded[:h], metas[:h])
            reps = -(-len(molded) // h)
            return torch.cat([det] * reps)[:len(molded)], torch.cat([masks] * reps)[:len(molded)]
        return wrapped

    with patched([(pmod.Predictor, "_forward", make)]):
        out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, 12, 1.0, False, time.perf_counter(),
                                 tiny.SERVE_LIMITS, device="cpu")
    assert not _correct(out)



UNSAMPLED_FAULTS = {
    "masks_transposed": lambda r: dict(r, masks=r["masks"].transpose(1, 0, 2)),
    "masks_not_bool": lambda r: dict(r, masks=r["masks"].astype(np.uint8)),
    "a_row_short": lambda r: dict(r, scores=r["scores"][1:]),
    "nothing": lambda r: {"rois": np.zeros((0, 4)), "class_ids": np.zeros(0), "scores": np.zeros(0),
                          "masks": np.zeros((0, 0, 0), bool)},
}


@pytest.mark.parametrize("fault", sorted(UNSAMPLED_FAULTS))
def test_serving_malformed_unsampled_results_fail(fault):
    """The stream's results outside the sampled forwards, which the check
    never reads, come back malformed: the run counts them as failed."""
    from maskrcnn_tf2_tpu_torch import predictor as pmod

    seed, bs = 14, tiny.STREAM["batch_size"]
    _, sample = offline_stream.stream_order(seed, tiny.STREAM)
    calls = []

    def make(fn):
        def wrapped(self, images, **kwargs):
            calls.append(1)
            for i, res in enumerate(fn(self, images, **kwargs)):
                window = len(calls) == 2  # the first call is the warm-up
                yield UNSAMPLED_FAULTS[fault](res) if window and i // bs not in sample else res
        return wrapped

    with patched([(pmod.Predictor, "detect_stream", make)]):
        out = offline_stream.run({}, tiny.serve_cfg(), tiny.STREAM, seed, 1.0, False, time.perf_counter(),
                                 tiny.SERVE_LIMITS, device="cpu")
    assert all(c.ok for c in out.checks)  # the sampled images are sound
    assert out.failed == out.diagnostics["malformed"] > 0 and not _correct(out)
