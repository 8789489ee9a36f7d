"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the loops run on the CPU at a tiny
size), the rest of the run is driven as the benchmark drives it."""

import contextlib
import time

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

