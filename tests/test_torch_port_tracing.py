"""The port's tracer (``maskrcnn_tf2_tpu_torch/utils/profiling.py``: ``span``,
``count``, ``recorded``, ``idle_gaps``) and its spans in the serving path,
on the CPU at the tiny configuration of ``test_torch_port_serving.py``.

Off means off: without a profiler ``detect`` and ``detect_stream`` record
nothing and never open a profiler range. Under ``torch.profiler`` every span
the CPU path opens is recorded with its parent and its batch's id, and is a
``mrcnn::`` range of the same duration in the profiler's trace; the results
are bit-equal either way, and the exported forward's graph is the same.

The card-only test (``-m gpu``; run with ``--noconftest`` on the card, which
has no JAX) holds the ``host_sync`` count of one ``detect`` batch and one
``detect_stream`` batch against the synchronizing calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports for them.
"""

import collections
import gc
import gzip
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export.serialize import export_served
from maskrcnn_tf2_tpu_torch.models import quant
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=10, num_classes=4,
            backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
            compute_dtype="float32", detection_min_confidence=0.0)
FORWARD_CHILDREN = ("forward.h2d", "forward.backbone_fpn_rpn", "forward.proposals", "forward.classifier",
                    "forward.detection", "forward.mask", "forward.gather")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def _state(cfg):
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():  # spread the RPN scores: saturated scores tie
        model.rpn.rpn_class_raw.weight.mul_(0.1)
    return model.state_dict()


@pytest.fixture(scope="module")
def state():
    return _state(MaskRCNNConfig(**TINY))


@pytest.fixture(scope="module")
def predictor(state):
    return Predictor(MaskRCNNConfig(**TINY), state, device="cpu")


def _images():
    rs = np.random.RandomState(4)
    return [rs.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in [(64, 64), (50, 80), (90, 60), (40, 40)]]


def _serve(pred):
    """One ``detect`` of two images, then a ``detect_stream`` of three images
    at batch 2 (a full batch and a padded one)."""
    images = _images()
    return pred.detect(images[:2]), list(pred.detect_stream(iter(images[1:]), batch_size=2, depth=1))


def _profiled(fn, trace_dir):
    """``fn()`` under ``profiling.trace``, with the garbage collector paused:
    a collection that starts between a span's stamp and its range's would
    part the two clocks' durations by its own."""
    out = []
    gc.disable()
    try:
        profiling.trace(lambda: out.append(fn()), trace_dir)
    finally:
        gc.enable()
    return out[0], profiling.recorded()


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_off_records_nothing_and_opens_no_range(predictor, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    detected, streamed = _serve(predictor)
    assert sum(len(r["class_ids"]) for r in detected + streamed) > 0
    assert profiling.recorded() == ([], [], 0)
    off = profiling.span("forward", batch=3)
    assert off is profiling.span("unmold") and off.batch is None
    with off as s:
        s.n = 5  # the body's work count goes nowhere
    assert s.n is None
    profiling.count("host_sync", 4)
    profiling.host_sync(torch.device("cpu"))
    assert profiling.recorded() == ([], [], 0)


def test_spans_parents_batches_and_the_profilers_ranges(predictor, tmp_path):
    (detected, streamed), rec = _profiled(lambda: _serve(predictor), str(tmp_path))
    # no host waits without a card; the masks copied out of the three batches' blocks, the images of the two
    # batches of two handed to the unmold pool
    assert collections.Counter(c.name for c in rec.counts) == {"unmold.device_masks": 3, "unmold.pooled_images": 2}
    assert rec.dropped == 0
    spans = rec.spans
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)

    (detect,) = by_name["detect"]
    assert detect.parent is None and detect.batch is not None
    in_detect = [s for s in spans if detect.start <= s.start and s.end <= detect.end and s is not detect]
    pooled = ("unmold", "unmold.masks")  # on the unmold pool's threads
    assert all(s.batch == detect.batch and (s.thread == detect.thread) != (s.name in pooled) for s in in_detect)
    names = collections.Counter(s.name for s in in_detect)
    assert names == collections.Counter({"ingress": 2, "forward": 1, "paste": 1, "fetch": 1, "unmold.pool": 1,
                                         "unmold": 2, "unmold.masks": 2, **{c: 1 for c in FORWARD_CHILDREN}})

    # the stream: batches 0 (images 1-2) and 1 (image 3, padded), ids after the request's; at depth 1 this
    # thread's three turns launch 0, launch 1 and drain 0, and drain 1
    prep, waits, launches, devices, unmolds, steps = (by_name[n] for n in (
        "stream.prep", "stream.wait_ingress", "stream.launch", "stream.wait_device", "stream.unmold", "stream.step"))
    batches = [s.batch for s in launches]
    assert len(batches) == 2 and len(set(batches)) == 2 and min(batches) > detect.batch
    assert [s.batch for s in steps] == batches + batches[-1:] and all(s.parent is None for s in steps)
    for group in (prep, waits, unmolds):
        assert sorted(s.batch for s in group) == sorted(batches)
    assert devices == []  # no event on the CPU
    main = detect.thread
    assert all(s.thread == main for s in steps + waits + launches + unmolds) and all(s.thread != main for s in prep)

    # a batch of several images unmolds on the pool's threads, where no span is open; one image, inline
    parents = {"ingress": {"detect", "stream.prep"}, "forward": {"detect", "stream.launch"},
               "paste": {"detect", "stream.launch"}, "fetch": {"detect"}, "unmold.pool": {"detect", "stream.unmold"},
               "unmold": {None, "stream.unmold"}, "unmold.masks": {"unmold"}, "stream.prep": {None},
               **{c: {"forward"} for c in FORWARD_CHILDREN},
               **{f"stream.{c}": {"stream.step"} for c in ("wait_ingress", "launch", "unmold")}}
    for s in spans:
        if s.name in parents:
            assert s.parent in parents[s.name], s
    for name, count in (("ingress", 5), ("forward", 3), ("paste", 3), ("unmold.pool", 2), ("unmold", 5),
                        ("unmold.masks", 5)):
        assert len(by_name[name]) == count, name
    for outer in prep + launches + unmolds:  # a stage's children carry its batch, on its thread
        inner = [s for s in spans if s.thread == outer.thread and outer.start <= s.start and s.end <= outer.end
                 and s is not outer]
        assert inner and all(s.batch == outer.batch for s in inner)
    masks = [len(r["class_ids"]) for r in detected + streamed]
    # the pool's threads record in the order they end: each batch's images' counts, as a multiset
    want = collections.Counter(zip([detect.batch] * 2 + batches[:1] * 2 + batches[1:], masks))
    for name in ("unmold", "unmold.masks"):
        assert collections.Counter((s.batch, s.n) for s in by_name[name]) == want, name
    assert [s.n for s in by_name["unmold.pool"]] == [2, 2] and sum(masks) > 0

    # each span is a profiler range on the same thread, of the same duration: within 50 us at the median,
    # and nine in ten within 100 us and 1 % of the span. The profiler stamps a range on its own clock (the
    # CPU's counter scaled to wall time by a ratio it calibrates), and its first range on a thread also
    # holds its set-up of that thread; a thread preempted between the two stamps of one end (six test
    # processes share the cores) parts them by a time slice
    events = []
    for root, _, files in os.walk(tmp_path):
        for f in files:
            with gzip.open(os.path.join(root, f), "rt") as fh:
                events += json.load(fh)["traceEvents"]
    ranges = collections.defaultdict(list)
    for ev in events:
        if ev.get("cat") in profiling.HOST_RANGE_CATEGORIES and ev.get("name", "").startswith(profiling.PREFIX):
            ranges[(ev["name"][len(profiling.PREFIX):], ev["tid"])].append((ev["ts"], ev["dur"]))
    ours = collections.defaultdict(list)
    for s in sorted(spans, key=lambda s: s.start):
        ours[(s.name, s.thread)].append((s.end - s.start) / 1e3)
    assert set(ranges) == set(ours)
    gaps, close = [], []
    for key, durations in ours.items():
        theirs = [d for _, d in sorted(ranges[key])]
        assert len(theirs) == len(durations), key
        gaps += [abs(t - o) for o, t in zip(durations, theirs)]
        close += [abs(t - o) <= 100 + 0.01 * o for o, t in zip(durations, theirs)]
    assert np.median(gaps) <= 50 and np.mean(close) >= 0.9, sorted(gaps)


def test_outputs_equal_with_tracing_on_and_off(predictor, tmp_path):
    want = _serve(predictor)
    got, rec = _profiled(lambda: _serve(predictor), str(tmp_path))
    assert rec.spans
    for g, w in zip(got, want):
        _assert_equal(g, w)


def test_data_parallel_replicas_carry_the_batch(state, tmp_path):
    pred = Predictor(MaskRCNNConfig(**TINY), state, device="cpu", data_parallel=True, devices=["cpu", "cpu"])
    images = _images()
    (got,), rec = _profiled(lambda: (pred.detect(images[:3]),), str(tmp_path))
    (detect,) = [s for s in rec.spans if s.name == "detect"]
    replicas = [s for s in rec.spans if s.name == "forward.replica"]
    assert len(replicas) == 2 and all(s.batch == detect.batch and s.parent is None for s in replicas)
    assert all(s.thread != detect.thread for s in replicas)
    for child in FORWARD_CHILDREN:
        found = [s for s in rec.spans if s.name == child]
        assert len(found) == 2 and all(s.parent == "forward.replica" and s.batch == detect.batch for s in found)
    _assert_equal(got, pred.detect(images[:3]))


def test_quantize_input_span():
    x, amax = torch.randn(2, 8), torch.tensor(3.0)
    want = quant.quantize_input(x, amax)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = quant.quantize_input(x, amax)
    assert [s.name for s in profiling.recorded().spans] == ["quant.quantize_input"]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_export_under_a_profiler_gives_the_same_graph(state):
    cfg = MaskRCNNConfig(**TINY)
    plain = export_served(cfg, state, 1, torch.device("cpu"), torch.uint8, True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = export_served(cfg, state, 1, torch.device("cpu"), torch.uint8, True)
    assert str(traced.graph) == str(plain.graph)
    assert "record_function" not in str(traced.graph) and profiling.recorded().spans == []


def test_recorded_windows_and_the_buffer_drops_the_oldest(monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
        start = time.perf_counter()
        with profiling.span("outer", batch=7) as outer:
            outer.n = 2
            profiling.count("thing", 3)
            with profiling.span("inner"):
                pass
        end = time.perf_counter()
        with profiling.span("after"):
            profiling.count("thing")
    spans, counts, dropped = profiling.recorded(start, end)
    assert [(s.name, s.parent, s.batch, s.n) for s in spans] == [("inner", "outer", 7, None), ("outer", None, 7, 2)]
    assert all(s.thread == threading.get_native_id() and start * 1e9 <= s.start <= s.end <= end * 1e9 for s in spans)
    assert [(c.name, c.span, c.batch, c.n) for c in counts] == [("thing", "outer", 7, 3)] and dropped == 0
    assert [s.name for s in profiling.recorded().spans] == ["before", "inner", "outer", "after"]

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(5):
            profiling.count(f"c{i}")
    spans, counts, dropped = profiling.recorded()
    assert [c.name for c in counts] == ["c2", "c3", "c4"] and dropped == 2 and spans == []


def _write(tmp_path, events, name="a.trace.json.gz"):
    with gzip.open(tmp_path / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _x(cat, name, ts, dur, tid, corr=None, pid=1):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _kernel(ts, dur, corr):
    return _x("kernel", f"k{corr}", ts, dur, 7, corr, pid=0)


def test_idle_gaps_on_handcrafted_traces(tmp_path):
    """Host thread 10 issues the forward and unmolds, thread 20
    preprocesses, thread 30 waits. The trace runs from -10 to 400. Device
    work: kernels [0, 10) and [5, 20), which overlap (one busy stretch), a
    copy [50, 55), kernels [100, 110) and [200, 205), a memset [300, 301).
    Gaps: -10-0 ended by thread 10's kernel (in no range then), 20-50 ended
    by thread 20's copy (midpoint 35 in its ``stream.prep``), 55-100 ended by
    thread 10's kernel (midpoint 77.5 in ``unmold.masks``, inside ``unmold``
    and ``stream.unmold``), 110-200 ended by a kernel whose launch is not in
    the trace, 205-300 ended by thread 30's memset and 301-400 after it
    (thread 30 in no range)."""
    events = [
        _kernel(0, 10, 1), _kernel(5, 15, 2),
        _x("gpu_memcpy", "Memcpy HtoD", 50, 5, 8, 3, pid=0),
        _kernel(100, 10, 4), _kernel(200, 5, 9),
        _x("gpu_memset", "Memset", 300, 1, 8, 6, pid=0),
        _x("gpu_user_annotation", "mrcnn::forward", 0, 400, 7, pid=0),  # the device copy of a range is not work
        _x("cuda_runtime", "cudaLaunchKernel", 0, 1, 10, 1), _x("cuda_runtime", "cudaLaunchKernel", 2, 1, 10, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", 49, 1, 20, 3), _x("cuda_driver", "cuLaunchKernel", 99, 1, 10, 4),
        _x("cuda_runtime", "cudaMemsetAsync", 299, 1, 30, 6),
        _x("user_annotation", "mrcnn::stream.prep", 25, 40, 20),
        _x("user_annotation", "mrcnn::stream.unmold", 56, 40, 10),
        _x("user_annotation", "mrcnn::unmold", 60, 30, 10),
        _x("cpu_op", "mrcnn::unmold.masks", 70, 15, 10),  # the program's ranges are function-scope
        _x("user_annotation", "bench::other", 70, 10, 10),  # not the program's
        _x("user_annotation", "mrcnn::unmold", 60, 30, 20),  # another thread's range
        _x("cpu_op", "aten::empty", -10, 1, 10), _x("cpu_op", "aten::empty", 399, 1, 10),
    ]
    _write(tmp_path, events)
    gaps = profiling.idle_gaps(str(tmp_path))
    assert [(g.label, round(g.seconds * 1e6, 6), g.start_us) for g in gaps] == [
        (profiling.NO_SPAN, 99.0, 301.0), (profiling.NO_SPAN, 95.0, 205.0), (profiling.NO_SPAN, 90.0, 110.0),
        ("unmold.masks", 45.0, 55.0), ("stream.prep", 30.0, 20.0), (profiling.NO_SPAN, 10.0, -10.0)]
    assert profiling.idle_gaps(str(tmp_path), k=2) == gaps[:2]

    # the gap after the last work takes the thread that launched that work
    _write(tmp_path, events + [_x("user_annotation", "mrcnn::stream.wait_ingress", 298, 100, 30)])
    assert [g.label for g in profiling.idle_gaps(str(tmp_path), k=2)] == ["stream.wait_ingress", profiling.NO_SPAN]


def test_idle_gaps_without_device_work(tmp_path):
    _write(tmp_path, [_x("cpu_op", "aten::add", 0, 5, 10), _x("user_annotation", "mrcnn::detect", 0, 9, 10)])
    assert profiling.idle_gaps(str(tmp_path)) == []


@pytest.mark.gpu
def test_host_sync_counts_what_sync_debug_reports():
    """Every synchronizing call that sync debug mode reports in one ``detect``
    batch and one ``detect_stream`` batch is a counted ``host_sync``, and no
    other; the event wait, which that mode does not report, is counted once a
    batch inside ``fetch`` (``detect``) and ``stream.wait_device``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the host waits only for a device")
    cfg = MaskRCNNConfig(**TINY)
    pred = Predictor(cfg, _state(cfg), device="cuda")
    images = _images()[:2]
    pred.detect(images)
    list(pred.detect_stream(iter(images), batch_size=2, depth=1))
    torch.cuda.synchronize()

    def reported(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)]

    def counted(fn):
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            fn()
        return [c for c in profiling.recorded().counts if c.name == profiling.HOST_SYNC]

    detect = lambda: pred.detect(images)  # noqa: E731
    stream = lambda: list(pred.detect_stream(iter(images), batch_size=2, depth=1))  # noqa: E731
    want = reported(detect)
    got = counted(detect)
    waits = [c for c in got if c.span == "fetch"]
    assert sum(c.n for c in waits) == 1 and sum(c.n for c in got) == 10
    assert sum(c.n for c in got if c not in waits) == len(want) == 9, (want, got)
    want = reported(stream)
    got = counted(stream)
    waits = [c for c in got if c.span == "stream.wait_device"]
    assert sum(c.n for c in waits) == 1
    assert sum(c.n for c in got if c not in waits) == len(want) == 9, (want, got)
