"""The mask paste of the port's serving path (``kernels/paste_masks.py``,
K8): its plain version and the pasted path of ``unmold_detections`` against
the host loop, the arithmetic the kernel encodes against the host's own,
the predictor's hooks, the pool that copies a batch's masks out of the ring,
and on the card the kernel against its plain version.

Everything is held bit for bit: the benchmark's unmold check compares every
pixel. The arithmetic the kernel encodes is written out in numpy in
``tests/torch_port_paste_model.py``; the bilinear part of it was pinned on
``F.interpolate`` of hosts whose ATen dispatches ``AVX512``
(``torch.backends.cpu.get_cpu_capability()``), so that test runs only there.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_paste_masks.py
"""

import collections
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskrcnn_tf2_tpu_torch import predictor as predictor_module
from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import transforms
from maskrcnn_tf2_tpu_torch.export.inference import unmold_detections
from maskrcnn_tf2_tpu_torch.kernels import paste_masks as k8
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

from torch_port_paste_model import SMALL_PATH_MAX, bilinear, pixel_boxes

PINNED_CAPABILITIES = ("AVX512",)
TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=10, num_classes=4,
            backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
            compute_dtype="float32", detection_min_confidence=0.0)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def sigmoid_masks(rs, shape):
    """Sigmoids of bf16 logits, as the mask head gives them, with some 0.5
    plateaus and values a few ulp either side of 0.5."""
    m = torch.sigmoid(torch.from_numpy(rs.randn(*shape).astype(np.float32) * 4).bfloat16().float()).numpy()
    flat = m.reshape(-1, shape[-2], shape[-1])
    for i in range(0, len(flat), 3):
        flat[i, 4:20, 3:25] = 0.5
        flat[i, ::3, ::2] = np.float32(0.5) + np.float32(2.0 ** -24) * rs.randint(-3, 4, flat[i, ::3, ::2].shape)
    return m


def window_of(shape, side):
    """The molded window of an ``shape`` image in a ``side`` square, as
    ``resize_image`` computes it (scale to fit, centred)."""
    h, w = shape
    scale = side / max(h, w)
    rh, rw = round(h * scale), round(w * scale)
    top, left = (side - rh) // 2, (side - rw) // 2
    return np.array([top, left, top + rh, left + rw], np.float32)


def meta_row(shape, side, window, classes=4):
    row = np.zeros(12 + classes, np.float32)
    row[1:4] = (shape[0], shape[1], 3)
    row[4:7] = (side, side, 3)
    row[7:11] = window
    row[11] = 1.0
    return row


def scene(rs, shapes, side, d, ns, inverted=0):
    """Detections ``[B, d, 6]`` inside each image's window (some of no area
    in pixels, ``inverted`` upside down and mirrored, which keep drops not),
    class 0 at ``ns[i]`` (no class 0 when ``ns[i] == d``), masks and metas."""
    b = len(shapes)
    det = np.zeros((b, d, 6), np.float32)
    metas = np.stack([meta_row(s, side, window_of(s, side)) for s in shapes])
    for i, n in enumerate(ns):
        wy1, wx1, wy2, wx2 = metas[i, 7:11]
        lo = np.array([wy1 / (side - 1), wx1 / (side - 1)], np.float32)
        hi = np.array([(wy2 - 1) / (side - 1), (wx2 - 1) / (side - 1)], np.float32)
        a, c = rs.uniform(0, 1, (2, d, 2))
        y1x1 = lo + (hi - lo) * np.minimum(a, c)
        y2x2 = lo + (hi - lo) * np.maximum(a, c)
        box = np.concatenate([y1x1, y2x2], 1).astype(np.float32)
        box[1::7, 2] = box[1::7, 0]  # no height
        box[2::9, 3] = box[2::9, 1] + np.float32(1e-4)  # less than a pixel wide
        for j in range(inverted):
            box[3 + 5 * j] = box[3 + 5 * j][[2, 3, 0, 1]]
        det[i, :, :4] = box
        det[i, :, 4] = rs.randint(1, 4, d)
        det[i, :, 5] = rs.uniform(0, 1, d)
        if n < d:
            det[i, n:, 4] = 0
    return det, sigmoid_masks(rs, (b, d, 28, 28)), metas


def paste_plain(det, masks, metas, shapes, side):
    offsets, total, largest = k8.block_layout(shapes, det.shape[1])
    out = torch.zeros(total, dtype=torch.uint8)
    kept = k8.paste_masks(torch.from_numpy(det), torch.from_numpy(masks), torch.from_numpy(metas),
                          torch.from_numpy(offsets), (side, side), out, largest)
    return out.numpy(), offsets, kept.numpy()


def blocks(flat, offsets, kept, shapes):
    return [flat[o:o + h * w * k].reshape(h, w, k) for (h, w), o, k in zip(shapes, offsets, kept)]


def assert_results_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# (a) the plain version and the pasted path against the host loop
# ---------------------------------------------------------------------------

CASES = {
    "mixed": dict(shapes=[(48, 64), (64, 48)], d=20, ns=[14, 20], inverted=2),
    "none_kept": dict(shapes=[(40, 40), (64, 64)], d=12, ns=[0, 0]),
    "one_empty_image": dict(shapes=[(64, 64), (30, 64), (64, 17)], d=16, ns=[9, 0, 16], inverted=1),
    "ragged_shapes": dict(shapes=[(5, 7), (64, 64), (33, 61), (2, 90), (90, 3)], d=24, ns=[24, 10, 3, 24, 7]),
    "large": dict(shapes=[(480, 640)], d=30, ns=[30], inverted=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_paste_and_pasted_unmold_equal_the_host_loop(case):
    """``paste_masks`` on CPU tensors, then ``unmold_detections`` given each
    image's pasted block, equals today's ``unmold_detections`` over the 28x28
    masks: boxes, classes, scores, every mask pixel, every dtype."""
    spec = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case))
    side = 64 if case != "large" else 512
    det, masks, metas = scene(rs, spec["shapes"], side, spec["d"], spec["ns"], spec.get("inverted", 0))
    flat, offsets, kept = paste_plain(det, masks, metas, spec["shapes"], side)
    assert offsets.tolist() == sorted(offsets.tolist()) and all(o % 16 == 0 for o in offsets)
    for i, (shape, block) in enumerate(zip(spec["shapes"], blocks(flat, offsets, kept, spec["shapes"]))):
        want = unmold_detections(det[i], masks[i], shape, (side, side, 3), metas[i, 7:11])
        got = unmold_detections(det[i], None, shape, (side, side, 3), metas[i, 7:11], pasted=block)
        assert_results_equal(got, want)
        assert kept[i] == len(want["class_ids"])
    if case == "none_kept":
        assert kept.tolist() == [0, 0] and not flat.any()
    if case in ("mixed", "large"):
        assert kept.sum() > 0


def test_pasted_block_must_match_the_kept_detections():
    rs = np.random.RandomState(7)
    det, masks, metas = scene(rs, [(40, 50)], 64, 8, [8])
    n_kept = len(unmold_detections(det[0], masks[0], (40, 50), (64, 64), metas[0, 7:11])["class_ids"])
    with pytest.raises(RuntimeError, match="do not match"):
        unmold_detections(det[0], None, (40, 50), (64, 64), metas[0, 7:11],
                          pasted=np.zeros((40, 50, n_kept + 1), np.uint8))


def test_block_layout_and_input_checks():
    offsets, total, largest = k8.block_layout([(3, 5), (2, 2), (7, 1)], 3)
    assert offsets.tolist() == [0, 48, 64] and total == 96 and largest == 45
    assert k8.block_layout([], 5)[1:] == (0, 0)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        k8.block_layout([(50000, 50000)], 1)
    det = torch.zeros(1, k8.MAX_DETECTIONS + 1, 6)
    masks = torch.zeros(1, k8.MAX_DETECTIONS + 1, 28, 28)
    with pytest.raises(ValueError, match="detection_max_instances"):
        k8.paste_masks(det, masks, torch.zeros(1, 16), torch.zeros(1, dtype=torch.int64), (64, 64),
                       torch.zeros(16, dtype=torch.uint8), 16)
    with pytest.raises(ValueError, match="uint8"):
        k8.paste_masks(det[:, :4], masks[:, :4], torch.zeros(1, 16), torch.zeros(1, dtype=torch.int64), (64, 64),
                       torch.zeros(16, dtype=torch.int32), 16)


def test_fake_implementation_gives_exact_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        kept = torch.ops.maskrcnn_tf2_tpu_torch.paste_masks(
            torch.empty(3, 10, 6), torch.empty(3, 10, 28, 28), torch.empty(3, 16), torch.empty(3, dtype=torch.int64),
            64, 64, torch.empty(4800, dtype=torch.uint8), 1600)
    assert kept.shape == (3,) and kept.dtype == torch.int32


# ---------------------------------------------------------------------------
# (b) the box arithmetic K8 encodes against unmold_detections'
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [64, 512, 1024])
def test_box_arithmetic_equals_unmold_boxes(side):
    """10,000 random detections over 500 windows of random original shapes,
    inside, on and past the window's edges: ``n``, every pixel box and
    ``keep`` as ``unmold_detections`` computes them (``unmold_boxes``), with
    boxes that round at half a pixel among them."""
    rs = np.random.RandomState(side)
    for _ in range(500):
        shape = (int(rs.randint(2, 2000)), int(rs.randint(2, 2000)))
        window = window_of(shape, side)
        if rs.rand() < 0.2:  # any window of two pixels or more, as a meta vector may carry
            y, x = (np.sort(rs.choice(side + 1, 2, replace=False)) for _ in range(2))
            window = np.array([y[0], x[0], max(y[1], y[0] + 2), max(x[1], x[0] + 2)], np.float32)
        det = np.zeros((20, 6), np.float32)
        lo = (window[:2] / (side - 1)).astype(np.float32)
        hi = ((window[2:] - 1) / (side - 1)).astype(np.float32)
        det[:, :4] = rs.uniform(-0.05, 1.05, (20, 4)) * np.tile(hi - lo, 2) + np.tile(lo, 2)
        half = rs.rand(20) < 0.3  # land on k + 0.5 pixels in float64 before rounding
        px = rs.randint(0, shape[0], 20) + 0.5
        det[half, 0] = (px[half] / (shape[0] - 1) * (hi[0] - lo[0]) + lo[0]).astype(np.float32)
        det[:, 4] = rs.randint(1, 4, 20)
        if rs.rand() < 0.3:
            det[rs.randint(0, 20):, 4] = 0
        det[:, 5] = rs.uniform(0, 1, 20)
        n, boxes, keep = pixel_boxes(det, shape, (side, side), window)
        want_n, want_boxes, want_keep = transforms.unmold_boxes(det, shape, (side, side, 3), window)
        assert n == want_n
        np.testing.assert_array_equal(boxes, want_boxes)
        np.testing.assert_array_equal(keep, want_keep)


# ---------------------------------------------------------------------------
# (c) the bilinear arithmetic K8 encodes against F.interpolate
# ---------------------------------------------------------------------------


def bilinear_sizes(part):
    """Output sizes: every (h, w) of the channels-last path (h + w <= 128), in
    two halves; every width 2-640 and every height 2-480 twice on the
    separable path, the other side drawn; every (h, w) within 4 of the
    paths' border."""
    rs = np.random.RandomState(11)
    if part.startswith("small"):
        pairs = [(h, w) for h in range(2, SMALL_PATH_MAX - 1) for w in range(2, SMALL_PATH_MAX + 1 - h)]
        return pairs[int(part[-1])::2]
    if part.startswith("widths"):
        ws = range(2, 641)[int(part[-1])::2]
        return [(int(rs.randint(max(2, SMALL_PATH_MAX + 1 - w), 481)), w) for w in ws for _ in range(2)]
    if part.startswith("heights"):
        hs = range(2, 481)[int(part[-1])::2]
        return [(h, int(rs.randint(max(2, SMALL_PATH_MAX + 1 - h), 641))) for h in hs for _ in range(2)]
    return [(h, s - h) for s in range(SMALL_PATH_MAX - 4, SMALL_PATH_MAX + 5) for h in range(2, s - 1)]


@pytest.mark.parametrize("part", ["small0", "small1", "widths0", "widths1", "heights0", "heights1", "border"])
def test_bilinear_arithmetic_equals_interpolate(part):
    cap = torch.backends.cpu.get_cpu_capability()
    if cap not in PINNED_CAPABILITIES:
        pytest.skip(f"the bilinear arithmetic was pinned on ATen's {PINNED_CAPABILITIES} kernels; this host "
                    f"dispatches {cap}")
    rs = np.random.RandomState(len(part) + int(part[-1]) if part[-1].isdigit() else 3)
    masks = sigmoid_masks(rs, (6, 28, 28))
    bad = []
    for i, (h, w) in enumerate(bilinear_sizes(part)):
        m = masks[i % len(masks)]
        want = F.interpolate(torch.from_numpy(m)[None, None], size=(h, w), mode="bilinear",
                             align_corners=False)[0, 0].numpy()
        got = bilinear(m, h, w)
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            bad.append((h, w, int((got != want).sum())))
    assert not bad, bad[:10]


# ---------------------------------------------------------------------------
# (d) the predictor's hooks, which the benchmark reads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_predictor():
    cfg = MaskRCNNConfig(**TINY)
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():  # spread the RPN scores: saturated scores tie
        model.rpn.rpn_class_raw.weight.mul_(0.1)
    return Predictor(cfg, model.state_dict(), device="cpu")


def _images():
    rs = np.random.RandomState(4)
    return [rs.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in [(64, 64), (50, 80), (90, 60)]]


def _recorded(fn):
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            out = fn()
        return out, profiling.recorded()
    finally:
        profiling.clear()


def test_predictor_hooks_hold_on_both_paths(tiny_predictor, monkeypatch):
    """``_forward`` returns two tensors; ``detect`` and ``detect_stream`` of a
    CPU predictor serve through the op (its plain version), once a batch, and
    call ``unmold_detections`` once an image through the ``predictor``
    module, always on a pasted block; each ``unmold.masks`` span carries its
    image's masks as ``n``; the results equal the host loop,
    ``unmold_detections`` over ``_forward``'s outputs, bit for bit."""
    pred = tiny_predictor
    images = _images()
    forwards = []
    calls = collections.Counter()
    lock = threading.Lock()  # the pasted path calls from the unmold pool's threads
    forward, paste = Predictor._forward, k8.paste_masks

    def recorded(self, molded, metas):
        out = forward(self, molded, metas)
        assert isinstance(out, tuple) and len(out) == 2 and all(isinstance(t, torch.Tensor) for t in out)
        forwards.append((out[0].numpy().copy(), out[1].numpy().copy(), metas))
        return out

    def counted(*args, **kwargs):
        with lock:
            calls["pasted" if kwargs.get("pasted") is not None else "host"] += 1
        return unmold_detections(*args, **kwargs)

    def pasting(*args, **kwargs):
        calls["op"] += 1
        return paste(*args, **kwargs)

    monkeypatch.setattr(Predictor, "_forward", recorded)
    monkeypatch.setattr(predictor_module, "unmold_detections", counted)
    monkeypatch.setattr(k8, "paste_masks", pasting)
    detected, rec = _recorded(lambda: pred.detect(images))
    streamed = list(pred.detect_stream(iter(images), batch_size=2, depth=1))
    assert calls == {"op": 3, "pasted": 6}
    assert [f[0].shape for f in forwards] == [(3, 10, 6), (2, 10, 6), (2, 10, 6)]
    assert forwards[0][1].shape == (3, 10, 28, 28)

    # (forward, its row, the image): detect's one batch, then the stream's two
    rows = [(0, 0, 0), (0, 1, 1), (0, 2, 2), (1, 0, 0), (1, 1, 1), (2, 0, 2)]
    assert len(detected + streamed) == len(rows)
    for got, (f, i, j) in zip(detected + streamed, rows):
        det, masks, metas = forwards[f]
        assert_results_equal(got, unmold_detections(det[i], masks[i], images[j].shape, pred.config.image_shape,
                                                    metas[i][7:11]))
    n_masks = [len(r["class_ids"]) for r in detected]
    assert sum(n_masks) > 0
    # the pool's threads record in the order they end: each image's count, as a multiset
    assert collections.Counter(s.n for s in rec.spans if s.name == "unmold.masks") == collections.Counter(n_masks)
    assert sum(c.n for c in rec.counts if c.name == "unmold.device_masks") == sum(n_masks)


# ---------------------------------------------------------------------------
# (e) the unmold pool: a batch's copies out of the ring side by side
# ---------------------------------------------------------------------------


def pasted_batch(k, seed):
    """A batch of ``k`` images for the tiny predictor (side 64), the second
    with no kept detection, pasted by K8's plain version: detections, metas,
    the images' shapes, the ``Pasted`` the predictor reads and the results
    of ``unmold_detections`` called inline on each image's block."""
    rs = np.random.RandomState(seed)
    hw = [[(64, 64), (30, 64), (64, 17), (48, 40)][i % 4] for i in range(k)]
    det, masks, metas = scene(rs, hw, 64, 10, [0 if i == 1 else 10 for i in range(k)], inverted=1)
    flat, offsets, kept = paste_plain(det, masks, metas, hw, 64)
    assert kept[1] == 0 and kept.sum() > 0
    shapes = [s + (3,) for s in hw]
    inline = [unmold_detections(det[i], None, shapes[i], TINY["image_shape"], metas[i, 7:11], pasted=b)
              for i, b in enumerate(blocks(flat, offsets, kept, hw))]
    return det, metas, shapes, predictor_module.Pasted(torch.from_numpy(flat), offsets, kept), inline


@pytest.mark.parametrize("k", [2, 3, 8])
def test_pooled_unmold_equals_inline_in_input_order(tiny_predictor, k):
    det, metas, shapes, pasted, inline = pasted_batch(k, seed=k)
    got = tiny_predictor._unmold(det, metas, shapes, pasted)
    assert len(got) == k
    for g, w in zip(got, inline):
        assert_results_equal(g, w)


@pytest.mark.parametrize("k", [2, 8])
def test_pooled_results_share_no_byte_with_the_ring(tiny_predictor, k):
    """K8 writes the ring again a turn later: what ``_unmold`` returned is
    the caller's alone."""
    det, metas, shapes, pasted, inline = pasted_batch(k, seed=10 + k)
    got = tiny_predictor._unmold(det, metas, shapes, pasted)
    ring = pasted.out.numpy()
    assert not any(np.shares_memory(r["masks"], ring) for r in got)
    ring[:] = 0xAB
    for g, w in zip(got, inline):
        assert_results_equal(g, w)


def test_pooled_unmold_raises_after_every_copy_has_ended(tiny_predictor, monkeypatch):
    """A block that does not match its kept detections raises out of
    ``_unmold`` as the inline call does, and only once every other image's
    copy has ended: none is left running over the ring."""
    det, metas, shapes, pasted, _ = pasted_batch(6, seed=20)
    pasted = pasted._replace(kept=pasted.kept + np.eye(1, 6, 0, dtype=pasted.kept.dtype)[0])  # image 0 one too many
    ended = []

    def slow(*args, **kwargs):
        out = unmold_detections(*args, **kwargs)
        time.sleep(0.05)
        ended.append(kwargs["pasted"].shape)
        return out

    monkeypatch.setattr(predictor_module, "unmold_detections", slow)
    with pytest.raises(RuntimeError, match="do not match"):
        tiny_predictor._unmold(det, metas, shapes, pasted)
    assert len(ended) == 5


@pytest.mark.parametrize("k", [1, 2, 8])
def test_pool_span_and_count(tiny_predictor, k):
    """One image unmolds inline and opens no pool; ``k > 1`` images record
    one ``unmold.pool`` span of ``n = k`` and ``k`` pooled images, and the
    pool's threads' spans carry the batch's id."""
    det, metas, shapes, pasted, _ = pasted_batch(max(k, 2), seed=30 + k)
    batch = profiling.new_batch()

    def run():
        with profiling.span("stream.unmold", batch):
            return tiny_predictor._unmold(det[:k], metas[:k], shapes[:k],
                                          pasted._replace(offsets=pasted.offsets[:k], kept=pasted.kept[:k]))

    _, rec = _recorded(run)
    pools = [s for s in rec.spans if s.name == "unmold.pool"]
    pooled = [c for c in rec.counts if c.name == "unmold.pooled_images"]
    if k == 1:
        assert not pools and not pooled
    else:
        assert [s.n for s in pools] == [k] and sum(c.n for c in pooled) == k
        assert {c.batch for c in pooled} == {batch}
    images = [s for s in rec.spans if s.name in ("unmold", "unmold.masks")]
    assert len(images) == 2 * k and {s.batch for s in images + pools} == {batch}


def test_pool_is_made_once_and_holds_at_most_the_usable_cpus(tiny_predictor, monkeypatch):
    """The predictor makes its unmold pool once; it starts no thread for a
    one-image batch and never more threads than usable CPUs (two here), and
    keeps them from batch to batch."""
    made = []

    class Counted(predictor_module.ThreadPoolExecutor):
        def __init__(self, *args, **kwargs):
            made.append(kwargs.get("max_workers", args[0] if args else None))
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(predictor_module, "ThreadPoolExecutor", Counted)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1})
    pred = Predictor(tiny_predictor.config, tiny_predictor.model.state_dict(), device="cpu")
    assert made == [2]
    pool = pred._unmold_pool
    det, metas, shapes, pasted, inline = pasted_batch(8, seed=40)
    pred._unmold(det[:1], metas[:1], shapes[:1], pasted._replace(offsets=pasted.offsets[:1], kept=pasted.kept[:1]))
    assert not pool._threads
    for _ in range(3):
        for g, w in zip(pred._unmold(det, metas, shapes, pasted), inline):
            assert_results_equal(g, w)
        threads = set(pool._threads)
        assert 1 <= len(threads) <= 2 and all(t.is_alive() for t in threads)
    assert made == [2] and pred._unmold_pool is pool and set(pool._threads) == threads


def test_cpu_predictor_keeps_the_host_loop_off_the_pool(tiny_predictor):
    """On a CPU device the host loop (the op's plain version) runs in one
    ``paste`` span a batch on the calling thread; the pool only copies the
    masks out of the blocks: one ``unmold.pool`` span a batch of several
    images, none for a batch of one."""
    images = _images()
    _, rec = _recorded(lambda: (tiny_predictor.detect(images), list(tiny_predictor.detect_stream(iter(images), 2, 1))))
    pastes = [s for s in rec.spans if s.name == "paste"]
    assert len(pastes) == 3 and {s.thread for s in pastes} == {threading.get_native_id()}
    assert sum(s.name == "unmold" for s in rec.spans) == 6
    assert [s.n for s in rec.spans if s.name == "unmold.pool"] == [3, 2]
    assert sum(c.n for c in rec.counts if c.name == "unmold.pooled_images") == 5


# ---------------------------------------------------------------------------
# on the card (skip without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def sized_scene(rs, sizes, shape=(480, 640), side=512, d=100):
    """Batches of ``[B, d]`` detections whose pixel boxes have the given
    ``(h, w)`` sizes at random places in ``shape`` images: each box is
    placed in pixels and mapped back through the window."""
    window = window_of(shape, side)
    lo = (window[:2] / (side - 1)).astype(np.float64)
    span = ((window[2:] - 1) / (side - 1)).astype(np.float64) - lo
    out = []
    for start in range(0, len(sizes), 8 * d):
        chunk = sizes[start:start + 8 * d]
        b = -(-len(chunk) // d)
        det = np.zeros((b, d, 6), np.float32)
        for k, (h, w) in enumerate(chunk):
            i, j = divmod(k, d)
            y1, x1 = rs.randint(0, shape[0] - h + 1), rs.randint(0, shape[1] - w + 1)
            p = np.array([y1, x1, y1 + h - 1, x1 + w - 1], np.float64)
            det[i, j, :4] = lo[[0, 1, 0, 1]] + p / (np.array(shape * 2) - 1) * span[[0, 1, 0, 1]]
            det[i, j, 4] = 1 + k % 3
            det[i, j, 5] = 0.5
        metas = np.stack([meta_row(shape, side, window)] * b)
        out.append((det, sigmoid_masks(rs, (b, d, 28, 28)), metas, [shape] * b))
    return out


def run_k8(det, masks, metas, shapes, side, device, out_device):
    offsets, total, largest = k8.block_layout(shapes, det.shape[1])
    out = (torch.full((total,), 0xAB, dtype=torch.uint8, device=device) if out_device == "device"
           else torch.full((total,), 0xAB, dtype=torch.uint8).pin_memory())
    before = k8.paste_masks.launches
    kept = k8.paste_masks(torch.from_numpy(det).to(device), torch.from_numpy(masks).to(device),
                          torch.from_numpy(metas).to(device), torch.from_numpy(offsets).to(device), (side, side),
                          out, largest)
    torch.cuda.synchronize()
    assert k8.paste_masks.launches == before + 1
    return out.cpu().numpy(), offsets, kept.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["small0", "small1", "widths0", "widths1", "heights0", "heights1", "border"])
def test_kernel_equals_plain_on_every_size(cuda, part):
    """K8 against its plain version with 0 differing bytes, boxes of every
    size of ``bilinear_sizes`` in 480x640 images (the crowd cell's), into
    pinned host memory and device memory."""
    sizes = bilinear_sizes(part)
    rs = np.random.RandomState(5)
    for n, (det, masks, metas, shapes) in enumerate(sized_scene(rs, sizes)):
        want, offsets, want_kept = paste_plain(det, masks, metas, shapes, 512)
        got, _, kept = run_k8(det, masks, metas, shapes, 512, cuda, "pinned" if n % 2 == 0 else "device")
        np.testing.assert_array_equal(kept, want_kept)
        for g, w in zip(blocks(got, offsets, kept, shapes), blocks(want, offsets, kept, shapes)):
            assert np.array_equal(g, w), (part, n, int((g != w).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_plain_on_the_cases(cuda, case):
    """The CPU cases: no area, upside down, ``n < D``, ``n = 0``, ragged
    shapes; the bytes past each image's block are not touched."""
    spec = CASES[case]
    rs = np.random.RandomState(sorted(CASES).index(case))
    side = 64 if case != "large" else 512
    det, masks, metas = scene(rs, spec["shapes"], side, spec["d"], spec["ns"], spec.get("inverted", 0))
    want, offsets, want_kept = paste_plain(det, masks, metas, spec["shapes"], side)
    for where in ("pinned", "device"):
        got, _, kept = run_k8(det, masks, metas, spec["shapes"], side, cuda, where)
        np.testing.assert_array_equal(kept, want_kept)
        written = np.zeros(len(got), bool)
        for (h, w), o, k in zip(spec["shapes"], offsets, kept):
            written[o:o + -(-h * w * k // 16) * 16] = True
        assert (got[~written] == 0xAB).all()
        np.testing.assert_array_equal(got[written & (want == 0) & (got != 0)], [])
        for g, w in zip(blocks(got, offsets, kept, spec["shapes"]), blocks(want, offsets, kept, spec["shapes"])):
            np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_no_kept_detection_writes_no_mask_byte(cuda):
    rs = np.random.RandomState(9)
    det, masks, metas = scene(rs, [(480, 640)] * 4, 512, 100, [0] * 4)
    got, _, kept = run_k8(det, masks, metas, [(480, 640)] * 4, 512, cuda, "pinned")
    assert kept.tolist() == [0] * 4 and (got == 0xAB).all()


@pytest.fixture(scope="module")
def crowd_predictor():
    """The flagship's widths (ResNet-50-FPN at 512, 81 classes, bf16), seeded
    weights, every detection kept: 100 masks an image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, compute_dtype="bfloat16",
                         detection_min_confidence=0.0)
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(3))
    return Predictor(cfg, model.state_dict(), device="cuda")


def crowd_images(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.uniform(0, 255, (31, 41, 3))
        x = np.repeat(np.repeat(x, 16, axis=0), 16, axis=1)[:480, :640]
        out.append(np.clip(x + rs.normal(0, 10, x.shape), 0, 255).astype(np.uint8))
    return out


@pytest.mark.gpu
def test_stream_and_detect_equal_the_host_path_on_crowd_images(crowd_predictor):
    """On 480x640 crowd images at batch 8: ``detect_stream`` equals the host
    loop over the same forward's outputs and equals ``detect``; K8 launches
    once a batch."""
    pred = crowd_predictor
    images = crowd_images(16)
    forwards = []
    forward = Predictor._forward

    def recorded(self, molded, metas):
        det, masks = forward(self, molded, metas)
        forwards.append((det.cpu().numpy(), masks.cpu().numpy(), metas))
        return det, masks

    before = k8.paste_masks.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Predictor, "_forward", recorded)
        streamed = list(pred.detect_stream(iter(images), batch_size=8, depth=2))
    assert k8.paste_masks.launches == before + 2
    detected = pred.detect(images[8:])
    assert k8.paste_masks.launches == before + 3
    n_masks = 0
    for start, (det, masks, metas) in zip((0, 8), forwards):
        for i, img in enumerate(images[start:start + 8]):
            want = unmold_detections(det[i], masks[i], img.shape, pred.config.image_shape, metas[i][7:11])
            n_masks += len(want["class_ids"])
            assert_results_equal(streamed[start + i], want)
    assert n_masks > 0
    for got, want in zip(detected, streamed[8:]):
        assert_results_equal(got, want)


@pytest.mark.gpu
def test_stream_closed_early_waits_for_its_batches(crowd_predictor):
    """A consumer that stops after the first result leaves batches in flight,
    whose K8 writes the pinned ring through the host mapping: closing the
    stream waits for them, so nothing is left queued on the card."""
    stream = crowd_predictor.detect_stream(iter(crowd_images(24, seed=1)), batch_size=8, depth=2)
    next(stream)
    stream.close()
    assert torch.cuda.current_stream().query()
