"""The PyTorch port's kernel wrappers: dispatch, plain versions, and on the card
the CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py

Tolerances on the card: NMS identical; ROIAlign within 1e-5 * max|feature|
in float32 (TF32 off) and one bf16 ulp of max|feature| in bf16 (both sum the
four weighted corners in float32 and round once, in another order); the
ROIAlign backward within 1e-5 * max|plain| in float32 and one bf16 ulp of
max|plain| in bf16 (both add in float32, the kernel with atomics in an order
that changes from run to run).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.kernels import nms as port_nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as port_roi_kernel
from maskrcnn_tf2_tpu_torch.ops.boxes import overlaps

from torch_port_helpers import nms_case, pyramid, random_boxes, roi_boxes

T = torch.from_numpy


# ---------------------------------------------------------------------------
# the plain versions against independent references (CPU)
# ---------------------------------------------------------------------------


def sequential_greedy(boxes, valid, thr):
    """The greedy NMS recurrence, one box at a time, in numpy float32."""
    keep = []
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    for i in range(len(boxes)):
        if not valid[i]:
            continue
        ok = True
        for j in keep:
            y1, x1 = np.maximum(boxes[i, :2], boxes[j, :2])
            y2, x2 = np.minimum(boxes[i, 2:], boxes[j, 2:])
            inter = np.float32(max(y2 - y1, 0)) * np.float32(max(x2 - x1, 0))
            union = area[i] + area[j] - inter
            if inter / np.maximum(union, np.float32(1e-10)) > np.float32(thr):
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_plain_nms_matches_sequential_greedy(thr):
    rs = np.random.RandomState(int(thr * 10))
    boxes, _, valid, _, _, _ = nms_case("duplicate_chains", rs)
    boxes, valid = boxes[:, :700], valid[:, :700]  # spans two of the plain version's tiles
    pos, ok = port_nms_kernel.greedy_nms_plain(T(boxes), T(valid), thr, 1000)
    assert pos[0][ok[0]].tolist() == sequential_greedy(boxes[0], valid[0], thr)


def sorted_nms_case(name, seed=7):
    """An ``nms_case`` sorted by score (stable), with an all-True mask where it has none."""
    boxes, scores, valid, limit, thr, _ = nms_case(name, np.random.RandomState(seed))
    order = np.argsort(-scores, axis=1, kind="stable")
    boxes_s = np.ascontiguousarray(np.take_along_axis(boxes, order[..., None], 1))
    valid_s = np.ones(scores.shape, bool) if valid is None else np.take_along_axis(valid, order, 1)
    return boxes_s, valid_s, limit, thr


def pack_bits(bits):
    """[..., 64 * W] bools -> [..., W] uint64, bit j of word w = element 64 * w + j."""
    return np.packbits(bits.reshape(*bits.shape[:-1], -1, 64), axis=-1, bitorder="little").view("<u8")[..., 0]


def bitmask_scan_model(boxes, valid, thr, limit):
    """csrc/nms.cu's algorithm for one image, in numpy: the row-major IoU
    bitmask (bit j of row i's word w: box 64 * w + j comes after i and overlaps
    it above thr), then the scan over 64-row chunks with a removed bitset that
    starts with the invalid rows and the padding, settling each chunk's chain
    row by row from its diagonal word, stopping at ``limit``, and ORing the kept
    rows' words for later chunks into the bitset. Returns the kept positions."""
    n = len(boxes)
    words = port_nms_kernel.mask_words(n)
    over = np.zeros((n, 64 * words), bool)
    for start in range(0, n, 512):
        rows = T(boxes[None, start : start + 512])
        over[start : start + 512, :n] = (overlaps(rows, T(boxes[None]))[0] > thr).numpy()
    over &= np.arange(64 * words)[None, :] > np.arange(n)[:, None]
    mask = pack_bits(over)  # [n, words]
    removed = pack_bits(np.concatenate([~valid, np.ones(64 * words - n, bool)]))
    kept = []
    for c in range(words):
        rem, chunk_kept = int(removed[c]), []
        for r in range(64):
            if len(kept) == limit:
                return kept
            if not (rem >> r) & 1:
                kept.append(64 * c + r)
                chunk_kept.append(64 * c + r)
                rem |= int(mask[64 * c + r, c])
        if chunk_kept and c + 1 < words:
            removed[c + 1 :] |= np.bitwise_or.reduce(mask[chunk_kept, c + 1 :], axis=0)
    return kept


@pytest.mark.parametrize("case", ["presorted_6000", "unsorted_class_offsets", "duplicate_chains",
                                  "all_invalid_row", "fewer_than_limit", "chunk_chains", "limit_mid_chunk",
                                  "single_box"])
def test_bitmask_scan_model_matches_plain(case):
    """The kernel's chunked algorithm, modelled on the CPU, keeps exactly what
    the plain version keeps, in order, up to the limit."""
    boxes_s, valid_s, limit, thr = sorted_nms_case(case)
    pos, ok = port_nms_kernel.greedy_nms_plain(T(boxes_s), T(valid_s), thr, limit)
    for b in range(len(boxes_s)):
        assert bitmask_scan_model(boxes_s[b], valid_s[b], thr, limit) == pos[b][ok[b]].tolist()


def test_plain_roi_align_on_a_constant_map():
    rs = np.random.RandomState(0)
    feats = [np.full((2, s, s, 3), 2.5, np.float32) for s in (32, 16, 8, 4)]
    boxes = roi_boxes(rs, 2, 40)
    out = port_roi_kernel.roi_align_plain([T(f) for f in feats], T(boxes), 7, (128, 128)).numpy()
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    np.testing.assert_allclose(out[valid], 2.5, rtol=1e-6)
    assert not out[~valid].any()


# ---------------------------------------------------------------------------
# dispatch: no fallback hides the device or a kernel
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_launching():
    rs = np.random.RandomState(0)
    before = (port_nms_kernel.greedy_nms.launches, port_roi_kernel.roi_align.launches)
    boxes = T(random_boxes(rs, 64))[None]
    port_nms_kernel.greedy_nms(boxes, torch.ones((1, 64), dtype=torch.bool), 0.5, 10)
    port_roi_kernel.roi_align([T(f) for f in pyramid(rs, 1, 64, 4)], boxes, 7, (64, 64))
    assert (port_nms_kernel.greedy_nms.launches, port_roi_kernel.roi_align.launches) == before


def test_backward_cpu_tensors_take_the_plain_version_without_launching():
    rs = np.random.RandomState(1)
    boxes = T(roi_boxes(rs, 2, 16))
    dout = T(rs.normal(size=(2, 16, 7, 7, 4)).astype(np.float32))
    before = port_roi_kernel.roi_align_backward.launches
    got = port_roi_kernel.roi_align_backward(dout, boxes, [(16, 16), (8, 8)], (64, 64))
    want = port_roi_kernel.roi_align_backward_plain(dout, boxes, [(16, 16), (8, 8)], (64, 64))
    assert port_roi_kernel.roi_align_backward.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        port_roi_kernel.roi_align_backward(dout[:, :3], boxes, [(16, 16)], (64, 64))


def test_nms_kernel_box_count_names_the_knobs():
    port_nms_kernel.check_kernel_boxes(port_nms_kernel.MAX_KERNEL_BOXES)  # 512 words of bitset
    assert port_nms_kernel.mask_words(6000) == 94 and port_nms_kernel.mask_words(64) == 1
    with pytest.raises(ValueError, match="pre_nms_limit"):
        port_nms_kernel.check_kernel_boxes(port_nms_kernel.MAX_KERNEL_BOXES + 1)


@pytest.mark.parametrize("dtype,c,offset,width", [
    (torch.bfloat16, 256, 0, 8), (torch.float32, 256, 0, 4), (torch.bfloat16, 36, 0, 1),
    (torch.float32, 36, 0, 4), (torch.float32, 256, 1, 1),
])
def test_roi_align_vector_width(dtype, c, offset, width):
    """16-byte channel vectors only where C and every pointer allow them."""
    maps = [torch.empty(offset + 2 * s * s * c, dtype=dtype)[offset:].view(2, s, s, c) for s in (16, 8)]
    out = torch.empty((2, 5, 7, 7, c), dtype=dtype)
    assert port_roi_kernel.vector_width(maps, out) == width


def test_wrappers_refuse_other_devices_and_bad_inputs():
    boxes = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError):
        port_nms_kernel.greedy_nms(boxes, torch.ones((1, 8), dtype=torch.bool, device="meta"), 0.5, 4)
    with pytest.raises(TypeError):
        port_nms_kernel.greedy_nms(torch.zeros((1, 8, 4), dtype=torch.float64),
                                   torch.ones((1, 8), dtype=torch.bool), 0.5, 4)
    with pytest.raises(ValueError):
        port_roi_kernel.roi_align([torch.zeros((1, 8, 8, 4))], torch.zeros((2, 3, 4)), 7, (32, 32))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, maskrcnn_tf2_tpu_torch.predictor, maskrcnn_tf2_tpu_torch.weights,"
        " maskrcnn_tf2_tpu_torch.train.train_step, maskrcnn_tf2_tpu_torch.profile_train;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'maskrcnn_tf2_tpu')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the kernels on the card (skip without one; chip_smoke.py covers the same)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 compared in full float32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["presorted_6000", "unsorted_class_offsets", "duplicate_chains", "all_invalid_row",
                                  "fewer_than_limit", "chunk_chains", "limit_mid_chunk", "single_box"])
def test_nms_kernel_matches_plain(cuda, case):
    boxes_s, valid_s, limit, thr = sorted_nms_case(case)
    want = port_nms_kernel.greedy_nms_plain(T(boxes_s), T(valid_s), thr, limit)
    before = port_nms_kernel.greedy_nms.launches
    got = port_nms_kernel.greedy_nms(T(boxes_s).to(cuda), T(valid_s).to(cuda), thr, limit)
    torch.cuda.synchronize()
    assert port_nms_kernel.greedy_nms.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool,n,c", [(7, 1000, 256), (14, 100, 256), (7, 300, 36), (14, 50, 36)])
def test_roi_align_kernel_matches_plain(cuda, dtype, pool, n, c):
    """C = 256 runs the 16-byte width; C = 36 the scalar width in bf16 (72-byte pixels)."""
    rs = np.random.RandomState(pool)
    feats = [T(f).to(cuda, dtype) for f in pyramid(rs, 2, 512, c)]
    boxes = T(roi_boxes(rs, 2, n)).to(cuda)
    before = port_roi_kernel.roi_align.launches
    got = port_roi_kernel.roi_align(feats, boxes, pool, (512, 512))
    want = port_roi_kernel.roi_align_plain(feats, boxes, pool, (512, 512))
    torch.cuda.synchronize()
    assert port_roi_kernel.roi_align.launches == before + 1
    scale = max(float(f.abs().max()) for f in feats)
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-8 * scale  # one bf16 ulp
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
def test_nms_kernel_keeps_3000_boxes(cuda):
    """limit 3000 of 6000: the scan runs through most of its 94 chunks before it stops."""
    boxes, scores, _, _, _, _ = nms_case("presorted_6000", np.random.RandomState(3))
    valid = np.ones(scores.shape, bool)
    want = port_nms_kernel.greedy_nms_plain(T(boxes), T(valid), 0.7, 3000)
    got = port_nms_kernel.greedy_nms(T(boxes).to(cuda), T(valid).to(cuda), 0.7, 3000)
    torch.cuda.synchronize()
    assert int(want[1].sum()) > 2457
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_roi_align_kernel_scalar_width_on_unaligned_maps(cuda):
    """float32 maps that start 4 bytes past a 16-byte boundary take the scalar width."""
    rs = np.random.RandomState(5)
    feats = []
    for f in pyramid(rs, 2, 256, 64):
        buf = torch.empty(f.size + 1, device=cuda)
        feats.append(buf[1:].view(f.shape).copy_(T(f)))
    boxes = T(roi_boxes(rs, 2, 100)).to(cuda)
    out = torch.empty((2, 100, 7, 7, 64), device=cuda)
    assert port_roi_kernel.vector_width(feats, out) == 1
    got = port_roi_kernel.roi_align(feats, boxes, 7, (256, 256))
    want = port_roi_kernel.roi_align_plain(feats, boxes, 7, (256, 256))
    assert float((got - want).abs().max()) <= 1e-5 * max(float(f.abs().max()) for f in feats)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [7, 14])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, pool):
    rs = np.random.RandomState(pool + 1)
    level_hw = [(128, 128), (64, 64), (32, 32), (16, 16)]
    boxes = T(roi_boxes(rs, 2, 200)).to(cuda)
    dout = T(rs.normal(size=(2, 200, pool, pool, 256)).astype(np.float32)).to(cuda, dtype)
    before = port_roi_kernel.roi_align_backward.launches
    got = port_roi_kernel.roi_align_backward(dout, boxes, level_hw, (512, 512))
    want = port_roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, (512, 512))
    torch.cuda.synchronize()
    assert port_roi_kernel.roi_align_backward.launches == before + 1
    scale = max(float(w.float().abs().max()) for w in want)
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-8 * scale
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= tol
    # zero-area and padding ROIs (rows 1 and 2) leave the maps untouched
    empty = torch.zeros_like(dout)
    empty[:, 1:3] = dout[:, 1:3]
    assert all(float(g.abs().max()) == 0 for g in port_roi_kernel.roi_align_backward(empty, boxes, level_hw, (512, 512)))


@pytest.mark.gpu
def test_pyramid_roi_align_autograd_on_the_card(cuda):
    from maskrcnn_tf2_tpu_torch.ops.roi_align import pyramid_roi_align

    rs = np.random.RandomState(4)
    feats = [T(f).to(cuda, torch.bfloat16).requires_grad_() for f in pyramid(rs, 2, 256, 64)]
    boxes = T(roi_boxes(rs, 2, 50)).to(cuda)
    before = (port_roi_kernel.roi_align.launches, port_roi_kernel.roi_align_backward.launches)
    out = pyramid_roi_align(feats, boxes, 14, (256, 256))
    grads = torch.autograd.grad(out.float().square().sum(), feats)
    torch.cuda.synchronize()
    after = (port_roi_kernel.roi_align.launches, port_roi_kernel.roi_align_backward.launches)
    assert after == (before[0] + 1, before[1] + 1)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in grads)
