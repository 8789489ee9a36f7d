"""The PyTorch port's kernel wrappers: dispatch, plain versions, and on the card
the CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py

Tolerances on the card: NMS identical; ROIAlign within 1e-5 * max|feature|
in float32 (TF32 off) and one bf16 ulp of max|feature| in bf16 (both sum the
four weighted corners in float32 and round once, in another order); the
ROIAlign backward within 1e-5 * max|plain| in float32 and one bf16 ulp of
max|plain| in bf16 (both add in float32; the kernel in the fixed order ROI,
sample row, sample column, corner, the same bits from run to run, the plain
version's ``index_add_`` on the card with atomics in an order that changes).
On the CPU ``index_add_`` adds in the kernel's order, so the model of the
kernel's algorithm below equals the plain version bit for bit. The int8
convolution equal to its plain version bit for bit, in float32 and bfloat16:
both sum integers exactly and round the epilogue at the same three steps.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.kernels import int8_conv as port_int8_kernel
from maskrcnn_tf2_tpu_torch.kernels import nms as port_nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as port_roi_kernel
from maskrcnn_tf2_tpu_torch.ops.boxes import overlaps

from torch_port_helpers import BACKWARD_CASES, backward_case, nms_case, pyramid, random_boxes, roi_boxes

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


def axis_corners(lo, hi, p, dim):
    """float32 ``c0``, ``c1`` (ints) and ``t`` of the P samples along one axis of
    a box, with csrc/roi_align.cu's expressions (``sample_coord``, ``corners``)."""
    dim_m1 = np.float32(dim - 1)
    if p > 1:
        frac = np.arange(p, dtype=np.float32) / np.float32(p - 1)
        coord = (lo + (hi - lo) * frac) * dim_m1
    else:
        coord = np.full(1, (np.float32(0.5) * (lo + hi)) * dim_m1, np.float32)
    c0 = np.minimum(np.maximum(np.floor(coord), np.float32(0)), dim_m1)
    c1 = np.minimum(np.maximum(c0 + np.float32(1), np.float32(0)), dim_m1)
    t = np.minimum(np.maximum(coord - c0, np.float32(0)), np.float32(1))
    return c0.astype(np.int64), c1.astype(np.int64), t


def sample_range(c0, c1, q):
    """[lo, end) of the samples with a corner on pixel ``q`` (empty: lo >= end)."""
    hit = np.nonzero((c0 == q) | (c1 == q))[0]
    return (int(hit[0]), int(hit[-1]) + 1) if len(hit) else (len(c0), 0)


def owner_computes_model(dout, boxes, level_hw, image_shape, tile=(4, 4), chunk=256, round_rois=32):
    """csrc/roi_align.cu's backward in numpy float32. Every (image, level, tile)
    is one block: it filters the image's boxes ``chunk`` at a time by level and
    by the footprint [c0 of the first sample, c1 of the last] against its tile,
    takes the kept ROIs ``round_rois`` at a time, finds per tile row and column
    the contiguous range of samples with a corner there, and sums each pixel on
    its own, in the order ROI, sample row, sample column, corner, adding
    ``g * (wy * wx)`` for the corners that are this pixel."""
    b, n, p, _, c = dout.shape
    area = float(image_shape[0]) * float(image_shape[1])
    level_of = port_roi_kernel.roi_level_assignment(T(boxes), area, len(level_hw)).numpy()
    one = np.float32(1)
    maps = []
    for level, (h, w) in enumerate(level_hw):
        out = np.zeros((b, h, w, c), np.float32)
        for img, ty0, tx0 in np.ndindex(b, -(-h // tile[0]), -(-w // tile[1])):
            ty0, tx0 = ty0 * tile[0], tx0 * tile[1]
            acc = np.zeros(tile + (c,), np.float32)
            for first in range(0, n, chunk):
                kept = []
                for roi in range(first, min(first + chunk, n)):
                    y1, x1, y2, x2 = boxes[img, roi]
                    if not (y2 > y1 and x2 > x1) or level_of[img, roi] != level:
                        continue
                    cy0, cy1, _ = axis_corners(y1, y2, p, h)
                    cx0, cx1, _ = axis_corners(x1, x2, p, w)
                    if (cy0[0] < ty0 + tile[0] and cy1[-1] >= ty0
                            and cx0[0] < tx0 + tile[1] and cx1[-1] >= tx0):
                        kept.append(roi)
                for r0 in range(0, len(kept), round_rois):
                    entries = []
                    for roi in kept[r0 : r0 + round_rois]:
                        y1, x1, y2, x2 = boxes[img, roi]
                        ys, xs = axis_corners(y1, y2, p, h), axis_corners(x1, x2, p, w)
                        rows = [sample_range(ys[0], ys[1], ty0 + j) for j in range(tile[0])]
                        cols = [sample_range(xs[0], xs[1], tx0 + j) for j in range(tile[1])]
                        entries.append((roi, ys, xs, rows, cols))
                    for py, px in np.ndindex(*tile):
                        y, x = ty0 + py, tx0 + px
                        if y >= h or x >= w:
                            continue
                        for roi, (cy0, cy1, ty), (cx0, cx1, tx), rows, cols in entries:
                            for iy in range(*rows[py]):
                                for ix in range(*cols[px]):
                                    g = dout[img, roi, iy, ix]
                                    if cy0[iy] == y and cx0[ix] == x:
                                        acc[py, px] = acc[py, px] + g * ((one - ty[iy]) * (one - tx[ix]))
                                    if cy0[iy] == y and cx1[ix] == x:
                                        acc[py, px] = acc[py, px] + g * ((one - ty[iy]) * tx[ix])
                                    if cy1[iy] == y and cx0[ix] == x:
                                        acc[py, px] = acc[py, px] + g * (ty[iy] * (one - tx[ix]))
                                    if cy1[iy] == y and cx1[ix] == x:
                                        acc[py, px] = acc[py, px] + g * (ty[iy] * tx[ix])
            out[img, ty0 : ty0 + tile[0], tx0 : tx0 + tile[1]] = acc[: h - ty0, : w - tx0]
        maps.append(out)
    return maps


@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_owner_computes_model_matches_plain_backward(case):
    """The kernel's algorithm, modelled on the CPU, equals the plain version
    bit for bit in float32: tiles, the per-tile ROI filter, the per-axis sample
    ranges and the fixed add order lose and reorder nothing. ``index_add_`` on
    the CPU adds in index order, which is the model's order for every pixel."""
    dout, boxes, level_hw, image_shape, options = backward_case(case)
    got = owner_computes_model(dout, boxes, level_hw, image_shape, **options)
    want = port_roi_kernel.roi_align_backward_plain(T(dout), T(boxes), level_hw, image_shape)
    assert len(got) == len(level_hw)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert np.array_equal(g, w.numpy())
    if boxes.shape[1]:
        assert any(w.abs().max() > 0 for w in want)


def test_owner_computes_model_rounds_once_to_bf16():
    """bf16 cotangents: float32 sums of the widened values, one rounding."""
    dout, boxes, level_hw, image_shape, options = backward_case("rois_7x7")
    dout16 = T(dout).to(torch.bfloat16)
    got = owner_computes_model(dout16.float().numpy(), boxes, level_hw, image_shape, **options)
    want = port_roi_kernel.roi_align_backward_plain(dout16, T(boxes), level_hw, image_shape)
    for g, w in zip(got, want):
        assert w.dtype == torch.bfloat16 and torch.equal(T(g).to(torch.bfloat16), w)


def test_roi_align_kernels_pool_size_names_the_knobs():
    port_roi_kernel.check_pool_size(1)
    port_roi_kernel.check_pool_size(port_roi_kernel.MAX_POOL)
    for bad in (0, port_roi_kernel.MAX_POOL + 1):
        with pytest.raises(ValueError, match="pool_size / mask_pool_size"):
            port_roi_kernel.check_pool_size(bad)



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
# the int8 convolution (K7): the plain version against a loop, dispatch
# ---------------------------------------------------------------------------

# name -> (N, H, W, C, O, kernel, stride, groups, bias, amax scale of x)
INT8_CASES = {
    "3x3_s1_c64": (2, 16, 16, 64, 64, 3, 1, 1, True, 1.0),
    "3x3_s2_odd_groups_of_4": (2, 17, 15, 128, 128, 3, 2, 32, False, 1.0),
    "depthwise_3x3_s2": (2, 15, 16, 96, 96, 3, 2, 96, False, 1.0),
    "depthwise_5x5": (1, 12, 12, 40, 40, 5, 1, 40, False, 1.0),
    "1x1_s2_c256_o1024": (2, 16, 16, 256, 1024, 1, 2, 1, False, 1.0),
    "c3_7x7_s2": (2, 21, 20, 3, 16, 7, 2, 1, True, 1.0),
    "c36_3x3_s2_odd": (2, 13, 11, 36, 72, 3, 2, 1, True, 1.0),
    "fc_k12544": (300, 1, 1, 12544, 1024, 1, 1, 1, True, 1.0),
    "amax_0": (1, 8, 8, 64, 32, 3, 1, 1, True, 0.0),
    # the tensor-core path's edges: M, N and K tails, each copy width, a split of K
    "tails_m_n_k_c48": (3, 7, 9, 48, 200, 3, 1, 1, True, 1.0),
    "c4_3x3": (2, 9, 11, 4, 24, 3, 1, 1, True, 1.0),
    "c40_3x3_s2": (2, 13, 12, 40, 72, 3, 2, 1, False, 1.0),
    "split_k_3x3_c256": (2, 8, 8, 256, 256, 3, 1, 1, True, 1.0),
    "split_k_tails_c112": (3, 7, 9, 112, 200, 3, 1, 1, True, 1.0),
    # the grouped kernel's: ResNeXt's groups of 8, 16 and 32, depthwise 5x5/2
    "groups_of_8_s2": (2, 11, 13, 256, 256, 3, 2, 32, False, 1.0),
    "groups_of_16": (1, 9, 10, 512, 512, 3, 1, 32, False, 1.0),
    "groups_of_32_s2": (1, 9, 8, 1024, 1024, 3, 2, 32, True, 1.0),
    "depthwise_5x5_s2": (2, 17, 19, 120, 120, 5, 2, 120, False, 1.0),
}


def int8_case(name, device="cpu"):
    """``(x [N, H, W, C] int8, w [O, k, k, C / g] int8, sx, sw, bias, stride, groups)``."""
    n, h, wd, c, o, k, stride, groups, bias, amax = INT8_CASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    x = rs.randint(-127, 128, (n, h, wd, c)) if amax else np.zeros((n, h, wd, c))
    w = rs.randint(-127, 128, (o, k, k, c // groups))
    sx = np.float32(max(amax, 1e-6) / 127)
    sw = rs.uniform(1e-4, 1e-2, o).astype(np.float32)
    b = rs.normal(size=o).astype(np.float32) if bias else None
    dev = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    return (dev(x, torch.int8), dev(w, torch.int8), dev(sx, torch.float32), dev(sw, torch.float32),
            None if b is None else dev(b, torch.float32), stride, groups)


def int8_conv_loop(x, w, stride, groups):
    """The int32 sums by an explicit loop over taps and groups, in numpy int64."""
    from maskrcnn_tf2_tpu_torch.models.layers import same_pad_amounts

    x, w = x.numpy().astype(np.int64), w.numpy().astype(np.int64)
    n, h, wd, c = x.shape
    o, k, _, cg = w.shape
    top, bottom = same_pad_amounts(h, k, stride)
    left, right = same_pad_amounts(wd, k, stride)
    xp = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)))
    ho, wo = -(-h // stride), -(-wd // stride)
    og = o // groups
    acc = np.zeros((n, ho, wo, o), np.int64)
    for g in range(groups):
        for dy in range(k):
            for dx in range(k):
                patch = xp[:, dy : dy + stride * (ho - 1) + 1 : stride, dx : dx + stride * (wo - 1) + 1 : stride,
                           g * cg : (g + 1) * cg]
                acc[..., g * og : (g + 1) * og] += patch @ w[g * og : (g + 1) * og, dy, dx, :].T
    return acc


@pytest.mark.parametrize("case", ["3x3_s2_odd_groups_of_4", "depthwise_3x3_s2", "c3_7x7_s2", "c36_3x3_s2_odd",
                                  "amax_0", "groups_of_8_s2", "depthwise_5x5_s2"])
def test_int8_conv_plain_matches_a_loop(case):
    x, w, sx, sw, bias, stride, groups = int8_case(case)
    acc = port_int8_kernel.int8_conv_accumulate_plain(x, w, stride, groups)
    np.testing.assert_array_equal(acc.numpy(), int8_conv_loop(x, w, stride, groups))
    y = port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups)
    want = acc.numpy().astype(np.float32) * (sx.numpy() * sw.numpy())
    if bias is not None:
        want = want + bias.numpy()
    np.testing.assert_array_equal(y.numpy(), want)


def test_int8_conv_cpu_takes_the_plain_version_without_launching():
    before = port_int8_kernel.int8_conv.launches
    x, w, sx, sw, bias, stride, groups = int8_case("3x3_s1_c64")
    for dtype in (torch.float32, torch.bfloat16):
        got = port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
        want = port_int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, dtype)
        assert got.dtype == dtype and got.shape == (2, 16, 16, 64) and torch.equal(got, want)
    assert port_int8_kernel.int8_conv.launches == before


def test_int8_conv_refuses_bad_inputs():
    x, w, sx, sw, bias, stride, groups = int8_case("3x3_s1_c64")
    with pytest.raises(TypeError):
        port_int8_kernel.int8_conv(x.to(torch.int32), w, sx, sw, bias)
    with pytest.raises(ValueError, match="groups"):
        port_int8_kernel.int8_conv(x, w, sx, sw, bias, groups=3)
    with pytest.raises(ValueError, match="overflow"):
        big = torch.zeros((1, 1, 1, port_int8_kernel.MAX_K + 1), dtype=torch.int8)
        port_int8_kernel.int8_conv(big, big, sx, torch.ones(1), None)
    with pytest.raises(TypeError):
        port_int8_kernel.int8_conv(x, w, sx, sw, bias, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        meta = [t.to("meta") for t in (x, w, sx, sw, bias)]
        port_int8_kernel.int8_conv(*meta)


def int8_site_shapes(backbone, **heads):
    """``(name, c, o, kh, kw, stride, groups)`` of every int8 site of a
    full-width int8 detector (the flagship's widths: 512 px, 81 classes),
    read from the modules built on the meta device, without a forward."""
    from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
    from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
    from maskrcnn_tf2_tpu_torch.models.quant import Int8Conv2d, Int8Linear

    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone=backbone, quant_mode="int8", **heads)
    with torch.device("meta"):
        model = MaskRCNN(cfg, device="meta")
    shapes = []
    for name, m in model.named_modules():
        if isinstance(m, Int8Conv2d):
            shapes.append((name, m.in_channels, m.out_channels, *m.kernel_size, m.stride[0], m.groups))
        elif isinstance(m, Int8Linear):
            shapes.append((name, m.in_features, m.out_features, 1, 1, 1, 1))
    return shapes


# sites (modules): the RPN conv is one site called on 5 levels, so 61 sites
# launch 65 times a request; MobileNet V2's 17 depthwise sites are int8 under DW=1
@pytest.mark.parametrize("backbone,heads,count", [
    ("resnet50", {}, 61), ("resnet50", {"quant_classifier": True, "quant_mask_head": True}, 67),
    ("resnext50", {}, 61), ("mobilenetv2", {}, 59)])
def test_int8_plan_puts_every_group_1_site_on_the_tensor_cores(backbone, heads, count):
    """Every site of one group, at any map size, on the tensor-core path with
    16-byte copies where its channels allow; the grouped sites on the grouped
    kernel (ResNeXt's dp4a words, MobileNet V2's depthwise under DW=1)."""
    shapes = int8_site_shapes(backbone, **heads)
    assert len(shapes) == count
    for name, c, o, kh, kw, stride, groups in shapes:
        for n, hw in ((2, 128), (2, 16), (2000, 1)):
            p = port_int8_kernel.plan(n, hw, hw, c, o, kh, kw, stride, groups)
            if groups == 1:
                assert p.kernel == "tensor-core", name
                assert p.vec == (16 if c % 16 == 0 else 8 if c % 8 == 0 else 4 if c % 4 == 0 else 1), name
            elif c // groups == 1:
                assert p.kernel == "grouped depthwise" and backbone == "mobilenetv2", name
            else:
                assert p.kernel == "grouped dp4a words" and backbone == "resnext50", name


# (n, h, w, c, o, k, stride): flagship shapes of one request of 2 images and
# the classifier's FCs over 2 x 1000 ROIs
SPLIT_SHAPES = [
    (2, 128, 128, 256, 256, 3, 1),  # an FPN output conv on P2: 256 tiles, no split
    (2, 32, 32, 1024, 256, 1, 1),  # C4's 1x1 reduce
    (2, 16, 16, 512, 512, 3, 1),  # C5's 3x3
    (2, 16, 16, 2048, 256, 1, 1),  # the FPN lateral on C5
    (2, 8, 8, 256, 512, 3, 1),  # the RPN conv on P6
    (2000, 1, 1, 12544, 1024, 1, 1),  # FC1
    (2000, 1, 1, 1024, 1024, 1, 1),  # FC2
    (2, 7, 9, 3, 64, 7, 2),  # a c = 3 stem
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("sms", [port_int8_kernel.SMS, 8, 100000])
def test_int8_split_covers_each_k_range_once(shape, sms):
    n, h, w, c, o, k, stride = shape
    p = port_int8_kernel.plan(n, h, w, c, o, k, k, stride, 1, sms=sms)
    ranges = p.k_ranges()
    assert p.k_steps * port_int8_kernel.STEP_K >= k * k * c > (p.k_steps - 1) * port_int8_kernel.STEP_K
    assert len(ranges) == p.split == p.grid[2] and 1 <= p.split <= port_int8_kernel.MAX_SPLIT
    assert ranges[0][0] == 0 and ranges[-1][1] == p.k_steps * port_int8_kernel.STEP_K
    assert all(a < b for a, b in ranges) and all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    tiles = p.grid[0] * p.grid[1]
    if tiles >= sms:
        assert p.split == 1
    assert p.workspace_elements() == (0 if p.split == 1 else p.split * tiles * p.tile * p.tile)


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_int8_plan_fills_a_wave(shape):
    """The 128-pixel tile where there are more than 64 channels and half a
    wave of such tiles, else the 64-pixel one; K split where the grid falls
    short of a wave and K allows two ranges of the tile's least length."""
    n, h, w, c, o, k, stride = shape
    sms = port_int8_kernel.SMS
    p = port_int8_kernel.plan(n, h, w, c, o, k, k, stride)
    m = n * -(-h // stride) * -(-w // stride)
    assert p.tile == (128 if o > 64 and -(-m // 128) * -(-o // 128) >= sms // 2 else 64)
    assert p.grid[:2] == (-(-m // p.tile), -(-o // p.tile))
    short = p.grid[0] * p.grid[1] < sms
    assert (p.split > 1) == (short and p.k_steps >= 2 * port_int8_kernel.MIN_STEPS_PER_SPLIT[p.tile])


def test_int8_plan_of_the_flagship_sites():
    """The choices measured best on the card at the flagship's sites."""
    plan = port_int8_kernel.plan
    assert plan(2, 128, 128, 256, 512, 3, 3).tile == 128 and plan(2, 128, 128, 256, 512, 3, 3).split == 1
    assert plan(2000, 1, 1, 12544, 1024, 1, 1)[2:6] == ((16, 8, 2), 128, 196, 2)  # FC1: half a wave, split
    assert plan(2000, 1, 1, 1024, 1024, 1, 1).split == 1  # FC2: K too short to split
    assert plan(2, 128, 128, 64, 64, 3, 3).tile == 64  # 64 channels
    assert plan(2, 16, 16, 512, 512, 3, 3)[2:6] == ((8, 8, 4), 64, 72, 4)  # C5's 3x3


@pytest.mark.parametrize("case", ["split_k_3x3_c256", "split_k_tails_c112", "fc_k12544"])
def test_int8_split_partials_sum_in_any_order(case):
    """The int32 partial sums over the plan's K ranges (the weights outside a
    range zeroed), added in any order, equal the whole sum."""
    x, w, _, _, _, stride, groups = int8_case(case)
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    p = port_int8_kernel.plan(n, h, wd, c, o, kh, kw, stride, groups, sms=100000)
    assert p.split > 1
    flat = w.reshape(o, -1)
    partials = []
    for k0, k1 in p.k_ranges():
        part = torch.zeros_like(flat)
        part[:, k0:k1] = flat[:, k0:k1]
        partials.append(port_int8_kernel.int8_conv_accumulate_plain(x, part.reshape(w.shape), stride, groups))
    whole = port_int8_kernel.int8_conv_accumulate_plain(x, w, stride, groups)
    rs = np.random.RandomState(5)
    for order in [range(p.split), reversed(range(p.split))] + [rs.permutation(p.split) for _ in range(3)]:
        total = torch.zeros_like(whole)
        for i in order:
            total += partials[i]
        assert torch.equal(total, whole)


def test_int8_grouped_plan():
    plan = port_int8_kernel.plan
    assert plan(2, 64, 64, 128, 128, 3, 3, 1, 32) == ("grouped dp4a words", 16, (64, 2, 2), 0, 0, 1, 0)
    assert plan(2, 63, 65, 240, 240, 5, 5, 2, 240).kernel == "grouped depthwise"
    assert plan(2, 63, 65, 240, 240, 5, 5, 2, 240).vec == 16
    assert plan(2, 17, 19, 120, 120, 5, 5, 2, 120).vec == 4  # the last slice ends at 120
    assert plan(1, 8, 8, 6, 6, 3, 3, 1, 3).kernel == "grouped bytes"  # groups of 2
    assert plan(1, 8, 8, 64, 64, 3, 3, 1, 64, x_align=4).vec == 4
    assert plan(1, 8, 8, 64, 64, 3, 3, 1, 1, w_align=8).vec == 8


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


def poison_free_memory(numel, dtype, device):
    """Leave NaNs in the block the allocator hands out next, so that an output
    from ``torch.empty`` shows every element its kernel did not write."""
    junk = torch.full((numel,), float("nan"), dtype=dtype, device=device)
    del junk


def hold_backward_on_the_card(dout, boxes, level_hw, image_shape):
    """Kernel against plain at the card's tolerances; two launches bit-equal;
    where the plain maps are zero (no ROI reaches) the kernel's are exactly zero."""
    want = port_roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape)
    poison_free_memory(sum(w.numel() for w in want), dout.dtype, dout.device)
    before = port_roi_kernel.roi_align_backward.launches
    got = port_roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    again = port_roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    torch.cuda.synchronize()
    assert port_roi_kernel.roi_align_backward.launches == before + 2
    scale = max([float(w.float().abs().max()) for w in want if w.numel()] + [0.0])
    tol = 1e-5 * scale if dout.dtype == torch.float32 else 2.0**-8 * scale
    for g, a, w in zip(got, again, want):
        assert g.dtype == dout.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        if w.numel():
            assert float((g.float() - w.float()).abs().max()) <= tol
            assert bool((g[w == 0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [7, 14])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, pool):
    rs = np.random.RandomState(pool + 1)
    level_hw = [(128, 128), (64, 64), (32, 32), (16, 16)]
    boxes = T(roi_boxes(rs, 2, 200)).to(cuda)
    dout = T(rs.normal(size=(2, 200, pool, pool, 256)).astype(np.float32)).to(cuda, dtype)
    hold_backward_on_the_card(dout, boxes, level_hw, (512, 512))
    # zero-area and padding ROIs (rows 1 and 2) leave the maps untouched
    empty = torch.zeros_like(dout)
    empty[:, 1:3] = dout[:, 1:3]
    assert all(float(g.abs().max()) == 0 for g in port_roi_kernel.roi_align_backward(empty, boxes, level_hw, (512, 512)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BACKWARD_CASES)
def test_roi_align_backward_kernel_on_the_model_cases(cuda, dtype, case):
    """Tile-straddling and elongated boxes, edge boxes, a 2x2 level, P = 1,
    C = 36 (the scalar width in bf16), ragged tiles, N = 0."""
    dout, boxes, level_hw, image_shape, _ = backward_case(case)
    hold_backward_on_the_card(T(dout).to(cuda, dtype), T(boxes).to(cuda), level_hw, image_shape)


@pytest.mark.gpu
def test_roi_align_backward_kernel_matches_its_model(cuda):
    """float32 on the card against the CPU model of the same algorithm: the
    same sums in the same order, so the same bits."""
    dout, boxes, level_hw, image_shape, _ = backward_case("rois_14x14")
    got = port_roi_kernel.roi_align_backward(T(dout).to(cuda), T(boxes).to(cuda), level_hw, image_shape)
    want = owner_computes_model(dout, boxes, level_hw, image_shape)
    for g, w in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), w)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_conv_kernel_matches_plain(cuda, dtype, case):
    """Bit-equal to the plain version; two launches give the same bits."""
    x, w, sx, sw, bias, stride, groups = int8_case(case, cuda)
    before = port_int8_kernel.int8_conv.launches
    got = port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
    again = port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
    want = port_int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, dtype)
    torch.cuda.synchronize()
    assert port_int8_kernel.int8_conv.launches == before + 2
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("case,path,vec", [("3x3_s1_c64", "tensor-core", 16), ("c3_7x7_s2", "tensor-core", 1),
                                           ("c4_3x3", "tensor-core", 4), ("c40_3x3_s2", "tensor-core", 8),
                                           ("3x3_s2_odd_groups_of_4", "grouped dp4a words", 16),
                                           ("depthwise_3x3_s2", "grouped depthwise", 16)])
def test_int8_conv_kernel_path(cuda, case, path, vec):
    """The launcher reports the kernel and the copy width it took."""
    x, w, sx, sw, bias, stride, groups = int8_case(case, cuda)
    port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups)
    assert port_int8_kernel.int8_conv.last_path == path
    assert port_int8_kernel.int8_conv.last_plan.vec == vec


@pytest.mark.gpu
@pytest.mark.parametrize("sms", [1, 100000])
@pytest.mark.parametrize("case", ["split_k_3x3_c256", "split_k_tails_c112", "fc_k12544"])
def test_int8_conv_kernel_split_on_and_off(cuda, monkeypatch, case, sms):
    """The same bits with K whole (one SM's wave is never short) and split as
    far as the plan goes; the tile counters are zero again after each launch."""
    monkeypatch.setattr(port_int8_kernel, "SMS", sms)
    x, w, sx, sw, bias, stride, groups = int8_case(case, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = port_int8_kernel.int8_conv(x, w, sx, sw, bias, stride, groups, dtype)
        want = port_int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, dtype)
        torch.cuda.synchronize()
        assert (port_int8_kernel.int8_conv.last_plan.split > 1) == (sms > 1)
        assert torch.equal(got, want)
    assert all(int(buf.abs().sum()) == 0 for buf in port_int8_kernel._counters.values())


# ---------------------------------------------------------------------------
# the kernels as torch.library ops, on the card
# ---------------------------------------------------------------------------

OPS = torch.ops.maskrcnn_tf2_tpu_torch


def op_case(name):
    """``(op, CPU args, the wrapper whose counter the launch raises, the plain
    version as a function of the op's args, tolerance as a share of the
    plain output's max)``; float32 throughout."""
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "greedy_nms":
        boxes_s, valid_s, limit, thr = sorted_nms_case("unsorted_class_offsets")
        return (OPS.greedy_nms.default, (T(boxes_s), T(valid_s), thr, limit), port_nms_kernel.greedy_nms,
                port_nms_kernel.greedy_nms_plain, 0.0)
    boxes = T(roi_boxes(rs, 2, 64))
    if name == "roi_align":
        feats = [T(f) for f in pyramid(rs, 2, 256, 64)]
        return (OPS.roi_align.default, (feats, boxes, 7, [256, 256], 244.0), port_roi_kernel.roi_align,
                port_roi_kernel.roi_align_plain, 1e-5)
    if name == "roi_align_backward":
        level_hw = [(64, 64), (32, 32), (16, 16), (8, 8)]

        def plain(dout, boxes, flat_hw, image_shape, denominator):
            maps = port_roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape, denominator)
            return torch.cat([m.reshape(-1) for m in maps])

        dout = T(rs.normal(size=(2, 64, 14, 14, 64)).astype(np.float32))
        return (OPS.roi_align_backward.default, (dout, boxes, [v for hw in level_hw for v in hw], [256, 256], 244.0),
                port_roi_kernel.roi_align_backward, plain, 1e-5)
    x, w, sx, sw, bias, stride, groups = int8_case("3x3_s1_c64")

    def plain(x, w, sx, sw, bias, stride, groups, out_dtype, tile, split):
        return port_int8_kernel.int8_conv_plain(x, w, sx, sw, bias, stride, groups, torch.float32)

    return (OPS.int8_conv.default, (x, w, sx, sw, bias, stride, groups, 0, 0, 0),  # dtype code 0: float32
            port_int8_kernel.int8_conv, plain, 0.0)


def at_offset(t, device, offset):
    """``t`` on ``device`` as a view ``offset`` elements into a larger buffer:
    at 1, off every 16-byte boundary, as an input can lie inside a compiled
    graph's pooled buffer."""
    if not isinstance(t, torch.Tensor):
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
    view = buf[offset:].view(t.shape).copy_(t)
    assert offset == 0 or view.data_ptr() % 16
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name", ["greedy_nms", "roi_align", "roi_align_backward", "int8_conv"])
def test_op_launches_its_kernel_and_equals_plain(cuda, name, offset):
    """Each op on CUDA tensors launches its kernel once (its wrapper's counter
    up by one) and equals the plain version; handed views off every 16-byte
    boundary it still launches (on its own aligned copies where the kernel
    reads 16 bytes at a time) and still equals it."""
    op, args, wrapper, plain, tol = op_case(name)
    args = torch.utils._pytree.tree_map(lambda t: at_offset(t, cuda, offset), args)
    before = wrapper.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if tol == 0:
            assert torch.equal(g, w)
        else:
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())
