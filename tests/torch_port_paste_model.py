"""The arithmetic that ``csrc/paste_masks.cu`` (K8) encodes, written in numpy
as the kernel does it, step by step and with single-rounded fused
multiply-adds, so that the CPU tests can hold it against the host's own
``unmold_detections`` and ``F.interpolate`` bit for bit.

Imports neither JAX nor the port, so the card's tests can use it too.

``F.interpolate(mode="bilinear", align_corners=False)`` on a CPU float32
``[1, 1, 28, 28]`` mask takes one of two paths of ATen's
``UpSampleKernel.cpp``, chosen by the output's size:

* ``out_h + out_w > 128``: the separable kernel. Each row is
  ``fma(x0, wx0, x1 * wx1)``, the value ``fma(t0, wy0, t1 * wy1)``;
* ``out_h + out_w <= 128``: the channels-last kernel, with the four corner
  weights ``wy * wx`` rounded first and summed as
  ``fma(x11, w11, fma(x10, w10, fma(x00, w00, x01 * w01)))``.

Both find the source index as ``fma(in / out, d + 0.5, -0.5)``, clamped at 0,
floored and capped at ``in - 1``, with ``lambda1 = min(max(src - i0, 0), 1)``
and ``lambda0 = 1 - lambda1``.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32

SMALL_PATH_MAX = 128  # out_h + out_w at or below it: the channels-last kernel


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (round to nearest, ties to even).

    The product of two float32 values is exact in float64; the float64 sum
    ``s`` carries its exact error ``e`` (TwoSum). Rounding ``s`` to float32 is
    then correct unless ``s`` sits exactly halfway between two float32 values
    while ``e`` is not zero: the exact sum then lies on ``e``'s side of it."""
    a = np.asarray(a, f32).astype(np.float64)
    b = np.asarray(b, f32).astype(np.float64)
    c = np.asarray(c, f32).astype(np.float64)
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.astype(f32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, f32(np.inf), f32(-np.inf)).astype(f32))
    tie = (s != r64) & (r64 + other.astype(np.float64) == 2 * s) & (e != 0)
    # at such a tie the exact sum lies past s in e's direction: take the neighbour there
    toward_e = np.where((other.astype(np.float64) - s) * e > 0, other, r)
    return np.where(tie, toward_e, r).astype(f32)


def index_lambda(n_in: int, n_out: int):
    """Per output index: ``(i0, i1, lambda0, lambda1)`` of one dimension."""
    d = np.arange(n_out)
    if n_in == n_out:
        return d, d, np.ones(n_out, f32), np.zeros(n_out, f32)
    scale = f32(f32(n_in) / f32(n_out))
    src = fma32(scale, d.astype(f32) + f32(0.5), f32(-0.5))
    src = np.where(src < 0, f32(0), src).astype(f32)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    l1 = np.minimum(np.maximum(src - i0.astype(f32), f32(0)), f32(1)).astype(f32)
    i1 = i0 + (i0 < n_in - 1)
    return i0, i1, (f32(1) - l1).astype(f32), l1


def bilinear(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``F.interpolate`` of a float32 ``[mh, mw]`` mask to ``[out_h, out_w]``,
    by the kernel's arithmetic."""
    mask = np.asarray(mask, f32)
    y0, y1, wy0, wy1 = index_lambda(mask.shape[0], out_h)
    x0, x1, wx0, wx1 = index_lambda(mask.shape[1], out_w)
    wy0, wy1 = wy0[:, None], wy1[:, None]
    i00, i01 = mask[y0][:, x0], mask[y0][:, x1]
    i10, i11 = mask[y1][:, x0], mask[y1][:, x1]
    if out_h + out_w > SMALL_PATH_MAX:
        t0 = fma32(i00, wx0, (i01 * wx1).astype(f32))
        t1 = fma32(i10, wx0, (i11 * wx1).astype(f32))
        return fma32(t0, wy0, (t1 * wy1).astype(f32))
    w00, w01 = (wy0 * wx0).astype(f32), (wy0 * wx1).astype(f32)
    w10, w11 = (wy1 * wx0).astype(f32), (wy1 * wx1).astype(f32)
    return fma32(i11, w11, fma32(i10, w10, fma32(i00, w00, (i01 * w01).astype(f32))))


def pixel_boxes(detections: np.ndarray, original_shape, image_shape, window):
    """``(n, boxes [n, 4] int32, keep)`` of one image's ``[D, 6]`` detections,
    as the kernel computes them: ``n`` the first detection of class 0, the
    window's shift and scale and the normalized boxes in float32 with IEEE
    division, the scale to pixels and the ``(0, 0, 1, 1)`` offset in float64,
    rounded half to even; ``keep`` the boxes of positive area, in order."""
    det = np.asarray(detections, f32)
    zero = np.nonzero(det[:, 4] == 0)[0]
    n = int(zero[0]) if len(zero) else det.shape[0]
    hm1, wm1 = f32(image_shape[0] - 1), f32(image_shape[1] - 1)
    wy1, wx1, wy2, wx2 = (f32(v) for v in window)
    sy, sx = f32(wy1 / hm1), f32(wx1 / wm1)
    ey, ex = f32(f32(wy2 - f32(1)) / hm1), f32(f32(wx2 - f32(1)) / wm1)
    shift = np.array([sy, sx, sy, sx], f32)
    scale = np.maximum(np.array([ey - sy, ex - sx, ey - sy, ex - sx], f32), f32(1e-10))
    norm = ((det[:n, :4] - shift).astype(f32) / scale).astype(f32)
    oh, ow = original_shape[0], original_shape[1]
    pix = norm.astype(np.float64) * np.array([oh - 1, ow - 1, oh - 1, ow - 1], np.float64)
    pix = pix + np.array([0.0, 0.0, 1.0, 1.0])
    boxes = np.rint(pix).astype(np.int32)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return n, boxes, np.nonzero(area > 0)[0]
