"""OpenCV's image primitives that the host augmentation uses, in numpy.

The JAX package's ``data/augment.py`` calls about fifteen cv2 functions; the
card's machine has no cv2. Each function here follows the arithmetic of the
cv2 build it is tested against (OpenCV 5 on x86-64 with AVX-512; the tests in
``tests/test_torch_port_host_augment.py`` hold each one against cv2), so that
it returns cv2's values, not merely close ones:

* ``warp_affine`` / ``warp_perspective``, bilinear, uint8: OpenCV's float
  warp kernels (``warp_kernels.simd.hpp``). The inverse matrix is rounded to
  float32; the row term ``M1 * y + M2`` is a float32 product and sum, the
  source coordinate ``fma(M0, x, row)`` (divided by ``fma(M6, x, M7 * y +
  M8)`` in perspective); the four neighbours, zero outside the image, are
  blended by three fused lerps and rounded half to even;
* the same warps, nearest, any channel count (the masks): the fixed-point
  remap of ``imgwarp.cpp``: affine coordinates in 1/1024 px (``AB_BITS``)
  rounded half up; perspective coordinates in double, per 64-column block,
  rounded half to even;
* ``get_rotation_matrix_2d`` and ``get_perspective_transform`` (the 8x8
  system built from float32 products and solved by OpenCV's own partial-pivot
  LU) give cv2's matrices bit for bit;
* ``gaussian_blur_u8`` (ksize 3 or 5, sigma 0): the binomial kernels in
  exact integers, rounded half up, as OpenCV's 8.8 fixed-point path does;
  ``gaussian_blur_f32``: the kernel from sigma in float32, a row pass of
  fused multiply-adds in tap order and a column pass of fused multiply-adds
  over symmetric pairs, each on 8-wide vectors (the scalar tail of a row
  without fusing);
* ``box_blur3_f32`` (``cv2.blur`` 3x3): sums in float64 times 1/9;
  ``filter2d_u8``: float32 taps, rounded half to even; ``resize_linear_f32``:
  the lerp form, fused, of the IPP resize cv2 calls for float32;
* colour conversions of uint8 RGB: HSV forward in integers with OpenCV's
  division tables; HSV back, and HLS both ways, in float32 with OpenCV's
  fused operations (HSV back truncates in 32-pixel blocks and rounds a
  row's tail); Lab both ways in OpenCV's bit-exact
  integer paths (``color_lab.cpp``) with its gamma, cube-root and Lab-to-XYZ
  tables, including the rounding of its vectorised ``a / 500`` and
  ``b / 200``;
* ``clahe``: ``createCLAHE(clip, tiles).apply`` (``clahe.cpp``);
* ``draw_lines``: ``cv2.line`` thickness 1, 8-connected, many segments at
  once.

Borders are ``BORDER_REFLECT_101`` for the filters and constant zero for the
warps. A fused multiply-add is emulated in float64 (the product of two
float32 values is exact there) and rounded once more to float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from maskrcnn_tf2_tpu_torch.data.raster import _clip_line

f32 = np.float32
f64 = np.float64


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to float32 (float32 inputs)."""
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(f32)


def reflect101(n: int, before: int, after: int) -> np.ndarray:
    """Source indices of ``n`` samples padded by ``before``/``after`` with
    ``BORDER_REFLECT_101`` (``borderInterpolate``, which reflects again while
    the pad is wider than the image)."""
    p = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(p)
    while ((p < 0) | (p >= n)).any():
        p = np.where(p < 0, -p, np.where(p >= n, 2 * (n - 1) - p, p))
    return p


def _pad101(image: np.ndarray, ry: int, rx: int) -> np.ndarray:
    h, w = image.shape[:2]
    return image[reflect101(h, ry, ry)][:, reflect101(w, rx, rx)]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: ``[2, 3]`` float64; ``center`` is rounded
    to float32 as cv2's ``Point2f`` rounds it."""
    cx, cy = float(f32(center[0])), float(f32(center[1]))
    angle = angle * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array(
        [[alpha, beta, (1 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1 - alpha) * cy]], f64
    )


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's ``LU64f``: Gaussian elimination with partial pivoting, in
    its order of operations."""
    a = a.copy()
    b = b.copy()
    m = len(b)
    for i in range(m):
        k = i
        for j in range(i + 1, m):  # the first row of the largest |a[j, i]|
            if abs(a[j, i]) > abs(a[k, i]):
                k = j
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1 :] += alpha * a[i, i + 1 :]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` of 4 point pairs: ``[3, 3]`` float64."""
    src = np.asarray(src, f32)
    dst = np.asarray(dst, f32)
    a = np.zeros((8, 8), f64)
    b = np.zeros(8, f64)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = src[i, 0]
        a[i, 1] = a[i + 4, 4] = src[i, 1]
        a[i, 2] = a[i + 4, 5] = 1
        a[i, 6] = -src[i, 0] * dst[i, 0]  # float32 products, as Point2f's
        a[i, 7] = -src[i, 1] * dst[i, 0]
        a[i + 4, 6] = -src[i, 0] * dst[i, 1]
        a[i + 4, 7] = -src[i, 1] * dst[i, 1]
        b[i] = dst[i, 0]
        b[i + 4] = dst[i, 1]
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``invertAffineTransform``, as ``warpAffine`` inverts: 6 float64s."""
    m = np.asarray(m, f64).ravel().copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert3(s: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 float64 matrix (the closed form of ``DECOMP_LU``
    for 3x3): 9 float64s."""
    s = np.asarray(s, f64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    d = 1.0 / d
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d, (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d, (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d, (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d, (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d,
    ], f64)


def _bilinear_u8(image: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Sample uint8 ``[H, W, C]`` at float32 coordinates, zero outside, as
    OpenCV's float warp kernels blend (three fused lerps, round half to even)."""
    h, w = image.shape[:2]
    fx = np.floor(np.nan_to_num(sx, nan=-4.0, posinf=w + 4.0, neginf=-4.0).clip(-4, w + 4))
    fy = np.floor(np.nan_to_num(sy, nan=-4.0, posinf=h + 4.0, neginf=-4.0).clip(-4, h + 4))
    ax = (sx - fx.astype(f32))[..., None]
    ay = (sy - fy.astype(f32))[..., None]
    ix = fx.astype(np.int64) + 1  # index into the zero-bordered copy
    iy = fy.astype(np.int64) + 1
    pad = np.zeros((h + 2, w + 2, image.shape[2]), np.uint8)
    pad[1:-1, 1:-1] = image
    flat = pad.reshape((h + 2) * (w + 2), -1)
    x0, x1 = ix.clip(0, w + 1), (ix + 1).clip(0, w + 1)
    r0, r1 = iy.clip(0, h + 1) * (w + 2), (iy + 1).clip(0, h + 1) * (w + 2)
    p00, p01, p10, p11 = (np.take(flat, r + x, axis=0).astype(f32) for r, x in ((r0, x0), (r0, x1), (r1, x0), (r1, x1)))
    top = fma32(ax, p01 - p00, p00)
    bot = fma32(ax, p11 - p10, p10)
    v = fma32(ay, bot - top, top)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _gather_nearest(image: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = image.shape[:2]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    out = image[y.clip(0, h - 1), x.clip(0, w - 1)]
    out[~inside] = 0
    return out


def warp_affine(image: np.ndarray, m: np.ndarray, dsize, nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(image, m, dsize, flags=INTER_LINEAR or INTER_NEAREST)``,
    constant border 0. ``image`` is uint8 ``[H, W]`` or ``[H, W, C]`` (any C
    nearest, C channels bilinear); ``dsize`` is ``(w, h)``."""
    w, h = dsize
    inv = _invert_affine(m)
    squeeze = image.ndim == 2
    src = image[..., None] if squeeze else image
    if nearest:  # imgwarp.cpp: AB_BITS = 10, round_delta = AB_SCALE / 2
        xs = np.arange(w, dtype=f64)
        ys = np.arange(h, dtype=f64)[:, None]
        adelta = np.rint(inv[0] * xs * 1024).astype(np.int64)
        bdelta = np.rint(inv[3] * xs * 1024).astype(np.int64)
        x0 = np.rint((inv[1] * ys + inv[2]) * 1024).astype(np.int64) + 512
        y0 = np.rint((inv[4] * ys + inv[5]) * 1024).astype(np.int64) + 512
        out = _gather_nearest(src, (x0 + adelta) >> 10, (y0 + bdelta) >> 10)
    else:
        mf = inv.astype(f32)
        xs = np.arange(w, dtype=f32)[None, :]
        ys = np.arange(h, dtype=f32)[:, None]
        sx = fma32(mf[0], xs, mf[1] * ys + mf[2])
        sy = fma32(mf[3], xs, mf[4] * ys + mf[5])
        out = _bilinear_u8(src, sx, sy)
    return out[..., 0] if squeeze else out


def warp_perspective(image: np.ndarray, m: np.ndarray, dsize, nearest: bool = False) -> np.ndarray:
    """``cv2.warpPerspective(image, m, dsize, flags=INTER_LINEAR or
    INTER_NEAREST)``, constant border 0; as ``warp_affine``."""
    w, h = dsize
    inv = _invert3(m)
    squeeze = image.ndim == 2
    src = image[..., None] if squeeze else image
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if nearest:  # WarpPerspectiveInvoker: X0/Y0/W0 per 64-column block, then per column
            bh = min(16, h)
            bw = min(1024 // bh, w)
            xs = np.arange(w)
            xb = (xs // bw * bw).astype(f64)
            x1 = (xs - xs // bw * bw).astype(f64)
            ys = np.arange(h, dtype=f64)[:, None]
            x0 = inv[0] * xb + inv[1] * ys + inv[2]
            y0 = inv[3] * xb + inv[4] * ys + inv[5]
            w0 = inv[6] * xb + inv[7] * ys + inv[8]
            wt = w0 + inv[6] * x1
            wt = np.where(wt != 0, 1.0 / wt, 0.0)
            lim = (-(2.0**31), 2.0**31 - 1)
            fx = np.nan_to_num(np.clip((x0 + inv[0] * x1) * wt, *lim))
            fy = np.nan_to_num(np.clip((y0 + inv[3] * x1) * wt, *lim))
            out = _gather_nearest(src, np.rint(fx).astype(np.int64), np.rint(fy).astype(np.int64))
        else:
            mf = inv.astype(f32)
            xs = np.arange(w, dtype=f32)[None, :]
            ys = np.arange(h, dtype=f32)[:, None]
            den = fma32(mf[6], xs, mf[7] * ys + mf[8])
            sx = fma32(mf[0], xs, mf[1] * ys + mf[2]) / den
            sy = fma32(mf[3], xs, mf[4] * ys + mf[5]) / den
            out = _bilinear_u8(src, sx, sy)
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

_BINOMIAL = {3: (np.array([1, 2, 1]), 2), 5: (np.array([1, 4, 6, 4, 1]), 4)}  # taps, log2 of their sum


def gaussian_blur_u8(image: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.GaussianBlur(image, (ksize, ksize), 0)`` for uint8 and ksize 3
    or 5: the binomial kernel, exact, rounded half up."""
    taps, bits = _BINOMIAL[ksize]
    r = ksize // 2
    h, w = image.shape[:2]
    a = _pad101(image.astype(np.int32), r, r)
    rows = sum(int(t) * a[:, i : i + w] for i, t in enumerate(taps))
    s = sum(int(t) * rows[i : i + h] for i, t in enumerate(taps))
    return ((s + (1 << (2 * bits - 1))) >> (2 * bits)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_32F)`` with the ksize a
    float32 image gets from sigma."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) / 2
    t = np.exp(-x * x / (2 * sigma * sigma))
    return (t / t.sum()).astype(f32)


def gaussian_blur_f32(image: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(image, (0, 0), sigma)`` for float32 ``[H, W]`` or
    ``[H, W, C]``."""
    k = gaussian_kernel(float(sigma))
    r = len(k) // 2
    h, w = image.shape[:2]
    flat = image.astype(f32).reshape(h, -1)  # channels interleaved, as the filter walks them
    n = flat.shape[1]
    cn = n // w
    a = flat.reshape(h, w, cn)[:, reflect101(w, r, r)].reshape(h, -1)
    parts = []
    for lo, hi, fused in ((0, n // 8 * 8, True), (n // 8 * 8, n, False)):  # 8-wide vector loops, then the tail
        if lo == hi:
            continue
        rows = a[:, lo:hi] * k[0]
        for i in range(1, 2 * r + 1):
            tap = a[:, i * cn + lo : i * cn + hi]
            rows = fma32(k[i], tap, rows) if fused else rows + k[i] * tap
        rows = rows[reflect101(h, r, r)]
        out = k[r] * rows[r : r + h]
        for i in range(1, r + 1):
            pair = rows[r - i : r - i + h] + rows[r + i : r + i + h]
            out = fma32(k[r + i], pair, out) if fused else out + k[r + i] * pair
        parts.append(out)
    return np.concatenate(parts, 1).reshape(image.shape)


def box_blur3_f32(image: np.ndarray) -> np.ndarray:
    """``cv2.blur(image, (3, 3))`` for float32: 3x3 sums in float64 times 1/9."""
    h, w = image.shape[:2]
    a = _pad101(image.astype(f64), 1, 1)
    rows = a[:, 0:w] + a[:, 1 : w + 1] + a[:, 2 : w + 2]
    return ((rows[0:h] + rows[1 : h + 1] + rows[2 : h + 2]) * (1.0 / 9)).astype(f32)


def filter2d_u8(image: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(image, -1, kernel)`` for uint8 and a small float32
    kernel (anchor at its centre): the nonzero taps summed in float32 in
    row-major order, rounded half to even."""
    kernel = np.asarray(kernel, f32)
    kh, kw = kernel.shape
    h, w = image.shape[:2]
    a = _pad101(image.astype(f32), kh // 2, kw // 2)
    s = np.zeros(image.shape, f32)
    for i, j in zip(*np.nonzero(kernel)):
        s = s + kernel[i, j] * a[i : i + h, j : j + w]
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def _linear_coeffs(src: int, dst: int):
    fx = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(f32)
    low, high = sx < 0, sx >= src - 1
    fx[low | high] = 0
    sx[low] = 0
    sx[high] = src - 1
    return sx, np.minimum(sx + 1, src - 1), fx


def resize_linear_f32(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h))`` (INTER_LINEAR) of a float32
    ``[H, W]`` image."""
    h, w = image.shape
    x0, x1, ax = _linear_coeffs(w, out_w)
    y0, y1, ay = _linear_coeffs(h, out_h)
    rows = fma32(ax, image[:, x1] - image[:, x0], image[:, x0])
    return fma32(ay[:, None], rows[y1] - rows[y0], rows[y0])


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])  # b, g, r of each hue sector


def _unit(c: np.ndarray) -> np.ndarray:
    return c.astype(f32) * f32(1 / 255.0)


def _pick_sectors(tab: np.ndarray, sector: np.ndarray) -> np.ndarray:
    """RGB from the 4-entry table of each pixel's hue sector."""
    idx = _SECTORS[sector][..., ::-1]  # r, g, b
    return np.take_along_axis(tab, idx, -1)


@functools.lru_cache(maxsize=None)
def _hsv_tables():
    i = np.arange(256)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i == 0, 0, np.rint((255 << 12) / np.maximum(i, 1)))
        hdiv = np.where(i == 0, 0, np.rint((180 << 12) / (6.0 * np.maximum(i, 1))))
    return sdiv.astype(np.int64), hdiv.astype(np.int64)


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2HSV)`` for uint8 (H in 0..179)."""
    sdiv, hdiv = _hsv_tables()
    r, g, b = (image[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_HSV2RGB)`` for uint8."""
    one = f32(1)
    s, v = _unit(image[..., 1]), _unit(image[..., 2])
    hs = image[..., 0].astype(f32) * f32(6 / 180.0)
    sector = np.trunc(hs).astype(np.int64)
    fr = hs - sector.astype(f32)
    tab = np.stack([v, v * (one - s), v * fma32(-s, fr, one), v * fma32(-s, one - fr, one)], -1)
    rgb = _pick_sectors(tab, sector % 6) * f32(255)
    w = image.shape[1]
    vec = (np.arange(w) < w // 32 * 32)[:, None]  # 32-pixel vector blocks truncate, a row's scalar tail rounds
    return np.clip(np.where(vec, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


def rgb_to_hls(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2HLS)`` for uint8 (H in 0..179)."""
    r, g, b = (_unit(image[..., i]) for i in range(3))
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = vmax - vmin
    total = vmax + vmin
    light = total * f32(0.5)
    chroma = diff > np.finfo(f32).eps
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(light < f32(0.5), diff / total, diff / (f32(2) - total))
        d60 = f32(60) / diff
        hr = (g - b) * d60
        hr = np.where(hr < 0, fma32(g - b, d60, f32(360)), hr)
        h = np.where(vmax == r, hr, np.where(vmax == g, fma32(b - r, d60, f32(120)), fma32(r - g, d60, f32(240))))
    h = np.where(chroma, h, f32(0)) * f32(0.5)
    s = np.where(chroma, s, f32(0))
    hls = np.stack([h, light * f32(255), s * f32(255)], -1)
    return np.clip(np.rint(hls), 0, 255).astype(np.uint8)


def hls_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_HLS2RGB)`` for uint8."""
    one = f32(1)
    light, s = _unit(image[..., 1]), _unit(image[..., 2])
    p2 = np.where(light <= f32(0.5), light * (one + s), light + s - light * s)
    p1 = f32(2) * light - p2
    hs = image[..., 0].astype(f32) * f32(6 / 180.0)
    sector = np.trunc(hs).astype(np.int64)
    fr = hs - sector.astype(f32)
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (one - fr), p1 + (p2 - p1) * fr], -1)
    rgb = np.where((image[..., 2] == 0)[..., None], light[..., None], _pick_sectors(tab, sector % 6)) * f32(255)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


# color_lab.cpp: sRGB D65, lab_shift = 12, gamma_shift = 3, BASE = 1 << 14
_D65 = np.array([0.950456, 1.0, 1.088754])
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169], [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556], [0.055648, -0.204043, 1.057311]])
_BASE = 1 << 14
_MIN_AB = -8145


def _cdiv(a, b):
    """C's integer division (toward zero)."""
    return np.sign(a) * (np.abs(a) // b)


@functools.lru_cache(maxsize=None)
def _lab_tables():
    """OpenCV's integer Lab tables, built in its float32/float64 steps."""
    i = np.arange(256, dtype=f64)
    x = (i.astype(f32) / f32(255)).astype(f64)
    lin = np.where(x <= 809 / 20000, x / (323 / 25), ((x + 11 / 200) / (1 + 11 / 200)) ** (12 / 5)).astype(f32)
    gamma = np.rint((f32(255) * f32(8)) * lin).astype(np.int64)  # sRGBGammaTab_b
    x = np.arange(256 * 3 // 2 * 8) / (255.0 * 8)
    cbrt = np.where(x < 216 / 24389, x * (841 / 108) + 16 / 116, np.cbrt(x).astype(f32))
    cbrt = np.rint((1 << 15) * cbrt).astype(np.int64)  # LabCbrtTab_b
    to_xyz = np.rint((1 << 12) * _RGB2XYZ / _D65[:, None]).astype(np.int64)
    x = ((f32(1) / f32(4096)) * np.arange(4096).astype(f32)).astype(f64)
    inv = np.where(x <= 7827 / 2500000, x * (323 / 25), x ** (1 / (12 / 5)) * (1 + 11 / 200) - 11 / 200).astype(f32)
    inv_gamma = np.rint(f32(255) * inv).astype(np.int64)  # sRGBInvGammaTab_b
    y_tab = np.zeros(256, np.int64)
    fy_tab = np.zeros(256, np.int64)
    for li in range(256):
        if li <= 20:
            y_tab[li] = np.rint(f32(li * _BASE * 20 * 9) / f32(17 * 29**3))
            fy_tab[li] = np.rint(f32(_BASE) * (f32(16) / f32(116) + f32(li * 5) / f32(3 * 17 * 29)))
        else:
            fy = f32(li * 100 * _BASE) / f32(255 * 116) + f32(16 * _BASE) / f32(116)
            fy_tab[li] = np.rint(fy)
            y_tab[li] = np.rint(fy * fy * fy / f32(_BASE * _BASE))
    v = np.arange(_MIN_AB, 27000, dtype=np.int64)
    ab_xz = np.where(v <= 3390, _cdiv(v * 108, 841) - (_BASE * 16 // 116) * 108 // 841, _cdiv(_cdiv(v * v, _BASE) * v, _BASE))
    to_rgb = np.rint((1 << 12) * _XYZ2RGB * _D65[None, :]).astype(np.int64)
    return gamma, cbrt, to_xyz, inv_gamma, y_tab, fy_tab, ab_xz, to_rgb


def rgb_to_lab(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_RGB2LAB)`` for uint8."""
    gamma, cbrt, c, _, _, _, _, _ = _lab_tables()
    rgb = gamma[image[..., :3].astype(np.int64)]
    fx, fy, fz = (cbrt[(rgb @ c[k] + (1 << 11)) >> 12] for k in range(3))
    l = (((116 * 255 + 50) // 100) * fy - (16 * 255 * (1 << 15) + 50) // 100 + (1 << 14)) >> 15
    a = (500 * (fx - fy) + 128 * (1 << 15) + (1 << 14)) >> 15
    b = (200 * (fy - fz) + 128 * (1 << 15) + (1 << 14)) >> 15
    return np.clip(np.stack([l, a, b], -1), 0, 255).astype(np.uint8)


def lab_to_rgb(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_LAB2RGB)`` for uint8."""
    _, _, _, inv_gamma, y_tab, fy_tab, ab_xz, c = _lab_tables()
    l, a, b = (image[..., i].astype(np.int64) for i in range(3))
    y, ify = y_tab[l], fy_tab[l]
    adiv = ((a * 268435 + (1 << 7)) >> 13) - 128 * _BASE // 500  # the vector path's a * BASE / 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1  # and its b * BASE / 200
    xyz = np.stack([ab_xz[ify + adiv - _MIN_AB], y, ab_xz[ify - bdiv - _MIN_AB]], -1)
    rgb = (xyz @ c.T + (1 << 13)) >> 14
    return inv_gamma[rgb.clip(0, 4095)].astype(np.uint8)


# ---------------------------------------------------------------------------
# CLAHE and lines
# ---------------------------------------------------------------------------


def clahe(image: np.ndarray, clip_limit: float = 2.0, tiles=(8, 8)) -> np.ndarray:
    """``cv2.createCLAHE(clip_limit, tiles).apply(image)`` for uint8 ``[H, W]``
    and ``clip_limit > 0``."""
    h, w = image.shape
    gx, gy = tiles
    src = image
    if w % gx or h % gy:  # cv2 pads both sides, by a whole tile where one divides
        src = image[reflect101(h, 0, gy - h % gy)][:, reflect101(w, 0, gx - w % gx)]
    th, tw = src.shape[0] // gy, src.shape[1] // gx
    area = th * tw
    limit = max(int(clip_limit * area / 256), 1)
    cells = src.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(gy * gx, area).astype(np.int64)
    hist = np.bincount((cells + 256 * np.arange(gy * gx)[:, None]).ravel(), minlength=256 * gy * gx)
    hist = hist.reshape(gy * gx, 256)
    excess = np.maximum(hist - limit, 0).sum(1)
    hist = np.minimum(hist, limit) + (excess // 256)[:, None]
    for t, residual in enumerate(excess % 256):
        if residual:  # one more to every step-th bin from 0, residual of them
            hist[t, np.arange(0, 256, max(256 // int(residual), 1))[: int(residual)]] += 1
    lut = np.clip(np.rint(np.cumsum(hist, 1).astype(f32) * (f32(255) / f32(area))), 0, 255).reshape(gy, gx, 256)

    def axis(n, tile, count):
        t = np.arange(n).astype(f32) * (f32(1) / f32(tile)) - f32(0.5)
        t1 = np.floor(t).astype(np.int64)
        frac = t - t1.astype(f32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, count - 1), frac, f32(1) - frac

    x1, x2, xa, xa1 = axis(w, tw, gx)
    y1, y2, ya, ya1 = axis(h, th, gy)
    v = image.astype(np.int64)
    y1, y2 = y1[:, None], y2[:, None]
    res = (lut[y1, x1, v] * xa1 + lut[y1, x2, v] * xa) * ya1[:, None] + (lut[y2, x1, v] * xa1 + lut[y2, x2, v] * xa) * ya[:, None]
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


def draw_lines(canvas: np.ndarray, p0: np.ndarray, p1: np.ndarray, color) -> np.ndarray:
    """``cv2.line(canvas, p0[i], p1[i], color, 1)`` (LINE_8) for every ``i``,
    in place: each segment clipped to the canvas, then walked left to right
    with OpenCV's Bresenham error term, all segments a step at a time."""
    h, w = canvas.shape[:2]
    p0 = np.array(p0, np.int64).reshape(-1, 2)
    p1 = np.array(p1, np.int64).reshape(-1, 2)
    keep = np.ones(len(p0), bool)
    inside = ((p0 >= 0) & (p0 < [w, h]) & (p1 >= 0) & (p1 < [w, h])).all(1)
    for i in np.nonzero(~inside)[0]:  # few: only segments that leave the canvas
        keep[i], p0[i], p1[i] = _clip_line(w, h, tuple(p0[i]), tuple(p1[i]))
    p0, p1 = p0[keep], p1[keep]
    if not len(p0):
        return canvas
    swap = (p1[:, 0] < p0[:, 0])[:, None]
    a, b = np.where(swap, p1, p0), np.where(swap, p0, p1)
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    steep = dy > dx
    major, minor = np.where(steep, dy, dx), np.where(steep, dx, dy)
    err = major - 2 * minor
    x, y = a[:, 0], a[:, 1]
    xs, ys = [], []
    for i in range(int(major.max()) + 1):
        live = i <= major
        xs.append(x[live])
        ys.append(y[live])
        diag = err < 0
        err = np.where(diag, err + 2 * major - 2 * minor, err - 2 * minor)
        x = x + (diag | ~steep)
        y = y + np.where(diag | steep, sy, 0)
    canvas[np.concatenate(ys), np.concatenate(xs)] = color
    return canvas
