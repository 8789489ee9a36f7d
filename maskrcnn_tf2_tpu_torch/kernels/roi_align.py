"""Pyramid ROIAlign, forward and backward: the CUDA kernels and their plain
versions.

``roi_align`` launches ``csrc/roi_align.cu``'s forward kernel for CUDA
tensors (one launch for the batch; a block pools a range of bin rows of one
ROI, threads over 16-byte channel vectors where ``vector_width`` allows them)
and runs ``roi_align_plain`` for CPU tensors. Each ROI is pooled from the FPN
level the reference's formula assigns it, with ``crop_and_resize`` bilinear
samples whose grid endpoints sit on the box corners scaled by ``(H_l - 1,
W_l - 1)``; corners clamp to the map and zero-area boxes pool zeros
(``maskrcnn_tf2_tpu/ops/roi_align.py``). The output is ``[B, N, P, P, C]`` in
ROI order, in the features' dtype; both versions sum the four weighted
corners in float32 and round once.

``roi_align_backward`` is its transpose: each sample's pooled cotangent,
times the same four weights, is added to the sample's four corner pixels in
maps ``[B, H_l, W_l, C]``; sums in float32, one rounding to the cotangent's
dtype. The CUDA kernel gathers (owner computes): a block owns a tile of one
level's map, a warp a pixel, a lane a channel vector, and each output value is
summed in a register in the fixed order ROI, sample row, sample column,
corner, and written once: no float32 scratch, no atomics, the same bits from
run to run. ``roi_align_backward_plain`` scatters with ``index_add_``, which
on the CPU adds in that same order.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.kernels import _build

MAX_LEVELS = 4
MAX_POOL = 64  # kMaxPool in csrc/roi_align.cu: the block's geometry arrays
BACKWARD_TILE = (4, 4)  # kTileH, kTileW in csrc/roi_align.cu: the pixels a backward block owns
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def vector_width(features: Sequence[torch.Tensor], out: torch.Tensor) -> int:
    """Channels per thread of the kernels: a 16-byte vector (8 bf16 or 4
    float32) where the channel count (``out``'s last dimension) and the
    pointers of ``features`` and ``out`` are 16-byte multiples, else 1, the
    scalar width."""
    item = out.element_size()
    ok = (out.shape[-1] * item) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (*features, out))
    return 16 // item if ok else 1


def roi_level_assignment(
    boxes: torch.Tensor,
    image_area: float,
    num_levels: int = 4,
    denominator: float = 244.0,
) -> torch.Tensor:
    """0-based FPN level per ROI: ``4 + round(log2(sqrt(h*w) /
    (denominator / sqrt(image_area))))`` clipped to [2, 1 + num_levels],
    rounding half to even; zero-area boxes map to 0."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    scale = torch.sqrt(torch.clamp(h * w, min=1e-12))
    # tensor / tensor: Python-scalar / tensor would round twice (reciprocal, then multiply)
    image_scale = boxes.new_tensor(denominator) / torch.sqrt(boxes.new_tensor(image_area))
    lvl = torch.round(torch.log2(scale / image_scale)).to(torch.int32) + 4
    lvl = torch.clamp(lvl, 2, 2 + num_levels - 1) - 2
    valid = (h > 0) & (w > 0)
    return torch.where(valid, lvl, torch.zeros_like(lvl))


def check_pool_size(pool_size: int) -> None:
    """The kernels keep a ROI's ``pool_size`` row and column corners in shared
    arrays of ``MAX_POOL`` entries."""
    if not 1 <= pool_size <= MAX_POOL:
        raise ValueError(f"the ROIAlign kernels take pool_size / mask_pool_size in [1, {MAX_POOL}], "
                         f"got {pool_size}")


def _check_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels, got {len(features)}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError("boxes must be float32 [B, N, 4]")
    b, c = boxes.shape[0], features[0].shape[-1]
    dtype = features[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"features must be [B={b}, H, W, C={c}], got {tuple(f.shape)}")
        if f.dtype != dtype or f.device != boxes.device:
            raise ValueError("features and boxes must share dtype (features) and device")


def _geometry(level_hw: Sequence[Tuple[int, int]], boxes: torch.Tensor, p: int,
              image_shape: Sequence[int], denominator: float):
    """Flat-pyramid indices ``[B, N, P, P, 4]`` of every sample's four corners,
    their bilinear weights (float32, same shape) and the non-zero-area mask
    ``[B, N]`` (the form of ``pyramid_roi_align_gather``)."""
    dev = boxes.device
    sizes = [h * w for h, w in level_hw]
    offsets = torch.tensor(np.cumsum([0] + sizes[:-1]), device=dev)
    heights = torch.tensor([h for h, _ in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)

    image_area = float(image_shape[0]) * float(image_shape[1])
    levels = roi_level_assignment(boxes, image_area, len(level_hw), denominator).long()
    lvl_h, lvl_w, lvl_off = heights[levels], widths[levels], offsets[levels]  # [B, N]

    y1, x1, y2, x2 = (boxes[..., i] for i in range(4))
    hm1 = (lvl_h - 1).to(torch.float32)[..., None]
    wm1 = (lvl_w - 1).to(torch.float32)[..., None]
    if p > 1:
        # IEEE division on the host: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, one rounding off the kernel's
        frac = torch.from_numpy(np.arange(p, dtype=np.float32) / np.float32(p - 1)).to(dev)
        ys = (y1[..., None] + (y2 - y1)[..., None] * frac) * hm1  # [B, N, P]
        xs = (x1[..., None] + (x2 - x1)[..., None] * frac) * wm1
    else:
        ys = (0.5 * (y1 + y2))[..., None] * hm1
        xs = (0.5 * (x1 + x2))[..., None] * wm1

    def corners(coord, size_m1):
        c0 = torch.minimum(torch.clamp(torch.floor(coord), min=0.0), size_m1)
        c1 = torch.minimum(torch.clamp(c0 + 1, min=0.0), size_m1)
        t = torch.clamp(coord - c0, 0.0, 1.0)
        return c0.long(), c1.long(), t

    y0, y1i, ty = corners(ys, hm1)
    x0, x1i, tx = corners(xs, wm1)

    off = lvl_off[..., None, None]
    wl = lvl_w[..., None, None]
    yy0, yy1 = y0[..., :, None] * wl, y1i[..., :, None] * wl  # [B, N, P, 1]
    xx0, xx1 = x0[..., None, :], x1i[..., None, :]  # [B, N, 1, P]
    idx = torch.stack(
        [off + yy0 + xx0, off + yy0 + xx1, off + yy1 + xx0, off + yy1 + xx1], dim=-1
    )  # [B, N, P, P, 4]
    wy1, wx1 = ty[..., :, None], tx[..., None, :]
    weights = torch.stack(
        [(1.0 - wy1) * (1.0 - wx1), (1.0 - wy1) * wx1, wy1 * (1.0 - wx1), wy1 * wx1],
        dim=-1,
    )  # [B, N, P, P, 4]
    box_valid = (y2 > y1) & (x2 > x1)
    return idx, weights, box_valid


def roi_align_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    pool_size: int,
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> torch.Tensor:
    """Plain PyTorch version of ``roi_align``: one gather of the four corners
    of every sample from the flattened pyramid, then the weighted sum (the
    form of ``maskrcnn_tf2_tpu/ops/roi_align.py::pyramid_roi_align_gather``)."""
    _check_inputs(features, boxes)
    b, n, _ = boxes.shape
    p = pool_size
    c = features[0].shape[-1]
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    idx, weights, box_valid = _geometry(
        [(f.shape[1], f.shape[2]) for f in features], boxes, p, image_shape, denominator)
    gathered = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    gathered = gathered.reshape(b, n, p, p, 4, c).to(torch.float32)
    out = (gathered * weights[..., None]).sum(dim=-2)
    out = out * box_valid[..., None, None, None].to(out.dtype)
    return out.to(features[0].dtype)


def roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    pool_size: int,
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> torch.Tensor:
    """Pool ``boxes [B, N, 4]`` (normalized, float32) from the level maps
    ``features`` (``[B, H_l, W_l, C]``, finest first) into ``[B, N, P, P, C]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    needs contiguous channels-last maps.
    """
    _check_inputs(features, boxes)
    if boxes.device.type == "cpu":
        return roi_align_plain(features, boxes, pool_size, image_shape, denominator)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align runs on cpu or cuda, not {boxes.device}")
    if not (boxes.is_contiguous() and all(f.is_contiguous() for f in features)):
        raise ValueError("roi_align needs contiguous boxes and [B, H, W, C] maps")
    if boxes.data_ptr() % 16:
        raise ValueError("roi_align reads boxes as float4: they must be 16-byte aligned")
    check_pool_size(pool_size)
    b, n, _ = boxes.shape
    c = features[0].shape[-1]
    out = torch.empty((b, n, pool_size, pool_size, c), dtype=features[0].dtype, device=boxes.device)
    if out.numel() == 0:
        return out
    levels = list(features) + [None] * (MAX_LEVELS - len(features))
    ptrs = [f.data_ptr() if f is not None else None for f in levels]
    hs = [f.shape[1] if f is not None else 0 for f in levels]
    ws = [f.shape[2] if f is not None else 0 for f in levels]
    image_area = np.float32(float(image_shape[0]) * float(image_shape[1]))
    image_scale = np.float32(denominator) / np.sqrt(image_area)
    lib = _build.load("roi_align", _SIGNATURES)
    with torch.cuda.device(boxes.device):  # the launch goes to the current device
        status = lib.roi_align_launch(
            *ptrs, *hs, *ws, len(features),
            boxes.data_ptr(), b, n, c, pool_size, float(image_scale),
            _DTYPE_CODES[features[0].dtype], int(vector_width(features, out) > 1), out.data_ptr(),
            torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    _build.check(lib, status, "roi_align")
    roi_align.launches += 1
    return out


roi_align.launches = 0


def _check_backward_inputs(dout: torch.Tensor, boxes: torch.Tensor, level_hw) -> None:
    if not 1 <= len(level_hw) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} pyramid levels, got {len(level_hw)}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError("boxes must be float32 [B, N, 4]")
    if dout.dim() != 5 or dout.shape[:2] != boxes.shape[:2] or dout.shape[2] != dout.shape[3]:
        raise ValueError(f"dout must be [B, N, P, P, C] over boxes {tuple(boxes.shape)}, got {tuple(dout.shape)}")
    if dout.dtype not in _DTYPE_CODES:
        raise TypeError(f"dout must be float32 or bfloat16, got {dout.dtype}")
    if dout.device != boxes.device:
        raise ValueError("dout and boxes must share a device")


def _split_levels(flat: torch.Tensor, b: int, level_hw, c: int) -> List[torch.Tensor]:
    """Views ``[B, H_l, W_l, C]`` of maps stored back to back in ``flat``."""
    out, off = [], 0
    for h, w in level_hw:
        out.append(flat[off : off + b * h * w * c].view(b, h, w, c))
        off += b * h * w * c
    return out


def roi_align_backward_plain(
    dout: torch.Tensor,
    boxes: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> List[torch.Tensor]:
    """Plain PyTorch version of ``roi_align_backward``: the forward's corner
    indices and weights, one ``index_add_`` into float32 maps, one cast."""
    _check_backward_inputs(dout, boxes, level_hw)
    b, n, p, _, c = dout.shape
    idx, weights, box_valid = _geometry(level_hw, boxes, p, image_shape, denominator)
    contrib = dout.to(torch.float32)[..., None, :] * weights[..., None]  # [B, N, P, P, 4, C]
    contrib = torch.where(box_valid[..., None, None, None, None], contrib, 0.0)
    total = sum(h * w for h, w in level_hw)
    rows = idx + (torch.arange(b, device=idx.device) * total)[:, None, None, None, None]
    acc = torch.zeros((b * total, c), dtype=torch.float32, device=dout.device)
    acc.index_add_(0, rows.reshape(-1), contrib.reshape(-1, c))
    acc = acc.view(b, total, c)
    out, off = [], 0
    for h, w in level_hw:
        out.append(acc[:, off : off + h * w].reshape(b, h, w, c).to(dout.dtype))
        off += h * w
    return out


def roi_align_backward(
    dout: torch.Tensor,
    boxes: torch.Tensor,
    level_hw: Sequence[Tuple[int, int]],
    image_shape: Sequence[int],
    denominator: float = 244.0,
) -> List[torch.Tensor]:
    """Gradient of ``roi_align`` with respect to its maps: ``dout [B, N, P,
    P, C]`` -> one ``[B, H_l, W_l, C]`` map per entry of ``level_hw``, in
    ``dout``'s dtype. The boxes get no gradient.

    CPU tensors take the plain version; CUDA tensors launch the
    owner-computes kernel, one launch for all levels, whatever the shape: it
    writes every element of the maps (zeros where no ROI reaches), so they
    come from ``torch.empty`` and there is no scratch.
    """
    _check_backward_inputs(dout, boxes, level_hw)
    if boxes.device.type == "cpu":
        return roi_align_backward_plain(dout, boxes, level_hw, image_shape, denominator)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align_backward runs on cpu or cuda, not {boxes.device}")
    if not (boxes.is_contiguous() and dout.is_contiguous()):
        raise ValueError("roi_align_backward needs contiguous boxes and dout")
    if boxes.data_ptr() % 16:
        raise ValueError("roi_align_backward reads boxes as float4: they must be 16-byte aligned")
    b, n, p, _, c = dout.shape
    check_pool_size(p)
    out = torch.empty(b * c * sum(h * w for h, w in level_hw), dtype=dout.dtype, device=boxes.device)
    if out.numel() == 0:
        return _split_levels(out, b, level_hw, c)
    hw = list(level_hw) + [(0, 0)] * (MAX_LEVELS - len(level_hw))
    image_area = np.float32(float(image_shape[0]) * float(image_shape[1]))
    image_scale = np.float32(denominator) / np.sqrt(image_area)
    lib = _build.load("roi_align", _SIGNATURES)
    with torch.cuda.device(boxes.device):  # the launch goes to the current device
        status = lib.roi_align_backward_launch(
            out.data_ptr(), *(h for h, _ in hw), *(w for _, w in hw), len(level_hw),
            boxes.data_ptr(), b, n, c, p, float(image_scale), _DTYPE_CODES[dout.dtype],
            int(vector_width([out], dout) > 1), dout.data_ptr(),
            torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    _build.check(lib, status, "roi_align_backward")
    roi_align_backward.launches += 1
    return _split_levels(out, b, level_hw, c)


roi_align_backward.launches = 0

_SIGNATURES = {
    "roi_align_launch": (
        [ctypes.c_void_p] * MAX_LEVELS
        + [ctypes.c_int] * (2 * MAX_LEVELS + 1)
        + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "roi_align_backward_launch": (
        [ctypes.c_void_p]
        + [ctypes.c_int] * (2 * MAX_LEVELS + 1)
        + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
