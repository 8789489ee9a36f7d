"""Int8 convolution with its dequantize epilogue: the CUDA kernels, their plan and their plain version.

``int8_conv`` (the op ``maskrcnn_tf2_tpu_torch::int8_conv``) launches
``csrc/int8_conv.cu`` for CUDA tensors and runs ``int8_conv_plain`` for CPU
tensors. Both compute what the JAX package's
``models/quant.py::Int8Conv`` leaves to XLA: an s8 x s8 convolution with flax's
"SAME" pads and an int32 sum, then ``acc.float() * (sx * sw) + bias``, cast to
the output dtype, each step rounded once. Tensors are channels-last:
``x [N, H, W, C]`` int8, ``w [O, kh, kw, C / groups]`` int8, the output
``[N, ceil(H / stride), ceil(W / stride), O]``. The dense layers are the same
function over a 1x1 image: ``x [M, 1, 1, K]``, ``w [F, 1, 1, K]``.

``plan`` chooses the kernel, the tile, the copy width and the split of K
from the shapes and the pointers' alignment alone; the launcher takes the
plan and checks it. One group runs the tensor-core implicit GEMM (wgmma)
over 64-byte steps of K: 128 x 128 output tiles where there are enough of
them, else 64 x 64 tiles, and K split into ranges where the tiles fall short
of one wave of the card's SMs; several groups run the grouped kernel (8 x 8
output pixels by 64 channels a block, from a patch in shared memory).

The plain version sums in float64 (``F.conv2d`` over the padded int8 values,
then rounded to int32): every product and partial sum is an integer below
2^53, so the sum is exact in any order and equals the int32 one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.models.layers import same_pad_amounts

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# |acc| <= K * 127^2 must fit int32
MAX_K = (2**31 - 1) // (127 * 127)

# the kernels' constants (csrc/int8_conv.cu)
TILES = (128, 64)  # the tensor-core blocks' output tiles: pixels = channels
STEP_K = 64  # bytes of K a pipeline stage
GROUPED_TILE = 8  # output pixels a grouped block's side
GROUPED_CHANNELS = 64  # output channels a grouped block
SMS = 132  # streaming multiprocessors of an H100 SXM
# a K range of a split is at least this many stages, by tile: a 128-pixel
# block's fixed costs are larger (measured on the flagship's sites with
# tune_int8_conv.py --variants)
MIN_STEPS_PER_SPLIT = {128: 16, 64: 4}
MAX_SPLIT = 16
_KERNEL_CODES = {"tensor-core": 0, "grouped depthwise": 1, "grouped dp4a words": 2, "grouped bytes": 3}


class Plan(NamedTuple):
    """How one call runs: the kernel (``tensor-core``, ``grouped depthwise``,
    ``grouped dp4a words`` or ``grouped bytes``), the bytes of a copy of x
    (and of w on the tensor-core path), the launch grid, and on the
    tensor-core path the output tile's side, the 64-byte steps of K and
    their split into ``split`` ranges of ``steps_per_split``."""

    kernel: str
    vec: int
    grid: Tuple[int, int, int]
    tile: int = 0
    k_steps: int = 0
    split: int = 1
    steps_per_split: int = 0

    def k_ranges(self) -> List[Tuple[int, int]]:
        """The K ranges ``[k0, k1)`` in bytes of ``kh * kw * C`` (order ky,
        kx, c), one a split, the last clipped to the 64-byte steps."""
        per = self.steps_per_split
        return [(s * per * STEP_K, min((s + 1) * per, self.k_steps) * STEP_K) for s in range(self.split)]

    def workspace_elements(self) -> int:
        """int32 partial sums the split needs: an output tile a K range."""
        return 0 if self.split == 1 else self.split * self.grid[0] * self.grid[1] * self.tile * self.tile


def _widest(sizes, *multiples_of) -> int:
    return next(v for v in sizes if all(m % v == 0 for m in multiples_of))


def _tile(m: int, o: int, sms: int) -> int:
    """128 x 128 output tiles where there are more than 64 channels and at
    least half a wave of ``sms`` such tiles, else 64 x 64."""
    if o > 64 and -(-m // 128) * -(-o // 128) >= sms // 2:
        return 128
    return 64


def _split(tiles: int, k_steps: int, tile: int, sms: int) -> int:
    """Split K where the output tiles fill less than one wave of ``sms``
    SMs, towards two blocks an SM, each range at least
    ``MIN_STEPS_PER_SPLIT[tile]`` steps."""
    if tiles >= sms:
        return 1
    return max(1, min(round(2 * sms / tiles), k_steps // MIN_STEPS_PER_SPLIT[tile], MAX_SPLIT))


@functools.lru_cache(maxsize=4096)
def plan(n: int, h: int, w: int, c: int, o: int, kh: int, kw: int, stride: int = 1, groups: int = 1,
         x_align: int = 16, w_align: int = 16, sms: int = SMS, tile: int = 0, split: int = 0) -> Plan:
    """The plan of ``int8_conv`` for ``x [n, h, w, c]`` by ``w [o, kh, kw,
    c / groups]``; ``x_align`` and ``w_align`` are the largest powers of 2
    (up to 16) that divide the two pointers. On the tensor-core path the
    tile ``_tile`` picks, then K split as ``_split`` says; ``tile`` and
    ``split``, where not 0, are taken as given (for measuring the
    alternatives)."""
    ho, wo = -(-h // stride), -(-w // stride)
    if groups == 1:
        vec = _widest((16, 8, 4, 1), c, x_align, w_align)
        k_steps = -(-kh * kw * c // STEP_K)
        tile = tile or _tile(n * ho * wo, o, sms)
        grid_m, grid_n = -(-n * ho * wo // tile), -(-o // tile)
        per = -(-k_steps // (split or _split(grid_m * grid_n, k_steps, tile, sms)))
        split = -(-k_steps // per)  # no empty range
        return Plan("tensor-core", vec, (grid_m, grid_n, split), tile, k_steps, split, per)
    cg, og = c // groups, o // groups
    if cg == 1 and og == 1:
        kernel = "grouped depthwise"
    elif cg % 4 == 0 and og % 4 == 0:
        kernel = "grouped dp4a words"
    else:
        kernel = "grouped bytes"
    # each block reads the whole groups of its 64 output channels
    bounds = []
    for o0 in range(0, o, GROUPED_CHANNELS):
        bounds += [(o0 // og) * cg, ((min(o0 + GROUPED_CHANNELS, o) - 1) // og + 1) * cg]
    vec = _widest((16, 4, 1), c, x_align, *bounds)
    grid = (-(-ho // GROUPED_TILE) * -(-wo // GROUPED_TILE), n, -(-o // GROUPED_CHANNELS))
    return Plan(kernel, vec, grid)


def _alignment(t: torch.Tensor) -> int:
    ptr = t.data_ptr()
    return next(v for v in (16, 8, 4, 2, 1) if ptr % v == 0)


# the split's tile counters, zero between launches (the last block of a tile
# resets its counter), one buffer a device and stream
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check_inputs(x, w, sx, sw, bias, stride: int, groups: int, out_dtype) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C] and w [O, kh, kw, C / groups], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    n, h, wd, c = x.shape
    o, kh, kw, cg = w.shape
    if groups < 1 or c % groups or o % groups or cg * groups != c:
        raise ValueError(f"{c} input and {o} output channels do not split into {groups} groups of "
                         f"{cg} input channels")
    if stride < 1 or h < 1 or wd < 1:
        raise ValueError(f"stride {stride} over a {h}x{wd} input")
    if kh * kw * cg > MAX_K:
        raise ValueError(f"a sum over {kh * kw * cg} int8 products can overflow int32 (at most {MAX_K})")
    if sx.numel() != 1 or sx.dtype != torch.float32:
        raise ValueError("sx must be one float32 value")
    if sw.shape != (o,) or sw.dtype != torch.float32:
        raise ValueError(f"sw must be float32 [{o}]")
    if bias is not None and (bias.shape != (o,) or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 [{o}] or None")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the output is float32 or bfloat16, not {out_dtype}")
    tensors = [x, w, sx, sw] + ([] if bias is None else [bias])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, sx, sw and bias must be on one device")


def int8_conv_accumulate_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """The int32 sums ``[N, Ho, Wo, O]`` of the s8 convolution, through float64."""
    _, h, wd, _ = x.shape
    _, kh, kw, _ = w.shape
    top, bottom = same_pad_amounts(h, kh, stride)
    left, right = same_pad_amounts(wd, kw, stride)
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float64), (left, right, top, bottom))
    acc = F.conv2d(xp, w.permute(0, 3, 1, 2).to(torch.float64), stride=stride, groups=groups)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def dequantize_plain(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``acc.float() * (sx * sw) (+ bias)``, cast to ``out_dtype``; channels last."""
    y = acc.to(torch.float32) * (sx.reshape(()) * sw)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: int = 1, groups: int = 1,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``int8_conv``."""
    _check_inputs(x, w, sx, sw, bias, stride, groups, out_dtype)
    return dequantize_plain(int8_conv_accumulate_plain(x, w, stride, groups), sx, sw, bias, out_dtype)


def int8_conv(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int = 1, groups: int = 1,
              out_dtype: torch.dtype = torch.float32, tile: int = 0, split: int = 0) -> torch.Tensor:
    """Int8 convolution ``x [N, H, W, C]`` by ``w [O, kh, kw, C / groups]``
    with "SAME" pads, dequantized by ``sx`` (a float32 scalar tensor) and
    ``sw [O]``, plus ``bias [O]`` when given: ``[N, Ho, Wo, O]`` in
    ``out_dtype`` (float32 or bfloat16), through the op
    ``maskrcnn_tf2_tpu_torch::int8_conv``. CPU tensors take the plain
    version; CUDA tensors (contiguous copies where they are not) launch the
    kernel ``plan`` chooses: ``int8_conv.last_path`` names it
    (``tensor-core`` for one group; ``grouped depthwise``, ``grouped dp4a
    words`` or ``grouped bytes`` for several) and ``int8_conv.last_plan``
    holds the whole plan. ``tile`` and ``split``, where not 0, override the
    plan's (for measuring the alternatives)."""
    _check_inputs(x, w, sx, sw, bias, stride, groups, out_dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv runs on cpu or cuda, not {x.device}")
    return _int8_conv_op(x, w, sx, sw, bias, int(stride), int(groups), _DTYPE_CODES[out_dtype], int(tile),
                         int(split))


# The op takes the output dtype as the kernels' dtype code: torch 2.11's
# AOTInductor hands a custom op's ScalarType argument over as another dtype
# (float32 arrives as float64, bfloat16 as quint8).
_OUT_DTYPES = {code: dtype for dtype, code in _DTYPE_CODES.items()}


@torch.library.custom_op("maskrcnn_tf2_tpu_torch::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int, groups: int, out_dtype: int, tile: int, split: int) -> torch.Tensor:
    return int8_conv_plain(x, w, sx, sw, bias, stride, groups, _OUT_DTYPES[out_dtype])


@_int8_conv_op.register_fake
def _(x, w, sx, sw, bias, stride, groups, out_dtype, tile, split):
    out_dtype = _OUT_DTYPES[out_dtype]
    _check_inputs(x, w, sx, sw, bias, stride, groups, out_dtype)
    n, h, wd, _ = x.shape
    return x.new_empty((n, -(-h // stride), -(-wd // stride), w.shape[0]), dtype=out_dtype)


@_int8_conv_op.register_kernel("cuda")
def _(x, w, sx, sw, bias, stride, groups, out_dtype, tile, split):
    out_dtype = _OUT_DTYPES[out_dtype]
    _check_inputs(x, w, sx, sw, bias, stride, groups, out_dtype)
    x, w, sx, sw = (t.contiguous() for t in (x, w, sx, sw))  # the plan takes any alignment
    bias = None if bias is None else bias.contiguous()
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    y = torch.empty((n, -(-h // stride), -(-wd // stride), o), dtype=out_dtype, device=x.device)
    if n == 0:
        return y
    p = plan(n, h, wd, c, o, kh, kw, stride, groups, _alignment(x), _alignment(w), SMS, tile, split)
    return _launch(p, x, w, sx, sw, bias, stride, groups, y)


def _launch(p: Plan, x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
            bias: Optional[torch.Tensor], stride: int, groups: int, y: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of plan ``p`` into ``y``, the checked contiguous
    inputs of ``int8_conv`` on the card, and count the launch."""
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    top, _ = same_pad_amounts(h, kh, stride)
    left, _ = same_pad_amounts(wd, kw, stride)
    lib = _build.load("int8_conv", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        workspace = counters = None
        if p.split > 1:
            workspace = torch.empty(p.workspace_elements(), dtype=torch.int32, device=x.device)
            counters = _tile_counters(x.device, stream, p.grid[0] * p.grid[1])
        status = lib.int8_conv_launch(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[y.dtype], n, h, wd, c, o, kh, kw, stride, top, left, groups, y.shape[1],
            y.shape[2], _KERNEL_CODES[p.kernel], p.tile, p.vec, p.split, p.steps_per_split,
            None if workspace is None else workspace.data_ptr(), None if counters is None else counters.data_ptr(),
            stream,
        )
    _build.check(lib, status, "int8_conv")
    _build.count_launch(int8_conv)
    int8_conv.last_path = p.kernel
    int8_conv.last_plan = p
    return y


int8_conv.launches = 0
int8_conv.last_path = None
int8_conv.last_plan = None


_SIGNATURES = {
    "int8_conv_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19 + [ctypes.c_void_p] * 3,
        ctypes.c_int,
    )
}
