"""Int8 convolution with its dequantize epilogue: the CUDA kernel and its plain version.

``int8_conv`` launches ``csrc/int8_conv.cu`` for CUDA tensors and runs
``int8_conv_plain`` for CPU tensors. Both compute what the JAX package's
``models/quant.py::Int8Conv`` leaves to XLA: an s8 x s8 convolution with flax's
"SAME" pads and an int32 sum, then ``acc.float() * (sx * sw) + bias``, cast to
the output dtype, each step rounded once. Tensors are channels-last:
``x [N, H, W, C]`` int8, ``w [O, kh, kw, C / groups]`` int8, the output
``[N, ceil(H / stride), ceil(W / stride), O]``. The dense layers are the same
function over a 1x1 image: ``x [M, 1, 1, K]``, ``w [F, 1, 1, K]``.

The plain version sums in float64 (``F.conv2d`` over the padded int8 values,
then rounded to int32): every product and partial sum is an integer below
2^53, so the sum is exact in any order and equals the int32 one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.models.layers import same_pad_amounts

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# |acc| <= K * 127^2 must fit int32
MAX_K = (2**31 - 1) // (127 * 127)


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
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Int8 convolution ``x [N, H, W, C]`` by ``w [O, kh, kw, C / groups]``
    with "SAME" pads, dequantized by ``sx`` (a float32 scalar tensor) and
    ``sw [O]``, plus ``bias [O]`` when given: ``[N, Ho, Wo, O]`` in
    ``out_dtype`` (float32 or bfloat16). CPU tensors take the plain version;
    CUDA tensors launch the kernel, and ``int8_conv.last_path`` names the one
    it took: ``tiled`` for one group, ``direct`` for several, on packed 32-bit
    words (``dp4a``) where a group's channels are a multiple of 4 and both
    pointers 4-byte aligned, on bytes otherwise."""
    _check_inputs(x, w, sx, sw, bias, stride, groups, out_dtype)
    if x.device.type == "cpu":
        return int8_conv_plain(x, w, sx, sw, bias, stride, groups, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cpu or cuda, not {x.device}")
    tensors = [x, w, sx, sw] + ([] if bias is None else [bias])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_conv needs contiguous x, w, sx, sw and bias")
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    top, _ = same_pad_amounts(h, kh, stride)
    left, _ = same_pad_amounts(wd, kw, stride)
    ho, wo = -(-h // stride), -(-wd // stride)
    y = torch.empty((n, ho, wo, o), dtype=out_dtype, device=x.device)
    if n == 0:
        return y
    lib = _build.load("int8_conv", _SIGNATURES)
    path = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        status = lib.int8_conv_launch(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[out_dtype], n, h, wd, c, o, kh, kw, stride, top, left, groups, ho, wo,
            torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(path),
        )
    _build.check(lib, status, "int8_conv")
    int8_conv.launches += 1
    int8_conv.last_path = _PATHS[path.value]
    return y


int8_conv.launches = 0
int8_conv.last_path = None
_PATHS = ("tiled bytes", "tiled dp4a words", "direct bytes", "direct dp4a words")


_SIGNATURES = {
    "int8_conv_launch": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
        ctypes.c_int,
    )
}
