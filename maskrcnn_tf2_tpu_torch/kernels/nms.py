"""Exact greedy NMS over score-sorted boxes: the CUDA kernel and its plain version.

``greedy_nms`` launches ``csrc/nms.cu`` for CUDA tensors (one launch for the
whole batch, one thread block per image) and runs ``greedy_nms_plain`` for
CPU tensors. Both return the compacted contract of
``ops.nms.non_max_suppression``: the positions of the first ``limit`` kept
boxes on the sorted axis, in order, zero-padded, with a validity mask.

Suppression is ``inter / max(union, 1e-10) > iou_threshold`` with
``box_area``'s clamps, exactly as ``ops.boxes.overlaps`` computes it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.ops.boxes import overlaps

TILE = 512  # rows per step of the plain version's tile-sequential sweep
# A Hopper block has 232,448 bytes of shared memory: the kernel's tile arrays
# take 6,148 and each kept box 20 (its float4 and its area), past 48 KB by the
# launcher's opt-in to the larger dynamic size.
MAX_KERNEL_LIMIT = (232448 - 6148) // 20


def _check_inputs(boxes_s: torch.Tensor, valid_s: torch.Tensor, limit: int) -> None:
    if boxes_s.dim() != 3 or boxes_s.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes_s.shape)}")
    if boxes_s.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes_s.dtype}")
    if valid_s.dtype != torch.bool or valid_s.shape != boxes_s.shape[:2]:
        raise ValueError("valid must be a bool [B, N] mask")
    if valid_s.device != boxes_s.device:
        raise ValueError("boxes and valid must be on one device")
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")


def check_kernel_limit(limit: int) -> None:
    """Raise, naming the configuration knobs, if ``limit`` kept boxes do not
    fit the kernel's shared memory."""
    if limit > MAX_KERNEL_LIMIT:
        raise ValueError(
            f"greedy_nms keeps at most {MAX_KERNEL_LIMIT} boxes per image on the card "
            f"(limit {limit} x 20 bytes of shared memory per block); lower "
            "post_nms_rois_training, post_nms_rois_inference or detection_max_instances"
        )


def _compact(keep: torch.Tensor, limit: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``limit`` True positions of ``keep [B, N]``, in order, padded."""
    b, n = keep.shape
    if n < limit:
        keep = torch.cat([keep, keep.new_zeros((b, limit - n))], dim=1)
        n = limit
    idx = torch.arange(n, device=keep.device).expand(b, n)
    # unique keys: kept positions first, each group in ascending order
    order = torch.sort(torch.where(keep, idx, idx + n), dim=1).indices[:, :limit]
    valid = torch.gather(keep, 1, order)
    return torch.where(valid, order, 0).to(torch.int32), valid


def _self_suppress(iou_block: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep-mask within one tile by fixpoint iteration of
    ``keep[i] = valid[i] & !any_{j<i}(keep[j] & iou[j, i])``."""
    t = iou_block.shape[-1]
    upper = torch.ones((t, t), dtype=torch.bool, device=iou_block.device).triu(1)
    g = iou_block & upper & row_valid[:, :, None] & row_valid[:, None, :]
    keep = row_valid
    for _ in range(t):
        suppressed = (keep[:, :, None] & g).any(dim=1)
        new_keep = row_valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def greedy_keep_plain(
    boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Keep-mask ``[B, N]`` of exact greedy NMS, tile-sequential: the finalized
    prefix suppresses each tile, then a fixpoint settles chains inside it
    (the algorithm of ``maskrcnn_tf2_tpu/ops/nms.py::_greedy_keep_tiled``)."""
    b, n, _ = boxes_s.shape
    tile = min(TILE, max(n, 1))
    pad = (-n) % tile
    if pad:
        boxes_s = torch.cat([boxes_s, boxes_s.new_zeros((b, pad, 4))], dim=1)
        valid_s = torch.cat([valid_s, valid_s.new_zeros((b, pad))], dim=1)
    keep = torch.zeros_like(valid_s)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=boxes_s.device)
    for start in range(0, n + pad, tile):
        rows = boxes_s[:, start : start + tile]
        iou_all = overlaps(rows, boxes_s) > thr  # [B, T, N]
        cross = (iou_all[:, :, :start] & keep[:, None, :start]).any(dim=2)
        row_valid = valid_s[:, start : start + tile] & ~cross
        diag = iou_all[:, :, start : start + tile]
        keep[:, start : start + tile] = _self_suppress(diag, row_valid)
    return keep[:, :n]


def greedy_nms_plain(
    boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_threshold: float, limit: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``greedy_nms``."""
    _check_inputs(boxes_s, valid_s, limit)
    return _compact(greedy_keep_plain(boxes_s, valid_s, iou_threshold), limit)


def greedy_nms(
    boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_threshold: float, limit: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of score-sorted boxes ``[B, N, 4]`` with mask ``[B, N]``.

    Returns ``(positions [B, limit] int32, valid [B, limit] bool)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_inputs(boxes_s, valid_s, limit)
    if boxes_s.device.type == "cpu":
        return greedy_nms_plain(boxes_s, valid_s, iou_threshold, limit)
    if boxes_s.device.type != "cuda":
        raise ValueError(f"greedy_nms runs on cpu or cuda, not {boxes_s.device}")
    if not (boxes_s.is_contiguous() and valid_s.is_contiguous()):
        raise ValueError("greedy_nms needs contiguous boxes and valid")
    if boxes_s.data_ptr() % 16:
        raise ValueError("greedy_nms reads boxes as float4: they must be 16-byte aligned")
    check_kernel_limit(limit)
    b, n, _ = boxes_s.shape
    positions = torch.empty((b, limit), dtype=torch.int32, device=boxes_s.device)
    out_valid = torch.empty((b, limit), dtype=torch.bool, device=boxes_s.device)
    if b == 0 or limit == 0:
        return positions, out_valid
    lib = _build.load("nms", _SIGNATURES)
    with torch.cuda.device(boxes_s.device):  # the launch goes to the current device
        status = lib.greedy_nms_launch(
            boxes_s.data_ptr(),
            valid_s.data_ptr(),
            b,
            n,
            float(iou_threshold),
            limit,
            positions.data_ptr(),
            out_valid.data_ptr(),
            torch.cuda.current_stream(boxes_s.device).cuda_stream,
        )
    _build.check(lib, status, "greedy_nms")
    greedy_nms.launches += 1
    return positions, out_valid


greedy_nms.launches = 0


_SIGNATURES = {
    "greedy_nms_launch": (
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ],
        ctypes.c_int,
    )
}
