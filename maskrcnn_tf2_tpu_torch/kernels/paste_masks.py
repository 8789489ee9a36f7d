"""The served masks pasted into the original images: the CUDA kernel (K8) and
its plain version.

``paste_masks`` calls the op ``maskrcnn_tf2_tpu_torch::paste_masks``, which
launches ``csrc/paste_masks.cu`` for CUDA tensors (one launch a batch) and
runs ``paste_masks_plain``, the host paste of ``data/transforms.py``, for
CPU tensors; its fake implementation gives tracers the output shapes.

Both write, for image ``i`` of the batch, its masks in the layout
``unmold_detections`` returns, ``[H0, W0, K]`` bytes (0 or 1; ``K`` the kept
detections), at ``offsets[i]`` of one flat uint8 buffer ``out`` whose layout
``block_layout`` gives, and return ``K`` in ``kept[i]``. Past each image's
``H0 * W0 * K`` bytes ``out`` is not written (the kernel zeroes the rest of
its last 16-byte piece). The kernel's arithmetic is the host's bit for bit
(the source's header says how). On the card ``out`` may be device memory or
pinned host memory: the kernel then writes the masks over the host link
itself, exactly the kept bytes, so that no copy has to be sized and issued
once ``K`` is known.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.data.transforms import paste_kept_masks, unmold_boxes
from maskrcnn_tf2_tpu_torch.kernels import _build

MAX_DETECTIONS = 1024  # slots in shared memory (kMaxDetections in csrc/paste_masks.cu)
MAX_IMAGE_BYTES = 2**31  # an image's [H0, W0, D] block is indexed in 32 bits


def block_layout(shapes: Sequence[Tuple[int, int]], d: int) -> Tuple[np.ndarray, int, int]:
    """``(offsets [B] int64, total bytes, largest block)`` of a batch's
    buffer: image ``i`` (original ``shapes[i]``) gets room for ``[H0, W0, d]``
    bytes, rounded up to 16, from ``offsets[i]``."""
    sizes = [int(h) * int(w) * d for h, w in shapes]
    if any(s >= MAX_IMAGE_BYTES for s in sizes):
        raise ValueError(f"paste_masks takes images of H0 * W0 * detections < 2**31, got {max(sizes)}")
    room = [-(-s // 16) * 16 for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(room)[:-1]]).astype(np.int64) if room else np.zeros(0, np.int64)
    return offsets, int(sum(room)), max(sizes, default=0)


def _check_inputs(detections, masks, meta, offsets, out) -> None:
    if detections.dim() != 3 or detections.shape[-1] != 6 or detections.dtype != torch.float32:
        raise ValueError(f"detections must be float32 [B, D, 6], got {detections.dtype} {tuple(detections.shape)}")
    b, d = detections.shape[:2]
    if masks.dim() != 4 or tuple(masks.shape[:2]) != (b, d) or masks.dtype != torch.float32:
        raise ValueError(f"masks must be float32 [B, D, mh, mw], got {masks.dtype} {tuple(masks.shape)}")
    if meta.dim() != 2 or meta.shape[0] != b or meta.shape[1] < 11 or meta.dtype != torch.float32:
        raise ValueError(f"meta must be float32 [B, >= 11], got {meta.dtype} {tuple(meta.shape)}")
    if offsets.shape != (b,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be int64 [B], got {offsets.dtype} {tuple(offsets.shape)}")
    if out.dim() != 1 or out.dtype != torch.uint8 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 [total], got {out.dtype} {tuple(out.shape)}")
    if len({t.device for t in (detections, masks, meta, offsets)}) != 1:
        raise ValueError("detections, masks, meta and offsets must be on one device")
    if d > MAX_DETECTIONS:
        raise ValueError(f"paste_masks takes at most {MAX_DETECTIONS} detections an image, got {d} "
                         "(detection_max_instances)")


def paste_masks_plain(detections: torch.Tensor, masks: torch.Tensor, meta: torch.Tensor, offsets: torch.Tensor,
                      image_shape, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paste_masks``: ``unmold_boxes``, then
    ``paste_kept_masks``, image by image."""
    _check_inputs(detections, masks, meta, offsets, out)
    kept = torch.zeros(detections.shape[0], dtype=torch.int32)
    flat = out.numpy()
    for i, (det, m, row, off) in enumerate(zip(detections.numpy(), masks.numpy(), meta.numpy(), offsets.tolist())):
        shape = (int(row[1]), int(row[2]))
        _, boxes, keep = unmold_boxes(det, shape, image_shape, row[7:11])
        block = flat[off:off + shape[0] * shape[1] * len(keep)].reshape(shape + (len(keep),)).view(bool)
        paste_kept_masks(block, m, boxes, keep)
        kept[i] = len(keep)
    return kept


def paste_masks(detections: torch.Tensor, masks: torch.Tensor, meta: torch.Tensor, offsets: torch.Tensor,
                image_shape, out: torch.Tensor, largest: int) -> torch.Tensor:
    """Paste a batch's masks into ``out``: ``detections [B, D, 6]``
    normalized, ``masks [B, D, mh, mw]`` at each detection's class, ``meta
    [B, M]`` (original shape and window), ``offsets`` and ``largest`` from
    ``block_layout``, ``out`` of its ``total`` bytes, ``image_shape`` the
    molded image's.

    Returns ``kept [B] int32``, image ``i``'s ``[H0, W0, kept[i]]`` masks at
    ``out[offsets[i]:]``, through the op ``maskrcnn_tf2_tpu_torch::paste_masks``:
    CPU tensors take the plain version, CUDA tensors launch the kernel (``out``
    in device memory or pinned host memory).
    """
    _check_inputs(detections, masks, meta, offsets, out)
    if detections.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paste_masks runs on cpu or cuda, not {detections.device}")
    if detections.device.type == "cuda" and out.device != detections.device and out.numel() and not out.is_pinned():
        raise ValueError("on the card, out must be on the detections' device or in pinned host memory")
    if detections.device.type == "cpu" and out.device.type != "cpu":
        raise ValueError("the plain version writes a CPU out")
    return _paste_masks_op(detections, masks, meta, offsets, int(image_shape[0]), int(image_shape[1]), out,
                           int(largest))


paste_masks.launches = 0


@torch.library.custom_op("maskrcnn_tf2_tpu_torch::paste_masks", mutates_args=("out",), device_types="cpu")
def _paste_masks_op(detections: torch.Tensor, masks: torch.Tensor, meta: torch.Tensor, offsets: torch.Tensor,
                    image_h: int, image_w: int, out: torch.Tensor, largest: int) -> torch.Tensor:
    return paste_masks_plain(detections, masks, meta, offsets, (image_h, image_w), out)


@_paste_masks_op.register_fake
def _(detections, masks, meta, offsets, image_h, image_w, out, largest):
    _check_inputs(detections, masks, meta, offsets, out)
    return detections.new_empty((detections.shape[0],), dtype=torch.int32)


@_paste_masks_op.register_kernel("cuda")
def _(detections, masks, meta, offsets, image_h, image_w, out, largest):
    _check_inputs(detections, masks, meta, offsets, out)
    b, d, mh, mw = masks.shape
    device = detections.device
    kept = torch.empty(b, dtype=torch.int32, device=device)
    if b == 0:
        return kept
    detections, masks, meta = detections.contiguous(), masks.contiguous(), meta.contiguous()
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned (the kernel stores 16 bytes at a time)")
    lib = _build.load("paste_masks", _SIGNATURES)
    with torch.cuda.device(device):  # the launch goes to the current device
        status = lib.paste_masks_launch(
            detections.data_ptr(), masks.data_ptr(), meta.data_ptr(), offsets.data_ptr(),
            b, d, mh, mw, meta.shape[1], image_h, image_w, largest,
            out.data_ptr(), kept.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, status, "paste_masks")
    _build.count_launch(paste_masks)
    return kept


_SIGNATURES = {
    "paste_masks_launch": (
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ],
        ctypes.c_int,
    )
}
