"""COCO RLE decoding in C (counterpart of ``maskrcnn_tf2_tpu/native/rle.py``).

``rle_ext.c`` has a plain C interface. ``kernels/_build.py::load_host``
compiles it with ``$CC`` (else ``cc``) at the first call, into
``_build/librle_ext-<sha256>.so``, and loads it with ``ctypes.CDLL``, which
releases the interpreter lock for each call: the loader's threads decode in
parallel. A failed build raises with the compiler's output; unlike the JAX
package, nothing falls back to numpy silently. ``data/coco.py::rle_to_mask``
decodes through ``decode_mask`` unless ``MASKRCNN_TPU_NO_NATIVE_RLE`` is set.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from maskrcnn_tf2_tpu_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "rle_ext.c"
_SIGNATURES = {
    "decode_counts": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int64),
    "decode_mask": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p], None),
}


def _lib() -> ctypes.CDLL:
    return _build.load_host(SOURCE, _SIGNATURES)


def _runs(s: str) -> np.ndarray:
    data = s.encode()  # UTF-8, as the JAX extension reads a str
    out = np.empty(max(len(data), 1), np.int64)  # a count takes at least one character
    m = _lib().decode_counts(data, len(data), out.ctypes.data)
    if m < 0:
        raise ValueError("truncated RLE counts string")
    return out[:m]


def decode_counts(s: str) -> List[int]:
    """COCO compressed RLE counts string -> run lengths."""
    return _runs(s).tolist()


def decode_mask(counts: Union[str, Sequence[int]], h: int, w: int) -> np.ndarray:
    """Runs (a compressed string or a sequence of ints) -> bool mask ``[h, w]``.
    Negative runs count as 0; runs are cut at ``h * w`` and padded with zeros
    up to it."""
    if h < 0 or w < 0:
        raise ValueError("h and w must be non-negative")
    runs = _runs(counts) if isinstance(counts, str) else np.asarray(counts, dtype=np.int64)
    if runs.ndim != 1:
        raise ValueError(f"counts must be a str or a flat sequence of ints, not shape {runs.shape}")
    runs = np.ascontiguousarray(runs)
    out = np.empty(h * w, np.uint8)
    _lib().decode_mask(runs.ctypes.data, runs.size, h, w, out.ctypes.data)
    return out.reshape(w, h).T.view(bool)  # column-major runs
