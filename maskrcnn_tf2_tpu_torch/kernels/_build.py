"""Build the CUDA sources under ``csrc/`` with ``nvcc``, and the host C
sources with the system C compiler, and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so``, where the hash (``source_digest``) covers
the source and the flags, so an edited source never loads a stale library. Nothing is built at
import time: the first call of a kernel on a CUDA tensor builds its library,
and ``build`` builds several at once, one ``nvcc`` process per source, all
started together. A host source (``native/rle_ext.c``) is named the same way
(``host_target``) and built by ``$CC``, else ``cc``, at its first call
(``load_host``).

The flags are IEEE: no ``--use_fast_math``, and ``-fmad=false`` so that
``a * b + c`` is not contracted into one rounding. The NMS predicate then
agrees bit for bit with PyTorch's element-wise ops, which round every step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
CC_FLAGS = ("-std=c99", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_digest(name: str) -> str:
    """sha256 of ``csrc/<name>.cu`` and the flags it is built with."""
    src = CSRC_DIR / f"{name}.cu"
    return hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)[:12]}.so"


def host_target(src: Path) -> Path:
    """``_build/lib<stem>-<hash>.so`` for a host C source: the sha256 of the
    source and ``CC_FLAGS``."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:12]}.so"


def build_host(src: Path) -> Path:
    """Compile a host C source with ``$CC`` (else ``cc``) unless its library
    is current, and return the library's path. Raises with the compiler's
    output on failure: there is no fallback."""
    target = host_target(src)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = os.environ.get("CC") or "cc"
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"C compiler {cc!r} could not run for {src.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed for {src.name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return target


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, in parallel.

    Returns the compiler's output (``ptxas`` register and shared-memory
    report) for each source compiled in this call. Raises on any failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, with
    ``argtypes`` and ``restype`` set from ``signatures`` (function name ->
    (argtypes, restype))."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _declare(ctypes.CDLL(str(_target(name))),
                           {"kernel_error_string": ([ctypes.c_int], ctypes.c_char_p), **signatures})
            _libs[name] = lib
        return lib


def load_host(src: Path, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of a host C source, built first if needed, with
    the functions of ``signatures`` declared. ``ctypes.CDLL`` releases the
    interpreter lock for each call, so threads call it in parallel."""
    with _lock:
        lib = _libs.get(str(src))
        if lib is None:
            lib = _declare(ctypes.CDLL(str(build_host(src))), signatures)
            _libs[str(src)] = lib
        return lib


def _declare(lib: ctypes.CDLL, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and 16-byte aligned, else a copy that is.
    Inside a compiled graph a kernel's input can be a view at any offset of a
    pooled buffer; a new tensor from the caching allocator is aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """``wrapper.launches += 1`` under a lock: a data-parallel predictor's
    replicas launch the kernels from threads of their own, and a bare
    increment there can lose a count."""
    with _count_lock:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {status} ({msg})")
