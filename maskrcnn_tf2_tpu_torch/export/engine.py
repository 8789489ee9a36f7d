"""Serving engines: the served forward compiled ahead of time by AOTInductor
(counterpart of ``maskrcnn_tf2_tpu/export/engine.py``).

    build_engine(config, state_dict, "mrcnn.engine", batch_size=2)
    engine = load_engine("mrcnn.engine")
    detections, masks = engine(images_u8, image_meta)  # numpy [B, D, 6], [B, D, mh, mw]

An engine is the AOTInductor package of the served forward at a fixed batch:
uint8 images ``[B, H, W, 3]`` and ``image_meta [B, meta_size]`` go in,
detections and each detection's own class mask (gathered on the device) come
out. Loading it compiles nothing: the package holds the compiled wrapper
library and, on the card, the compiled Triton kernels; the hand-written
kernels are ops of the graph that the package calls through the PyTorch
dispatcher, so they launch from ``kernels/_build.py``'s libraries and count
their launches as in eager serving. Inductor compiles the rest with the
options that keep eager's roundings (``_eager_numerics``). The package is
built without its weights (``aot_inductor.package_constants_in_so=False``);
they travel in the engine's own section and are handed to it with
``load_constants``: every name that ``get_constant_fqns()`` lists, which
besides the ``state_dict`` covers the non-persistent buffers (the anchors,
an int8 model's quantized weights) and the constants the forward makes on
the host.

An engine is pinned to what it was built with: the platform, the card's
name and compute capability (or, for a CPU engine, the host's CPU and
libraries), the torch and CUDA versions and the sources of the kernels its
graph calls. ``load_engine`` checks each and raises a "rebuild" error that
names what differs.

File format: a header line ``maskrcnn_tf2_tpu_torch.engine.v1 <sha256>``,
then three sections, each an 8-byte big-endian length and its bytes:

  1. JSON metadata (platform, device, versions, kernel digests, shapes, the
     configuration's md5 and the weight manifest: each constant's name,
     dtype, shape and strides),
  2. the raw weight bytes, in manifest order (bfloat16 as raw bytes; 0-d
     scales stay 0-d),
  3. the AOTInductor package.

The sha256 covers everything after the header and is checked before any
parsing; bytes after the third section are refused. The digest catches
corruption, not malice: the package is compiled code, loaded into the
process. **Load engines only from trusted sources**, as one would a wheel.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import logging
import os
import platform
import shutil
import struct
import subprocess
import tempfile
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device
from maskrcnn_tf2_tpu_torch.export.serialize import export_served
from maskrcnn_tf2_tpu_torch.kernels import _build

MAGIC = b"maskrcnn_tf2_tpu_torch.engine.v1"
# the op of each kernel -> the source in csrc/ it is built from
KERNEL_SOURCES = {"greedy_nms": "nms", "roi_align": "roi_align", "roi_align_backward": "roi_align",
                  "int8_conv": "int8_conv"}


@functools.lru_cache(maxsize=None)
def host_fingerprint() -> str:
    """The build host's identity for CPU engines: system, machine, the CPU's
    model and feature flags, the torch version (the compiled code targets
    the host's instruction set and links its torch)."""
    model, flags = "", ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not model and line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                elif not flags and line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                if model and flags:
                    break
    except OSError:
        pass
    raw = "|".join([platform.system(), platform.machine(), platform.processor(), model, flags, torch.__version__])
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _openmp_cxx() -> str:
    """The first C++ compiler of ``$CXX``, ``g++``, ``c++`` and ``clang++``
    that links a shared library with ``-fopenmp``, as AOTInductor links the
    package (a compiler without its OpenMP runtime fails only there)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("int probe() { return 0; }\n")
        for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"), "g++", "c++", "clang++"))):
            if shutil.which(cxx) and subprocess.run(
                    [cxx, "-shared", "-fPIC", "-fopenmp", src, "-o", os.path.join(tmp, "probe.so")],
                    capture_output=True).returncode == 0:
                return cxx
    raise RuntimeError("no C++ compiler ($CXX, g++, c++, clang++) links a shared library with -fopenmp, as "
                       "AOTInductor links an engine: set CXX to one that does")


def _eager_numerics() -> Dict[str, bool]:
    """Inductor options that keep eager's roundings in the compiled kernels:
    a bf16 value is rounded wherever eager rounds it (no contraction into
    fused multiply-adds across them); float32 division is IEEE (``div_rn``,
    not Triton's approximate ``div.full``); and computations on constants
    are not folded at compile time: folded, an int8 site's scale ``sx``
    (from its calibrated amax) becomes a compile-time constant, and on the
    card Inductor divides by such a constant through its reciprocal. The int8
    sites quantize ``round(x / sx)``: an ulp off there flips a value by a
    step, and the flip spreads (ROADMAP §C, C.5). Last, Inductor's
    ``deterministic`` mode: no choice that changes the arithmetic is made by
    timing on the card, so every build of one program generates the same
    kernels (without it, builds of the flagship generated different kernel
    sets; ROADMAP §C, C.6)."""
    from torch._inductor import config

    division = [name for name in ("eager_numerics.division_rounding", "emulate_divison_rounding",
                                  "emulate_division_rounding")
                if functools.reduce(lambda obj, attr: getattr(obj, attr, None), name.split("."), config) is not None]
    if not division:
        raise RuntimeError(f"torch {torch.__version__}'s Inductor offers no IEEE-division option")
    if not hasattr(config, "deterministic"):
        raise RuntimeError(f"torch {torch.__version__}'s Inductor offers no deterministic mode")
    return {"emulate_precision_casts": True, division[0]: True, "joint_graph_constant_folding": False,
            "deterministic": True}


def _device_identity(device: torch.device) -> Dict[str, object]:
    if device.type == "cuda":
        return {"platform": "cuda", "device_name": torch.cuda.get_device_name(device),
                "compute_capability": list(torch.cuda.get_device_capability(device)),
                "torch_version": torch.__version__, "cuda_version": torch.version.cuda, "host_fp": None}
    return {"platform": device.type, "device_name": device.type, "compute_capability": None,
            "torch_version": torch.__version__, "cuda_version": torch.version.cuda, "host_fp": host_fingerprint()}


def _kernel_digests(graph: torch.fx.Graph) -> Dict[str, str]:
    """sha256 (``kernels/_build.py::source_digest``) of the source of every
    kernel the graph's ops launch."""
    ops = {node.target.name().split("::")[1].split(".")[0] for node in graph.nodes
           if isinstance(node.target, torch._ops.OpOverload) and node.target.namespace == "maskrcnn_tf2_tpu_torch"}
    return {src: _build.source_digest(src) for src in sorted({KERNEL_SOURCES[op] for op in ops})}


def _encode_weights(constants: Mapping[str, torch.Tensor]) -> Tuple[List[dict], bytes]:
    """The manifest (name, dtype, shape, strides) and the bytes of each
    tensor in row-major order of its shape."""
    manifest, chunks = [], []
    for key in sorted(constants):
        t = constants[key].detach().cpu()
        manifest.append({"key": key, "dtype": str(t.dtype).removeprefix("torch."), "shape": list(t.shape),
                         "stride": list(t.stride())})
        chunks.append(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return manifest, b"".join(chunks)


def _decode_weights(manifest: List[dict], raw: bytes, device: torch.device) -> Dict[str, torch.Tensor]:
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
    out, off = {}, 0
    for ent in manifest:
        dtype = getattr(torch, ent["dtype"])
        n = int(np.prod(ent["shape"], dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if off + n > len(raw):
            raise ValueError("the engine's weight section is shorter than its manifest: corrupt, rebuild the engine")
        flat = buf[off:off + n].clone().view(dtype).reshape(ent["shape"])  # clone: aligned for dtype
        t = torch.empty_strided(ent["shape"], ent["stride"], dtype=dtype, device=device)
        out[ent["key"]] = t.copy_(flat)
        off += n
    if off != len(raw):
        raise ValueError("the engine's weight section is longer than its manifest: corrupt, rebuild the engine")
    return out


def _write_section(f, data: bytes) -> None:
    f.write(struct.pack(">Q", len(data)))
    f.write(data)


def _split_sections(body: bytes, n: int) -> List[bytes]:
    """The ``n`` length-prefixed sections of ``body``, which must end with
    the last of them."""
    out, off = [], 0
    for _ in range(n):
        if off + 8 > len(body):
            raise ValueError("truncated engine: rebuild it")
        (length,) = struct.unpack(">Q", body[off:off + 8])
        off += 8
        if off + length > len(body):
            raise ValueError("truncated engine: rebuild it")
        out.append(body[off:off + length])
        off += length
    if off != len(body):
        raise ValueError(f"{len(body) - off} trailing bytes after the engine's {n} sections: not an engine as "
                         "build_engine writes it, rebuild it")
    return out


def write_engine(path: str, metadata: dict, weights: bytes, package: bytes) -> None:
    """The file: header line with the sha256 of the body, then the sections."""
    body = io.BytesIO()
    for section in (json.dumps(metadata).encode(), weights, package):
        _write_section(body, section)
    blob = body.getvalue()
    with open(path, "wb") as f:
        f.write(MAGIC + b" " + hashlib.sha256(blob).hexdigest().encode() + b"\n")
        f.write(blob)


def read_engine(path: str) -> Tuple[dict, bytes, bytes]:
    """``(metadata, weight bytes, package bytes)`` of an engine file, after
    its sha256 and its sections' lengths are checked."""
    with open(path, "rb") as f:
        header = f.read(len(MAGIC) + 66)  # magic, a space, 64 hex digits, a newline
        if not header.startswith(MAGIC + b" ") or not header.endswith(b"\n"):
            raise ValueError(f"{path} is not a {MAGIC.decode()} engine")
        digest = header[len(MAGIC) + 1:-1].decode()
        body = f.read()
    if hashlib.sha256(body).hexdigest() != digest:
        raise ValueError(f"{path} is corrupt (sha256 mismatch): rebuild the engine")
    metadata, weights, package = _split_sections(body, 3)
    return json.loads(metadata), weights, package


def build_engine(config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], path: str, batch_size: int = 1,
                 device: DeviceLike = None) -> str:
    """Export the served forward of ``config`` with ``state_dict`` (an int8
    configuration's calibrated one from ``export.quantize``) at
    ``batch_size``, compile it with AOTInductor for ``device`` (the card by
    default) and write the engine to ``path``. Returns ``path``."""
    device = resolve_device(device)
    program = export_served(config, state_dict, batch_size, device, torch.uint8, gather=True)
    options = {"aot_inductor.package_constants_in_so": False, "cpp.cxx": (_openmp_cxx(),), **_eager_numerics()}
    if device.type == "cuda":
        options["cpp.vec_isa_ok"] = False  # no CPU kernel to vectorize: skip the per-ISA trial compiles
    with tempfile.TemporaryDirectory() as tmp:
        package_path = os.path.join(tmp, "engine.pt2")
        torch._inductor.aoti_compile_and_package(program, package_path=package_path, inductor_configs=options)
        with open(package_path, "rb") as f:
            package = f.read()
    names = _load_package(package, -1).get_constant_fqns()
    constants = {**program.state_dict, **program.constants}
    missing = [k for k in names if k not in constants]
    if missing:
        raise RuntimeError(f"the compiled engine wants constants the exported program lacks: {missing}")
    manifest, weights = _encode_weights({k: constants[k] for k in names})
    metadata = {
        **_device_identity(device),
        "kernels": _kernel_digests(program.graph),
        "backbone": config.backbone,
        "batch_size": batch_size,
        "image_shape": list(config.image_shape),
        "meta_size": int(config.meta_size),
        "config_md5": config.md5(),
        "weights": manifest,
    }
    write_engine(path, metadata, weights, package)
    return path


def _check_gates(metadata: dict, device: torch.device, path: str) -> None:
    here = _device_identity(device)
    for key, what in (("platform", "platform"), ("device_name", "device"),
                      ("compute_capability", "compute capability"), ("torch_version", "torch"),
                      ("cuda_version", "CUDA"), ("host_fp", "host (CPU and libraries)")):
        if metadata.get(key) != here[key]:
            raise RuntimeError(f"{path} was built for {what} {metadata.get(key)!r}, this process runs "
                               f"{here[key]!r}: rebuild the engine with build_engine() here")
    for src, digest in metadata["kernels"].items():
        if digest != _build.source_digest(src):
            raise RuntimeError(f"{path} was built with another csrc/{src}.cu (kernel digest {digest[:12]}, this "
                               f"checkout's {_build.source_digest(src)[:12]}): rebuild the engine with build_engine()")


def _load_package(package: bytes, device_index: int):
    """The AOTInductor package, loaded without a compile: the loader's device
    check would build a trial C++ program for each vector ISA to name this
    host's (``cpp.vec_isa_ok=False`` names none; the engine's gates have
    checked the host), and its warning that the names differ is muted."""
    from torch._inductor import config, cpu_vec_isa

    log = logging.getLogger("torch.export.pt2_archive._package")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with config.patch({"cpp.vec_isa_ok": False}):
            return torch._inductor.aoti_load_package(io.BytesIO(package), device_index=device_index)
    finally:
        log.setLevel(level)
        cpu_vec_isa.valid_vec_isa_list.cache_clear()  # later compiles in this process probe the ISAs again


class Engine:
    """A loaded engine: ``engine(images_u8, image_meta) -> (detections
    [B, D, 6], masks [B, D, mh, mw])`` as numpy arrays, at the batch it was
    built for."""

    def __init__(self, metadata: dict, model, device: torch.device):
        self.metadata = metadata
        self.batch_size = metadata["batch_size"]
        self.image_shape = tuple(metadata["image_shape"])
        self.meta_size = metadata["meta_size"]
        self.backbone = metadata["backbone"]
        self.config_md5 = metadata["config_md5"]
        self.device = device
        self._model = model

    def run(self, images_u8, image_meta) -> Tuple[torch.Tensor, torch.Tensor]:
        """The outputs on the device, without a copy to the host."""
        images = torch.as_tensor(images_u8).to(self.device)
        meta = torch.as_tensor(image_meta).to(self.device, torch.float32)
        want = (self.batch_size, *self.image_shape)
        if images.dtype != torch.uint8 or tuple(images.shape) != want:
            raise ValueError(f"the engine takes uint8 images {want}, got {images.dtype} {tuple(images.shape)}")
        if tuple(meta.shape) != (self.batch_size, self.meta_size):
            raise ValueError(f"the engine takes image_meta ({self.batch_size}, {self.meta_size}), got "
                             f"{tuple(meta.shape)}")
        return self._model(images, meta)

    def __call__(self, images_u8, image_meta) -> Tuple[np.ndarray, np.ndarray]:
        detections, masks = self.run(images_u8, image_meta)
        return detections.cpu().numpy(), masks.cpu().numpy()


def load_engine(path: str, device: DeviceLike = None) -> Engine:
    """Load an engine of ``build_engine`` on ``device`` (the card by
    default). In order: the sha256 and the sections' lengths, every gate,
    and only then the package and its weights. Load engines only from
    trusted sources."""
    device = resolve_device(device)
    metadata, weights, package = read_engine(path)
    _check_gates(metadata, device, path)
    constants = _decode_weights(metadata["weights"], weights, device)
    model = _load_package(package, device.index if device.type == "cuda" and device.index is not None else -1)
    model.load_constants(constants, check_full_update=True)
    return Engine(metadata, model, device)
