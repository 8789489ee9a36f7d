#!/usr/bin/env python3
"""Time variants of the ROIAlign backward kernel on one CUDA card.

    python3 tune_roi_backward.py [--ablate] [--parent-source FILE] [--steps-before N]

Each variant is ``csrc/roi_align.cu`` with some of its constants replaced in
the text (tile shape, warps per block, blocks per multiprocessor, loads in
flight), built on its own with the package's flags, and run through the
package's wrapper. Inputs: the two calls one flagship training step makes
(captured as ``chip_smoke.py`` captures them; random weights, so sparse and
small ROIs), the 1152x1152 float32 pyramid, and two made-up box sets on the
flagship's cotangents: ``clustered`` (200 ROIs per image within 0.02 of four
ground-truth-like boxes, denser than NMS at 0.7 would leave) and ``onetile``
(all 400 ROIs the same 5x5-pixel box in a corner: every term on one tile).
Every variant is held against the plain version at ``chip_smoke.py``'s
tolerances and timed with its ``kernel_ms`` (L2 flushed, best of two means of
20). ``--ablate`` adds versions of the shipped kernel with parts cut out
(wrong results, times only): where the time goes. ``--parent-source`` also
times an earlier two-pass source (memset, atomics, cast) through its own
launcher signature, on the same inputs and the same card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import roi_align as rk

SOURCE = (_build.CSRC_DIR / "roi_align.cu").read_text()


def blocks(k):
    return ("sizeof(T) == 2 ? 4 : 3", str(k))


def tile(h, w):
    return [("constexpr int kTileH = 4;", f"constexpr int kTileH = {h};"),
            ("constexpr int kTileW = 4;", f"constexpr int kTileW = {w};")]


def warps(k):
    return ("constexpr int kBwdWarps = 8;", f"constexpr int kBwdWarps = {k};")


def loads(k):
    return ("constexpr int kLoads = 2;", f"constexpr int kLoads = {k};")


VARIANTS = [
    ("shipped: 4x4 tile, 8 warps, 2 loads, blocks bf16 4 / f32 3", []),
    ("3 blocks", [blocks(3)]),
    ("2 blocks", [blocks(2)]),
    ("4 loads, 3 blocks", [loads(4), blocks(3)]),
    ("1 load, 4 blocks", [loads(1), blocks(4)]),
    ("2x4 tile (1 pixel a warp), 3 blocks", [*tile(2, 4), blocks(3)]),
    ("4x8 tile (4 pixels a warp), 2 blocks", [*tile(4, 8), blocks(2)]),
    ("2x4 tile, 4 warps, 6 blocks", [*tile(2, 4), warps(4), blocks(6)]),
    ("a warp's pixels side by side", [("k * kBwdWarps + warp", "warp * kPixPerWarp + k")]),
    ("shipped, again", []),
]
_NO_BOXES = ("  for (int first = 0; first < n; first += kBwdThreads) {",
             "  for (int first = 0; first < 0; first += kBwdThreads) {")
_NO_STORE = ("    if (live && y < hl && x < wl) Ch::store(", "    if (live && y < hl && x < wl && acc[k][0] == 123.0f) Ch::store(")
_NO_GATHER = ("    for (int r0 = 0; r0 < kept; r0 += kRound) {", "    for (int r0 = 0; r0 < kept - (1 << 30); r0 += kRound) {")
_ONE_ADDRESS = ("raw[k][j] = Ch::fetch(src + static_cast<size_t>(s_queue[warp][k][t0 + j].x) * c);",
                "raw[k][j] = Ch::fetch(src);")
_NO_SUMS = ("        if (live) {\n          for (int t0 = 0; t0 < most_terms; t0 += kLoads) {",
            "        if (live && c < 0) {\n          for (int t0 = 0; t0 < most_terms; t0 += kLoads) {")
ABLATIONS = [
    ("every load from one address: the gather without its memory traffic", [_ONE_ADDRESS]),
    ("terms queued but not summed: no loads, no adds", [_NO_SUMS]),
    ("empty blocks: no boxes, no store", [_NO_BOXES, _NO_STORE]),
    ("zero fill: no boxes", [_NO_BOXES]),
    ("box filter only: no gather, no store", [_NO_GATHER, _NO_STORE]),
    ("box filter and store: no gather", [_NO_GATHER]),
    ("no store", [_NO_STORE]),
]


def start_build(index, subs):
    src = SOURCE
    for old, new in subs:
        if old not in src:
            raise KeyError(f"variant text not in csrc/roi_align.cu: {old}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"variant{index}.cu"
    path.write_text(src)
    lib = path.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load(path, signatures):
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def two_pass_backward(lib):
    """Wrapper of the earlier launcher: float32 scratch, memset, atomics, cast."""
    def run(dout, boxes, level_hw, image_shape):
        b, n, p, _, c = dout.shape
        total = b * c * sum(h * w for h, w in level_hw)
        acc = torch.empty(total, dtype=torch.float32, device=boxes.device)
        out = acc if dout.dtype == torch.float32 else torch.empty(total, dtype=dout.dtype, device=boxes.device)
        scale = np.float32(244.0) / np.sqrt(np.float32(float(image_shape[0]) * float(image_shape[1])))
        status = lib.roi_align_backward_launch(
            acc.data_ptr(), out.data_ptr(), *(h for h, _ in level_hw), *(w for _, w in level_hw), len(level_hw),
            boxes.data_ptr(), b, n, c, p, float(scale), rk._DTYPE_CODES[dout.dtype], dout.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, status, "two-pass roi_align_backward")
        return rk._split_levels(out, b, level_hw, c)
    return run


def cases(device, steps_before):
    tcalls = cs.capture_train(device, steps_before)[-1]
    (d14, boxes, level_hw, shape), (d7, _, _, _) = (args[:4] for args, _ in tcalls["roi_align_backward"])
    cs.log(f"captured after {steps_before} steps: " + cs.backward_work(boxes, level_hw, 14, shape))
    rs = np.random.RandomState(cs.SEED + 3)
    big_hw = [(1152 // s, 1152 // s) for s in (4, 8, 16, 32)]
    big = torch.from_numpy(rs.normal(size=(1, 200, 14, 14, 256)).astype(np.float32)).to(device)
    big_boxes = torch.from_numpy(cs.roi_like_boxes(rs, 200)[None]).to(device)
    gt = np.array([[0.1, 0.1, 0.5, 0.45], [0.3, 0.5, 0.9, 0.95], [0.55, 0.1, 0.75, 0.3], [0.05, 0.6, 0.2, 0.8]],
                  np.float32)
    near = gt[rs.randint(0, 4, (2, 200))] + rs.normal(0, 0.02, (2, 200, 4)).astype(np.float32)
    clustered = torch.from_numpy(np.clip(near, 0, 1).astype(np.float32)).to(device)
    onetile = torch.tensor([0.0, 0.0, 0.01, 0.01], device=device).expand(2, 200, 4).contiguous()
    cs.log("clustered: " + cs.backward_work(clustered, level_hw, 14, shape))
    return [("14x14", d14, boxes, level_hw, shape), ("7x7", d7, boxes, level_hw, shape),
            ("1152 f32", big, big_boxes, big_hw, (1152, 1152)),
            ("clustered 14x14", d14, clustered, level_hw, shape), ("clustered 7x7", d7, clustered, level_hw, shape),
            ("onetile 7x7", d7, onetile, level_hw, shape)]


def time_cases(fn, inputs, want, flush):
    row = {}
    for name, dout, boxes, level_hw, shape in inputs:
        got = fn(dout, boxes, level_hw, shape)
        torch.cuda.synchronize()
        scale = max(float(w.float().abs().max()) for w in want[name])
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want[name]))
        tol = (1e-5 if dout.dtype == torch.float32 else 2.0**-8) * scale
        us = min(cs.kernel_ms(lambda: fn(dout, boxes, level_hw, shape), 20, flush) for _ in range(2)) * 1e3
        row[name] = f"{us:.1f}" + ("" if err <= tol else " (wrong)")
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--parent-source", default=None)
    ap.add_argument("--steps-before", type=int, default=0,
                    help="training steps to take before the captured one (the ROIs move as the RPN trains)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_roi_backward needs a CUDA card")
    device = torch.device("cuda")
    variants = VARIANTS + (ABLATIONS if args.ablate else [])
    builds = [start_build(i, subs) for i, (_, subs) in enumerate(variants)]  # all compilers at once
    _build.build(["nms", "roi_align"])
    inputs = cases(device, args.steps_before)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)
    want = {name: rk.roi_align_backward_plain(d, b, l, s) for name, d, b, l, s in inputs}
    cs.log("microseconds by case; (wrong) marks a result outside the tolerance, as every ablation is")
    if args.parent_source:
        target = _build.BUILD_DIR / "parent.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), args.parent_source],
                       check=True, capture_output=True)
        ints, ptr = ctypes.c_int, ctypes.c_void_p
        lib = load(target, {"roi_align_backward_launch": (
            [ptr, ptr] + [ints] * 9 + [ptr] + [ints] * 4 + [ctypes.c_float, ints, ptr, ptr], ints)})
        cs.log(f"{'two-pass source ' + args.parent_source:60s} {time_cases(two_pass_backward(lib), inputs, want, flush)}")
    shipped = rk._build._libs.get("roi_align")
    for (name, _), (proc, lib) in zip(variants, builds):
        out, _ = proc.communicate()
        if proc.returncode:
            cs.log(f"{name}: build failed\n{out[-2000:]}")
            continue
        regs = re.findall(r"roi_align_backward_kernelI(\w+?)Li(\d)E[^\n]*\n[^\n]*\n[^\n]*spill stores[^\n]*\n[^\n]*Used (\d+) registers", out)
        spill = max(int(x) for x in re.findall(r"(\d+) bytes spill stores", out))
        rk._build._libs["roi_align"] = load(lib, rk._SIGNATURES)
        row = time_cases(rk.roi_align_backward, inputs, want, flush)
        kinds = {"13__nv_bfloat16": "bf16", "f": "f32"}
        used = ", ".join(f"{kinds.get(t, t)} x{v} {r}" for t, v, r in dict.fromkeys(regs))
        cs.log(f"{name:60s} {row}; registers {used}; largest spill {spill} B")
    if shipped is not None:
        rk._build._libs["roi_align"] = shipped
    cs.log(cs.card_line())


if __name__ == "__main__":
    main()
