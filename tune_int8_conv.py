#!/usr/bin/env python3
"""Time the int8 convolution (K7, ``csrc/int8_conv.cu``) at every site shape of one int8 request, on one CUDA card.

    python3 tune_int8_conv.py [--parent-source FILE.cu] [--variants] [--backbone KEY[+heads] ...] [--reps N]

For each backbone (default: the flagship's ResNet-50 with both int8 head
switches, then ResNeXt-50 and MobileNet V2) the flagship configuration at
that backbone is calibrated on one request of ``chip_smoke.py`` (seeded
random weights) and served once in int8, recording K7's wrapper inputs. Each distinct site shape is held bit for
bit against ``int8_conv_plain`` and timed with ``chip_smoke.kernel_ms`` (L2
flushed, mean of ``--reps``), with its plan, its bound, the bf16 cuDNN
convolution of the same shape and, at a 1x1 stride-1 site,
``torch._int_mm`` on the same int8 operands (``chip_smoke.int8_library_ms``:
library times, never used by the port).

``--parent-source`` also builds an earlier ``int8_conv.cu`` (the dp4a
version's launcher: ``..., ho, wo, stream, int* path``) with the package's flags,
holds it bit for bit against the current kernel and times it on the same
inputs in turns: parent, current, current, parent. ``--variants`` also
times, at each shape of one group, the other tile and split choices the
tensor-core kernel takes (each held bit for bit too), beside the plan's.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import int8_conv as k7
from maskrcnn_tf2_tpu_torch.models import layers
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

PARENT_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
                    ctypes.c_int)


def parent_kernel(source: str):
    """The earlier source built with the package's flags, as a function of
    ``int8_conv``'s arguments."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _build.BUILD_DIR / "parent-int8_conv.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), source], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    lib.int8_conv_launch.argtypes, lib.int8_conv_launch.restype = PARENT_SIGNATURE
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = [ctypes.c_int], ctypes.c_char_p

    def run(x, w, sx, sw, bias, stride, groups, dtype):
        n, h, wd, c = x.shape
        o, kh, kw, _ = w.shape
        top, _ = layers.same_pad_amounts(h, kh, stride)
        left, _ = layers.same_pad_amounts(wd, kw, stride)
        ho, wo = -(-h // stride), -(-wd // stride)
        y = torch.empty((n, ho, wo, o), dtype=dtype, device=x.device)
        path = ctypes.c_int(-1)
        status = lib.int8_conv_launch(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                                      None if bias is None else bias.data_ptr(), y.data_ptr(),
                                      0 if dtype == torch.float32 else 1, n, h, wd, c, o, kh, kw, stride, top, left,
                                      groups, ho, wo, torch.cuda.current_stream().cuda_stream, ctypes.byref(path))
        _build.check(lib, status, "parent int8_conv")
        return y

    return run


def site_calls(backbone: str, device, requests):
    """K7's inputs over one int8 request of 2 images on ``backbone``
    (``KEY+heads``: with ``quant_classifier`` and ``quant_mask_head``)."""
    key, _, heads = backbone.partition("+")
    cfg = cs.flagship_config().replace(backbone=key, quant_classifier=bool(heads), quant_mask_head=bool(heads))
    state = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(cs.SEED)).state_dict()
    batches = list(cs.request_batches(requests[:1], cfg))
    pred = cs.int8_predictor(cfg, state, batches, device)
    calls, _, launches = cs.capture_int8(pred, requests[0])
    return calls, launches


def variants(a, chosen, want, flush, reps):
    """The tensor-core kernel's other tiles and splits at one call's shape:
    each held against the plain version and timed; the text of their times."""
    x, w, sx, sw, bias, stride, groups, dtype = a
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    seen, out = {chosen}, []
    for tile in k7.TILES:
        for split in (0, 1, 2, 4):
            p = k7.plan(n, h, wd, c, o, kh, kw, stride, groups, tile=tile, split=split)
            if p in seen:
                continue
            seen.add(p)

            def run():
                return k7.int8_conv(x, w, sx, sw, bias, stride, groups, dtype, tile=tile, split=split)

            y = run()
            if k7.int8_conv.last_plan != p:
                raise AssertionError(f"{tuple(x.shape)} * {tuple(w.shape)}: asked for {p}, ran {k7.int8_conv.last_plan}")
            if not torch.equal(y, want):
                raise AssertionError(f"{tuple(x.shape)} * {tuple(w.shape)} under {p}: differs from the plain version")
            ms = cs.kernel_ms(run, reps, flush)
            out.append(f"{p.tile}/s{p.split} {ms:.4f}")
    return "variants " + ", ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", default=None)
    ap.add_argument("--backbone", nargs="*", default=["resnet50+heads", "resnext50", "mobilenetv2"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_int8_conv needs a CUDA card")
    device = torch.device("cuda")
    card = cs.card_line()
    cs.log(f"== {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build(["int8_conv"])
    parent = parent_kernel(args.parent_source) if args.parent_source else None
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)
    rs = np.random.RandomState(cs.SEED)
    requests = [[cs.smooth_image(rs, *hw) for hw in pair] for pair in cs.REQUEST_SIZES[:1]]
    current = k7.int8_conv
    for backbone in args.backbone:
        calls, launches = site_calls(backbone, device, requests)
        shapes = collections.OrderedDict()
        for a in calls:
            key = (tuple(a[0].shape), tuple(a[1].shape), a[5], a[6], a[4] is not None, a[7])
            shapes.setdefault(key, [a, 0])[1] += 1
        cs.log(f"== {backbone}: {launches} K7 launches a request of 2 images, {len(shapes)} shapes "
               f"(dtype {calls[0][7]})")
        tot = collections.Counter()
        for (xs, ws, stride, groups, _, dtype), (a, count) in shapes.items():
            x, w, sx, sw, bias = a[:5]
            want = k7.int8_conv_plain(*a)
            got = current(*a)
            p = k7.int8_conv.last_plan
            if not torch.equal(got, want):
                raise AssertionError(f"{xs} * {ws}: {int((got != want).sum())} values differ from the plain version")
            if parent is not None and not torch.equal(parent(*a), got):
                raise AssertionError(f"{xs} * {ws}: the parent kernel differs from the current one")
            n, h, wd, c = xs
            o, kh, kw, cg = ws
            ho, wo = -(-h // stride), -(-wd // stride)
            ops = 2.0 * n * ho * wo * o * kh * kw * cg
            nbytes = x.numel() + w.numel() + 4 * (1 + 2 * o) + n * ho * wo * o * cs.y_item(dtype)
            bound = max(ops / cs.INT8_OPS, nbytes / cs.HBM_BYTES_PER_S) * 1e3
            order = [("parent", parent), ("current", current), ("current", current), ("parent", parent)]
            ms = collections.defaultdict(list)
            for name, fn in order:
                if fn is not None:
                    ms[name].append(cs.kernel_ms(lambda: fn(*a), args.reps, flush))
            cudnn, int_mm = cs.int8_library_ms(x, w, stride, groups, flush, args.reps)
            cur = float(np.mean(ms["current"]))
            line = (f"  {xs} * {ws} /{stride} g{groups} x{count}: {p.kernel} tile {p.tile} vec {p.vec} grid "
                    f"{p.grid} split {p.split}: {'/'.join(f'{v:.4f}' for v in ms['current'])} ms")
            if parent is not None:
                line += f", parent {'/'.join(f'{v:.4f}' for v in ms['parent'])} ms"
            line += f", bound {bound:.4f} ({100 * bound / cur:.0f} %), bf16 cuDNN {cudnn:.4f}"
            if isinstance(int_mm, float):
                line += f", torch._int_mm {int_mm:.4f}"
                tot["int_mm_sites"] += cur * count
                tot["int_mm"] += int_mm * count
            if args.variants and groups == 1:
                line += "; " + variants(a, p, want, flush, args.reps)
            cs.log(line)
            tot["current"] += cur * count
            tot["parent"] += float(np.mean(ms["parent"])) * count if parent is not None else 0.0
            tot["bound"] += bound * count
            tot["cudnn"] += cudnn * count
            if groups > 1:
                tot["grouped"] += cur * count
                tot["grouped_parent"] += float(np.mean(ms["parent"])) * count if parent is not None else 0.0
        cs.log(f"== {backbone} K7 a request: {tot['current']:.4f} ms (parent {tot['parent']:.4f}), bound "
               f"{tot['bound']:.4f}, bf16 cuDNN {tot['cudnn']:.4f}; the 1x1 sites {tot['int_mm_sites']:.4f} against "
               f"torch._int_mm {tot['int_mm']:.4f}; grouped {tot['grouped']:.4f} (parent {tot['grouped_parent']:.4f})"
               f" ({card})")


if __name__ == "__main__":
    main()
