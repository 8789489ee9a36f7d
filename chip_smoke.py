#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and training step on one CUDA
card, on every backbone of the zoo, and hold its kernels against their plain
PyTorch versions.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- the card's name and power limit (nvidia-smi); no card, no run.
2. build    -- nvcc builds every kernel of the path from ``csrc/`` into
               ``maskrcnn_tf2_tpu_torch/_build/``, one process per source.
3. capture  -- one warm-up request through ``Predictor.detect`` at the flagship
               configuration (ResNet-50-FPN, 512x512, 81 classes, bf16,
               seeded random weights) records the inputs the path hands each
               kernel wrapper.
4. holds    -- each kernel against its plain version on those inputs (and on
               edge cases): NMS identical, also on chains across the scan's
               64-row chunks and on edge cases of its chunks (N not a multiple
               of 64, limit reached mid-chunk, N = 1, N < 64, limit > N, an
               image all invalid); ROIAlign within 1e-5 * max|feature| in
               float32 (TF32 off) and one bf16 ulp of max|feature| in bf16, at
               the 16-byte channel width of the path and at the scalar width
               (C = 36 in bf16, float32 maps 4 bytes off alignment). Times
               come from CUDA events with the L2 cache flushed before each
               launch.
5. serving  -- launch counts set to 0, then 4 requests of 2 uint8 images of
               other sizes than 512; latency, valid proposals and detections,
               peak memory; every kernel must have launched twice a request.
6. train capture -- one ``make_train_step`` step at the flagship's training
               configuration (batch 2, 2-8 seeded GT boxes per image, 56x56
               mini masks) records the inputs of ``greedy_nms``, ``roi_align``
               and ``roi_align_backward``: one, two and two calls.
7. holds, training -- the NMS and ROIAlign forward kernels against their
               plain versions on the captured training calls (2x6000 -> 2000
               at 0.7; 7x7 and 14x14 over 2x200 ROIs), timed with their bounds
               (``train_ms``, ``train_bound_ms``); then the ROIAlign backward
               kernel against its plain version
               on the captured 7x7 and 14x14 calls (bf16 within one bf16 ulp of
               max|plain|; float32 within 1e-5 * max|plain|, with zero-area,
               full-image and sliver boxes in front, where zero-area ROIs must
               leave the maps untouched), on boxes that straddle the kernel's
               tiles and on elongated ones, at the scalar width (C = 36, both
               dtypes) and on a float32 pyramid over 88 MiB (the TPU's second
               backward kernel's regime); every hold also launches twice and
               wants the same bits, and wants exact zeros, in maps from
               ``torch.empty`` over poisoned memory, wherever the plain maps
               are zero; the ROIs per tile and terms per pixel of the captured
               calls are printed; times as in 4.
8. tiny train cross-check -- one training step of a small float32 model,
               card against CPU, same weights and draws: losses within 1e-4
               relative with the batch norms on batch statistics and on their
               running averages, and in the latter every gradient leaf within
               1e-4 of its max plus the step's largest gradient.
9. train    -- launch counts set to 0, then 5 steps at full width: finite
               losses, ``grad_finite`` 1, parameters changed, each step one NMS,
               two forward and two backward ROIAlign launches; median step time
               over steps 2-5 and peak memory.
10. train_model -- the loop a user runs, at the flagship's widths (ResNet-50-FPN,
               512x512, bf16, batch 2, 2000 proposals, 200 ROIs per image,
               81 classes) from a dataset: 12 + 4 synthetic shapes images
               written as a COCO directory with COCO's 80 categories (the
               shapes are the first three; JPEG, RLE) and read back through
               ``CocoDataset``, device augmentation on (flip, zoom-out 0.25,
               photometric 0.2), a sample cache and checkpoints in a temporary
               directory; 2 epochs of 3 steps with validation. Holds: (a)
               launch counts set to 0, then exactly steps x (1, 2, 2) plus eval
               steps x (1, 2, 0) of (NMS, ROIAlign forward, backward); (b)
               finite losses and moved weights; (c) a best-only checkpoint on
               disk; (d) a SIGTERM sent from the metric writer mid-epoch
               leaves a preemption checkpoint, and resume runs to the end; (e)
               a run stopped at the epoch boundary resumes with the step
               count, the LR and the plateau state of the unbroken run. Prints
               the loader's images/s alone on the host, train_model's
               images/s, the share of the loop's time spent waiting on the
               loader and peak memory, each with the card line. The
               directory stays until phase 13 is done.
11. pretrained -- a seeded torchvision-keyed ResNet-50 ``state_dict`` saved to
               a ``.pth`` (``train/synthetic.py``) loads through
               ``create_train_state`` at the flagship's training config on the
               card: coverage 265/265 and every backbone entry equal to the
               file's bit for bit; then 2 training steps with launch counts
               set to 0: finite losses, ``grad_finite`` 1, exactly 1, 2 and 2
               launches a step of NMS, ROIAlign forward and backward.
12. evaluate -- phase 10's best checkpoint, put where ``cli/evaluate.py``
               looks for it, evaluated by ``cli.evaluate.main`` on the
               synthetic COCO val set, then through ``evaluate_dataset`` over
               ``detect`` and over ``detect_stream``: equal AP dicts, exactly
               2 NMS and 2 ROIAlign forward launches a batch of 2 on each
               route; ``detect_stream`` (batch 2, depth 2) equal to ``detect``
               over the same chunks, image for image; AP, seconds per image
               and images/s of both routes with the card line.
13. detect CLI -- ``cli.detect.main`` on 2 JPEGs it is handed, with ``--out``:
               the JSON equals ``Predictor.detect``'s results and the overlay
               PNGs exist; 2 NMS and 2 ROIAlign forward launches an image.
14. backbone zoo -- launch counts set to 0, then (a) ``seresnet34``,
               ``seresnext50``, ``senet154``, ``mobilenet``, ``mobilenetv2``
               and ``efficientnetb0`` at the flagship's serving and training
               configurations (512x512, 81 classes, bf16, 256-wide FPN and
               heads, seeded random weights): 2 requests of 2 images through
               ``Predictor.detect`` (exactly 2 NMS and 2 ROIAlign forward
               launches each) and 2 ``make_train_step`` steps of batch 2
               (exactly 1, 2, 2 launches each, finite losses, ``grad_finite``
               1, every weight moved); latency, step time and peak memory;
               (b) all 25 keys build on the card and serve one 256x256 image
               (2 and 2 launches), with their parameter counts
               (``utils/summary.py``) and latency; (c) seeded timm
               EfficientNet-B0 and torchvision MobileNetV2 files through
               ``create_train_state`` at full coverage, bit-equal to the
               file, then one step each (1, 2, 2); the counts are read here.
               (d) EfficientNet-B0 and SENet154's code at one block a stage
               in float32, card (channels_last, TF32 off) against CPU with
               the same weights: C1..C5 within 1e-4 of max |CPU|, on running
               averages and on batch statistics.
15. report  -- a ``{"kernels": [...]}`` line, the card line, and last the
               ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.cli import detect as cli_detect
from maskrcnn_tf2_tpu_torch.cli import evaluate as cli_evaluate
from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import image_io
from maskrcnn_tf2_tpu_torch.data.coco import COCO_CLASS_NAMES
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
from maskrcnn_tf2_tpu_torch.eval.coco_eval import evaluate_dataset
from maskrcnn_tf2_tpu_torch.export.inference import process_input
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import nms as nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as roi_kernel
from maskrcnn_tf2_tpu_torch.models.backbones.factory import backbone_names, get_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.pretrained import convert_torch_backbone
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import ResNet
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.ops import nms as nms_op
from maskrcnn_tf2_tpu_torch.ops import roi_align as roi_op
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.loop import train_model
from maskrcnn_tf2_tpu_torch.train.synthetic import (resnet_state_dict, shapes_coco_datasets, smooth_image,
                                                     synthetic_batch, timm_efficientnet_state_dict,
                                                     torchvision_mobilenet_v2_state_dict)
from maskrcnn_tf2_tpu_torch.train.train_step import _loss, create_train_state, make_train_step
from maskrcnn_tf2_tpu_torch.utils.summary import count_params
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
IOU_FLOPS = 13  # per box pair: 4 min/max, 2 sub, 2 clamps, 1 mul, 2 add/sub, 1 max, 1 div
REQUEST_SIZES = [((480, 640), (427, 640)), ((640, 480), (375, 500)),
                 ((600, 800), (333, 500)), ((720, 1280), (384, 512))]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def flagship_config() -> MaskRCNNConfig:
    return MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                          compute_dtype="bfloat16", detection_min_confidence=0.0)


def kernel_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each one timed on its
    own with CUDA events after the L2 cache was flushed. A ~1 ms sleep kernel
    runs between the flush and the start event, so the wrapper's host work is
    enqueued while the card is busy and the events bracket device time only
    (host work longer than the sleep, as in the plain versions, still counts)."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def nms_bound(boxes_s, valid_s, positions, out_valid):
    """(bytes time, operations time) in ms. Operations count the pairs greedy
    NMS must test on this data, up to the box that fills the limit: a kept box
    against every box kept before it, a suppressed one against one box."""
    b, n, _ = boxes_s.shape
    limit = positions.shape[1]
    pairs = 0
    for i in range(b):
        kept = positions[i][out_valid[i]].long().cpu()
        keep = torch.zeros(n, dtype=torch.long)
        keep[kept] = 1
        end = int(kept[-1]) + 1 if len(kept) == limit else n
        kept_before = torch.cumsum(keep, 0) - keep
        need = torch.where(keep.bool(), kept_before, torch.ones_like(keep))
        pairs += int((need[:end] * valid_s[i, :end].cpu().long()).sum())
    nbytes = b * n * (16 + 1) + b * limit * (4 + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, pairs * IOU_FLOPS / F32_FLOPS * 1e3


def summarize(max_abs_err, timings):
    """The kernels-line fields from per-call (kernel ms, plain ms, bytes time,
    operations time) tuples: times and bounds summed over the call sites."""
    k, p, bt, ot = zip(*timings)
    return dict(max_abs_err=max_abs_err, ms=sum(k), plain_ms=sum(p),
                bound_ms=sum(max(b, o) for b, o in zip(bt, ot)),
                bound_by="bytes" if sum(bt) >= sum(ot) else "operations")


def roi_bound(features, boxes, pool):
    b, n, _ = boxes.shape
    c = features[0].shape[-1]
    item = features[0].element_size()
    out_elems = b * n * pool * pool * c
    nbytes = sum(f.numel() for f in features) * item + boxes.numel() * 4 + out_elems * item
    return nbytes / HBM_BYTES_PER_S * 1e3, out_elems * 8 / F32_FLOPS * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def capture_inputs(predictor: Predictor, images):
    """One request through the real path, recording each wrapper's inputs."""
    calls = {"nms": [], "roi_align": []}

    def recorder(fn, key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)

        return wrapped

    with mock.patch.object(nms_op, "greedy_nms", recorder(nms_kernel.greedy_nms, "nms")), \
            mock.patch.object(roi_op, "roi_align", recorder(roi_kernel.roi_align, "roi_align")):
        predictor.detect(images)
    torch.cuda.synchronize()
    if len(calls["nms"]) != 2 or len(calls["roi_align"]) != 2:
        raise RuntimeError(f"expected 2 calls of each wrapper per request, saw "
                           f"{ {k: len(v) for k, v in calls.items()} }")
    return calls


def roi_like_boxes(rs, n):
    y1, x1 = rs.uniform(0, 0.7, (2, n))
    h, w = rs.uniform(0.01, 0.3, (2, n))
    return np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1).astype(np.float32)


def edge_boxes(boxes):
    """The path's boxes with zero-area, full-image, edge and extreme boxes in front."""
    extra = torch.tensor(
        [[0.0, 0.0, 1.0, 1.0], [0.3, 0.3, 0.3, 0.6], [0.0, 0.0, 0.0, 0.0],
         [0.0, 0.1, 1.0, 0.102], [0.5, 0.0, 0.5005, 1.0], [0.999, 0.999, 1.0, 1.0],
         [0.0, 0.97, 0.03, 1.0], [0.97, 0.0, 1.0, 0.03]],
        device=boxes.device,
    )
    b = boxes.shape[0]
    return torch.cat([extra[None].expand(b, -1, -1), boxes[:, : boxes.shape[1] - len(extra)]], 1).contiguous()


def staircases(rs, chains, steps, interleave):
    """Boxes [chains * steps, 4]: staircases of 0.3-wide boxes stepping 0.07 (each
    overlaps the next above 0.5, not the one after), chain by chain or
    interleaved row by row."""
    base = rs.uniform(0, 0.6, (chains, 2))
    y1 = base[:, None, 0] + 0.07 * np.arange(steps)[None, :]  # [chains, steps]
    x1 = np.repeat(base[:, 1:], steps, 1)
    if interleave:
        y1, x1 = y1.T, x1.T
    y1, x1 = y1.reshape(-1), x1.reshape(-1)
    return np.stack([y1, x1, y1 + 0.3, x1 + 0.3], -1).astype(np.float32)


def chain_case(device):
    """Staircases of equal boxes, each step overlapping the next above the
    threshold but not the one after it: greedy order alternates kept and
    suppressed along each chain, inside and across the scan's chunks."""
    rs = np.random.RandomState(SEED + 1)
    boxes = staircases(rs, 200, 30, False)[None]
    valid = rs.uniform(size=boxes.shape[:2]) > 0.05
    return torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)


def nms_edge_cases(device):
    """(name, boxes, valid, iou, limit) aimed at the scan's 64-row chunks."""
    rs = np.random.RandomState(SEED + 7)

    def case(name, boxes, limit, thr=0.5, valid=None):
        boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(device)
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool) if valid is None else torch.from_numpy(valid)
        return name, boxes, valid.to(device), thr, limit

    # the limit filled in the middle of a chunk, with kept rows after it there
    mid = np.stack([roi_like_boxes(rs, 1000) for _ in range(2)])
    pos, ok = nms_kernel.greedy_nms_plain(torch.from_numpy(mid), torch.ones((2, 1000), dtype=torch.bool), 0.5, 1000)
    kept = pos[0][ok[0]].tolist()
    stop = next(k for k in range(1, len(kept)) if kept[k] // 64 == kept[k - 1] // 64 >= 2
                and 16 <= kept[k - 1] % 64 <= 48)
    half_invalid = np.ones((2, 700), bool)
    half_invalid[1] = False
    return [
        case("N 1000, not a multiple of 64", mid, 1000),
        case(f"limit {stop} mid-chunk (row {kept[stop - 1]} of chunk {kept[stop - 1] // 64})", mid, stop),
        case("3 interleaved chains of 200 across 10 chunks", staircases(rs, 3, 200, True)[None], 1000),
        case("N 1", roi_like_boxes(rs, 2)[:, None], 1),
        case("N 1, limit 3", roi_like_boxes(rs, 2)[:, None], 3),
        case("N 50 < 64, limit 100", roi_like_boxes(rs, 50)[None], 100, 0.3),
        case("N 65", roi_like_boxes(rs, 65)[None], 100, 0.3),
        case("N 300, limit 1000 > N", roi_like_boxes(rs, 300)[None], 1000),
        case("image 1 all invalid", np.stack([roi_like_boxes(rs, 700) for _ in range(2)]), 100, 0.5, half_invalid),
    ]


def hold_nms(calls, flush, extra=()):
    """Kernel identical to plain on each call (timed, with its bound) and on
    each extra case (not timed); the summed times and bounds."""
    timings = []
    cases = [("path", *call[0]) for call in calls] + list(extra)
    for name, boxes_s, valid_s, thr, limit in cases:
        got = nms_kernel.greedy_nms(boxes_s, valid_s, thr, limit)
        want = nms_kernel.greedy_nms_plain(boxes_s, valid_s, thr, limit)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if not same:
            diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
            raise AssertionError(f"NMS kernel disagrees with its plain version ({name}, "
                                 f"{tuple(boxes_s.shape)}, iou {thr}): {diff} entries differ")
        kept = got[1].sum(1).tolist()
        line = f"  {name}: boxes {tuple(boxes_s.shape)} iou {thr} limit {limit} kept {kept}: identical"
        if name == "path":
            k = kernel_ms(lambda: nms_kernel.greedy_nms(boxes_s, valid_s, thr, limit), 20, flush)
            p = kernel_ms(lambda: nms_kernel.greedy_nms_plain(boxes_s, valid_s, thr, limit), 3, flush)
            bt, ot = nms_bound(boxes_s, valid_s, *got)
            timings.append((k, p, bt, ot))
            line += f"; kernel {k:.4f} ms, plain {p:.3f} ms, bound {max(bt, ot) * 1e3:.3f} us"
        log(line)
    return summarize(0.0, timings)  # any differing index or flag raised above


def hold_roi_align(calls, flush):
    """Kernel within one bf16 ulp of plain on each call, and within 1e-5 in
    float32 on the same maps with edge boxes in front; timed with its bound.
    Returns the error and the summed times and bounds."""
    err, timings = 0.0, []
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons in full float32
    torch.backends.cudnn.allow_tf32 = False
    for args, _ in calls:
        features, boxes, pool, image_shape = args[:4]
        features = [f.detach() for f in features]  # the training step's maps require grad
        scale = max(float(f.abs().max()) for f in features)
        # bf16, the path's dtype, on the path's boxes
        got = roi_kernel.roi_align(features, boxes, pool, image_shape)
        want = roi_kernel.roi_align_plain(features, boxes, pool, image_shape)
        torch.cuda.synchronize()
        e16 = float((got.float() - want.float()).abs().max())
        if not e16 <= 2.0**-8 * scale:
            raise AssertionError(f"ROIAlign bf16 error {e16} > 2^-8 * {scale} (pool {pool})")
        # f32 on the same maps, with zero-area and edge boxes in front
        f32 = [f.float().contiguous() for f in features]
        eboxes = edge_boxes(boxes)
        got32 = roi_kernel.roi_align(f32, eboxes, pool, image_shape)
        want32 = roi_kernel.roi_align_plain(f32, eboxes, pool, image_shape)
        torch.cuda.synchronize()
        e32 = float((got32 - want32).abs().max())
        if not e32 <= 1e-5 * scale:
            raise AssertionError(f"ROIAlign f32 error {e32} > 1e-5 * {scale} (pool {pool})")
        if got32[:, 1:3].abs().max() != 0:
            raise AssertionError("zero-area ROIs did not pool zeros")
        k = kernel_ms(lambda: roi_kernel.roi_align(features, boxes, pool, image_shape), 20, flush)
        p = kernel_ms(lambda: roi_kernel.roi_align_plain(features, boxes, pool, image_shape), 5, flush)
        bt, ot = roi_bound(features, boxes, pool)
        timings.append((k, p, bt, ot))
        err = max(err, e16)
        width = roi_kernel.vector_width(features, got)
        log(f"  {pool}x{pool}: boxes {tuple(boxes.shape)} maps {[tuple(f.shape) for f in features]} "
            f"{features[0].dtype}, {width} channels a thread: max err bf16 {e16:.3g}, f32 {e32:.3g} "
            f"(max|f| {scale:.3g}); kernel {k:.4f} ms, plain {p:.3f} ms, bound {max(bt, ot) * 1e3:.3f} us")
    return summarize(err, timings)


def hold_roi_scalar_width(device):
    """The forward kernel's scalar width against the plain version: C = 36 in
    bf16 (72-byte pixels) and float32 maps that start 4 bytes past a 16-byte
    boundary."""
    rs = np.random.RandomState(SEED + 8)
    boxes = torch.from_numpy(roi_like_boxes(rs, 600).reshape(2, 300, 4)).to(device)
    maps = [rs.normal(size=(2, 512 // s, 512 // s, 36)).astype(np.float32) for s in (4, 8, 16, 32)]
    bf16 = [torch.from_numpy(f).to(device, torch.bfloat16) for f in maps]
    unaligned = []
    for f in maps:
        buf = torch.empty(f.size + 1, device=device)
        unaligned.append(buf[1:].view(f.shape).copy_(torch.from_numpy(f)))
    for name, feats, tol in (("C 36 bf16", bf16, 2.0**-8), ("C 36 f32 off by 4 bytes", unaligned, 1e-5)):
        for pool in (7, 14):
            got = roi_kernel.roi_align(feats, boxes, pool, (512, 512))
            want = roi_kernel.roi_align_plain(feats, boxes, pool, (512, 512))
            torch.cuda.synchronize()
            width = roi_kernel.vector_width(feats, got)
            scale = max(float(f.abs().max()) for f in feats)
            e = float((got.float() - want.float()).abs().max())
            if width != 1 or not e <= tol * scale:
                raise AssertionError(f"ROIAlign scalar width ({name}, {pool}x{pool}): width {width}, error {e}")
            log(f"  scalar width, {name}, {pool}x{pool} over {tuple(boxes.shape)}: max err {e:.3g}")


def check_results(results, images, cfg):
    for img, r in zip(images, results):
        n = len(r["class_ids"])
        if n < 1:
            raise AssertionError("a served image got no detection")
        if r["masks"].shape != img.shape[:2] + (n,) or r["masks"].dtype != bool:
            raise AssertionError(f"mask shape {r['masks'].shape} for image {img.shape}")
        if not (np.all(np.isfinite(r["scores"])) and np.all((r["scores"] >= 0) & (r["scores"] <= 1))):
            raise AssertionError("scores outside [0, 1]")
        if not np.all((r["class_ids"] >= 1) & (r["class_ids"] < cfg.num_classes)):
            raise AssertionError("class id outside [1, num_classes)")
        rois = r["rois"]
        if np.any(rois[:, :2] < 0) or np.any(rois[:, 2] > img.shape[0]) or np.any(rois[:, 3] > img.shape[1]):
            raise AssertionError("box outside the image")


def tiny_cross_check(device):
    """A small float32 model with the same seeded weights on the card and on
    the CPU: the RPN scores agree, and so do the valid proposal counts."""
    cfg = MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(8, 16, 32, 64, 128),
                         backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64,
                         mask_conv_channels=64, pre_nms_limit=256, post_nms_rois_inference=64,
                         num_classes=3, compute_dtype="float32", detection_min_confidence=0.0)
    rs = np.random.RandomState(SEED + 2)
    img = torch.from_numpy(np.stack([smooth_image(rs, 128, 128) for _ in range(2)]))
    meta = torch.zeros((2, cfg.meta_size))
    meta[:, 7:11] = torch.tensor([0.0, 0.0, 128.0, 128.0])
    outs = []
    for dev in (device, torch.device("cpu")):
        m = lecun_init_(MaskRCNN(cfg, device=dev), torch.Generator().manual_seed(SEED))
        outs.append({k: v.cpu() for k, v in m(img.to(dev), meta.to(dev)).items()})
    gpu, cpu = outs
    rel = float((gpu["rpn_probs"] - cpu["rpn_probs"]).abs().max())
    if not rel <= 1e-4:
        raise AssertionError(f"tiny model: RPN scores differ by {rel} between card and CPU")
    counts = (gpu["rpn_rois_valid"].sum(1).tolist(), cpu["rpn_rois_valid"].sum(1).tolist())
    if counts[0] != counts[1] or not torch.isfinite(gpu["mrcnn_masks"]).all():
        raise AssertionError(f"tiny model: valid proposals {counts[0]} on the card, {counts[1]} on the CPU")
    log(f"== tiny float32 model, card vs CPU: RPN scores within {rel:.3g}, valid proposals {counts[0]}")


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def flagship_train_config() -> MaskRCNNConfig:
    """The flagship at the JAX package's training defaults: train_bn and
    train_bn_backbone, 56x56 mini masks, 2000 proposals, 200 ROIs per image
    at ratio 0.33, the slim mask head, adamax 1e-3, weight decay 2e-4, the
    loss guard."""
    return MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                          compute_dtype="bfloat16", batch_size=2)


def capture_train(device, steps_before=0):
    """The flagship's training state from the seed, after ``steps_before``
    training steps, and one more step through the real path, recording the
    inputs of each kernel wrapper: one NMS call, two ROIAlign forwards, two
    backwards. Returns ``(state, step, batch, gen, calls)``."""
    tcfg = flagship_train_config()
    gen = torch.Generator().manual_seed(SEED)
    state = create_train_state(tcfg, gen, device=device)
    step = make_train_step(tcfg)
    batch = synthetic_batch(tcfg, 2, SEED + 6, device)
    for _ in range(steps_before):
        state, _ = step(state, batch, rng=gen)
    calls = {"nms": [], "roi_align": [], "roi_align_backward": []}
    cotangents = []

    def recorder(fn, key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)

        return wrapped

    autograd_backward = roi_op.PyramidRoIAlign.backward

    def backward(ctx, dout):
        cotangents.append(f"{tuple(dout.shape)} strides {dout.stride()} contiguous {dout.is_contiguous()}")
        return autograd_backward(ctx, dout)

    with mock.patch.object(nms_op, "greedy_nms", recorder(nms_kernel.greedy_nms, "nms")), \
            mock.patch.object(roi_op, "roi_align", recorder(roi_kernel.roi_align, "roi_align")), \
            mock.patch.object(roi_op, "roi_align_backward",
                              recorder(roi_kernel.roi_align_backward, "roi_align_backward")), \
            mock.patch.object(roi_op.PyramidRoIAlign, "backward", staticmethod(backward)):
        state, _ = step(state, batch, rng=gen)
    torch.cuda.synchronize()
    log("  cotangents as autograd hands them to PyramidRoIAlign.backward: " + "; ".join(cotangents))
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"nms": 1, "roi_align": 2, "roi_align_backward": 2}:
        raise RuntimeError(f"a training step called the wrappers {counts} times; expected 1, 2, 2")
    return state, step, batch, gen, calls


def bwd_bound(dout, boxes, level_hw):
    """Bytes: the cotangent and the boxes read once, the gradient maps written
    once in the cotangent's dtype. Operations: 4 multiplies and 4 adds per
    cotangent element."""
    item = dout.element_size()
    b, c = dout.shape[0], dout.shape[-1]
    nbytes = dout.numel() * item + boxes.numel() * 4 + sum(b * h * w * c for h, w in level_hw) * item
    return nbytes / HBM_BYTES_PER_S * 1e3, dout.numel() * 8 / F32_FLOPS * 1e3


def hold_backward_case(name, dout, boxes, level_hw, image_shape):
    """Kernel against plain: one bf16 ulp of max|plain| in bf16, 1e-5 * max|plain|
    in float32. Two launches give the same bits. The kernel's maps come from
    ``torch.empty`` over memory just filled with NaNs, and are exactly zero
    wherever the plain maps are (no ROI reaches there)."""
    want = roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape)
    poison = torch.full((sum(w.numel() for w in want),), float("nan"), dtype=dout.dtype, device=dout.device)
    del poison  # the allocator hands this block to the next torch.empty of its size
    got = roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    again = roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    torch.cuda.synchronize()
    scale = max(float(w.float().abs().max()) for w in want)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    tol = 1e-5 * scale if dout.dtype == torch.float32 else 2.0**-8 * scale
    if not err <= tol:
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}) error {err} > {tol}")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}): two launches differ")
    if not all(bool((g[w == 0] == 0).all()) for g, w in zip(got, want)):
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}): a pixel no ROI reaches is not zero")
    return err, scale


def backward_work(boxes, level_hw, p, image_shape):
    """What the owner-computes kernel finds on these boxes: the ROIs each of
    its tiles keeps (level and footprint filter) and the corner terms each
    pixel sums, as distributions."""
    th, tw = roi_kernel.BACKWARD_TILE
    idx, _, valid = roi_kernel._geometry(level_hw, boxes.cpu(), p, image_shape, 244.0)
    b = idx.shape[0]
    total = sum(h * w for h, w in level_hw)
    terms = torch.bincount((idx + torch.arange(b)[:, None, None, None, None] * total)[valid].reshape(-1),
                           minlength=b * total).float()
    offsets = np.cumsum([0] + [h * w for h, w in level_hw])
    tiles = [torch.zeros((b, -(-h // th), -(-w // tw))) for h, w in level_hw]
    first, last = idx[:, :, 0, 0, 0], idx[:, :, -1, -1, 3]  # corner 00 of the first sample, 11 of the last
    for img, roi in valid.nonzero().tolist():
        level = int(np.searchsorted(offsets, int(first[img, roi]), side="right")) - 1
        w = level_hw[level][1]
        lo, hi = int(first[img, roi]) - offsets[level], int(last[img, roi]) - offsets[level]
        tiles[level][img, lo // w // th : hi // w // th + 1, lo % w // tw : hi % w // tw + 1] += 1
    per_tile = torch.cat([t.reshape(-1) for t in tiles])

    def dist(v):
        q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99])).tolist()
        return (f"mean {float(v.mean()):.2f}, median {q[0]:.0f}, 90th {q[1]:.0f}, 99th {q[2]:.0f}, "
                f"max {float(v.max()):.0f}, zero {float((v == 0).float().mean()):.3f}")

    by_level = ", ".join(f"{float(t.mean()):.2f}/{float(t.max()):.0f}" for t in tiles)
    return (f"ROIs per {th}x{tw} tile ({len(per_tile)} tiles): {dist(per_tile)}; mean/max by level {by_level}; "
            f"corner terms per pixel: {dist(terms)}")


def backward_shape_cases(device):
    """(name, dout, boxes): boxes aimed at the kernel's tiles on the flagship's
    512x512 pyramid (samples straddling tile borders in both axes; 512x12-pixel
    boxes, the finest level, 128 pixels one way) at C = 256, and ROI-like boxes
    at C = 36, the scalar width in bf16; both dtypes each."""
    rs = np.random.RandomState(SEED + 9)
    lo, hi = 2.5 / 127, 9.5 / 127  # pixels 2.5 .. 9.5 of the 128x128 map
    aimed = np.array([[lo, lo, hi, hi], [lo, 0.0, hi, 6.0 / 127], [0.0, 0.5, 1.0, 0.5 + 12 / 512],
                      [0.25, 0.0, 0.25 + 12 / 512, 1.0]], np.float32)
    boxes = np.stack([np.concatenate([aimed, roi_like_boxes(rs, 60)]) for _ in range(2)])
    cases = []
    for name, bx, p, c in (("tile-straddling and elongated boxes", boxes, 14, 256),
                           ("C 36, 7x7", roi_like_boxes(rs, 600).reshape(2, 300, 4), 7, 36),
                           ("C 36, 14x14", roi_like_boxes(rs, 600).reshape(2, 300, 4), 14, 36)):
        dout = torch.from_numpy(rs.normal(size=bx.shape[:2] + (p, p, c)).astype(np.float32)).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((name, dout.to(dtype), torch.from_numpy(bx).to(device)))
    return cases


def hold_roi_backward(calls, flush):
    log("== holds: pyramid ROIAlign backward kernel (csrc/roi_align.cu) vs roi_align_backward_plain")
    err, timings = 0.0, []
    for args, _ in calls:
        dout, boxes, level_hw, image_shape = args[:4]
        p = dout.shape[2]
        e16, scale = hold_backward_case(f"{p}x{p}", dout, boxes, level_hw, image_shape)
        # float32, with zero-area, full-image, edge and sliver boxes in front
        eboxes = edge_boxes(boxes)
        d32 = dout.float().contiguous()
        e32, _ = hold_backward_case(f"{p}x{p} edge boxes", d32, eboxes, level_hw, image_shape)
        empty = torch.zeros_like(d32)
        empty[:, 1:3] = d32[:, 1:3]  # the zero-height and the all-zero box
        if any(float(g.abs().max()) != 0 for g in roi_kernel.roi_align_backward(empty, eboxes, level_hw, image_shape)):
            raise AssertionError("zero-area ROIs changed the gradient maps")
        k = kernel_ms(lambda: roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape), 20, flush)
        pl = kernel_ms(lambda: roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape), 3, flush)
        bt, ot = bwd_bound(dout, boxes, level_hw)
        timings.append((k, pl, bt, ot))
        err = max(err, e16)
        log(f"  {p}x{p}: dout {tuple(dout.shape)} {dout.dtype} maps {list(level_hw)}: max err bf16 {e16:.3g} "
            f"(max|grad| {scale:.3g}), f32 {e32:.3g}; kernel {k:.4f} ms, plain {pl:.3f} ms, "
            f"bound {max(bt, ot) * 1e3:.3f} us")
        log(f"  {p}x{p}: {backward_work(boxes, level_hw, p, image_shape)}")
    level_hw = [(512 // s, 512 // s) for s in (4, 8, 16, 32)]
    for name, dout, boxes in backward_shape_cases(dout.device):
        e, scale = hold_backward_case(name, dout, boxes, level_hw, (512, 512))
        log(f"  {name}: dout {tuple(dout.shape)} {dout.dtype}: max err {e:.3g} (max|grad| {scale:.3g})")
    # the TPU falls back to its read-modify-write kernel above 88 MiB of float32
    # pyramid per image; 1024x1024 is 85 MiB, so 1152x1152 (108 MiB)
    rs = np.random.RandomState(SEED + 3)
    level_hw = [(1152 // s, 1152 // s) for s in (4, 8, 16, 32)]
    mib = sum(h * w for h, w in level_hw) * 256 * 4 / 2**20
    boxes = torch.from_numpy(roi_like_boxes(rs, 200)[None]).to(dout.device)
    big = torch.from_numpy(rs.normal(size=(1, 200, 14, 14, 256)).astype(np.float32)).to(dout.device)
    e_big, _ = hold_backward_case("1152x1152", big, boxes, level_hw, (1152, 1152))
    e_big16, _ = hold_backward_case("1152x1152", big.to(torch.bfloat16), boxes, level_hw, (1152, 1152))
    k = kernel_ms(lambda: roi_kernel.roi_align_backward(big, boxes, level_hw, (1152, 1152)), 10, flush)
    pl = kernel_ms(lambda: roi_kernel.roi_align_backward_plain(big, boxes, level_hw, (1152, 1152)), 3, flush)
    bound = max(bwd_bound(big, boxes, level_hw))
    log(f"  pyramid of {mib:.1f} MiB f32 per image (1152x1152, batch 1, 14x14 over 200 ROIs): "
        f"max err f32 {e_big:.3g}, bf16 {e_big16:.3g}; f32 kernel {k:.4f} ms, plain {pl:.3f} ms, "
        f"bound {bound * 1e3:.3f} us")
    log("  library: no single PyTorch call computes the ROIAlign backward (torchvision is absent)")
    return summarize(err, timings)


def _tiny_train_losses_and_grads(cfg, batch, draws, dev):
    model = lecun_init_(MaskRCNN(cfg, device=dev), torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # spread the RPN scores: saturated scores tie in the top-k
        model.rpn.rpn_class_raw.weight.mul_(0.1)
    total, losses = _loss(model, {k: v.to(dev) for k, v in batch.items()},
                          {k: v.to(dev) for k, v in draws.items()}, cfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: g.cpu() for n, g in zip(names, grads) if g is not None})


def tiny_train_cross_check(device):
    """One training step of a small float32 model on the card and on the CPU,
    same weights, batch and draws: every loss within 1e-4 relative, with the
    batch norms on batch statistics (the default) and on their running
    averages; in the latter, every gradient leaf within 1e-4 * (its max + the
    step's largest gradient), the tolerance of the CPU parity test against
    the JAX package. At random weights the gradients are not smooth in the
    inputs (ReLU and max-pool switches, nearly constant channels under batch
    statistics: tests/torch_port_conditioning.py), so card and CPU, which sum
    in other orders, may differ by percents on a few leaves; with batch
    statistics only the losses are held, and the leaf check runs on the
    running averages, where this scene agrees closely."""
    base = MaskRCNNConfig(image_shape=(128, 128, 3), rpn_anchor_scales=(32, 48, 64, 96, 128),
                          backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64,
                          mask_conv_channels=64, pre_nms_limit=256, post_nms_rois_training=64,
                          train_rois_per_image=32, max_gt_instances=8, num_classes=3, compute_dtype="float32")
    batch = synthetic_batch(base, 2, SEED + 4, "cpu")
    draws = draw_uniforms(base, 2, torch.Generator().manual_seed(SEED + 5), "cpu")
    for cfg in (base, base.replace(train_bn=False, train_bn_backbone=False)):
        (l_gpu, g_gpu), (l_cpu, g_cpu) = (_tiny_train_losses_and_grads(cfg, batch, draws, dev)
                                          for dev in (device, torch.device("cpu")))
        worst_loss = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12) for k, v in l_cpu.items())
        if not worst_loss <= 1e-4:
            raise AssertionError(f"tiny train step: losses differ by {worst_loss} between card and CPU: "
                                 f"{l_gpu} {l_cpu}")
        if set(g_gpu) != set(g_cpu):
            raise AssertionError("tiny train step: different parameters got gradients on the card and the CPU")
        gmax = max(float(g.abs().max()) for g in g_cpu.values())
        err = {n: float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()}
        leaf = {n: err[n] / max(float(g.abs().max()), 1e-30) for n, g in g_cpu.items()}
        step = {n: err[n] / (float(g.abs().max()) + gmax) for n, g in g_cpu.items()}
        worst_leaf, worst_step = max(leaf, key=leaf.get), max(step, key=step.get)
        if not cfg.train_bn and step[worst_step] > 1e-4:
            raise AssertionError(f"tiny train step: gradient of {worst_step} differs by {err[worst_step]} "
                                 f"between card and CPU (leaf max + step max {err[worst_step] / step[worst_step]})")
        log(f"== tiny float32 train step (batch norms on {'batch statistics' if cfg.train_bn else 'running averages'}),"
            f" card vs CPU: losses within {worst_loss:.3g} relative (mask loss {l_cpu['mrcnn_mask_loss']:.4f});"
            f" gradients within {step[worst_step]:.3g} of (leaf max + step max) at worst ({worst_step}),"
            f" {leaf[worst_leaf]:.3g} of the leaf's max ({worst_leaf})")


def run_training(state, step, batch, gen, card):
    log("== train: 5 steps, flagship training config (ResNet-50-FPN, 512, 81 classes, bf16, batch 2)")
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    roi_kernel.roi_align_backward.launches = 0
    times = []
    for i in range(5):
        start = time.perf_counter()
        state, losses = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        values = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1.0:
            raise AssertionError(f"train step {i}: {values}")
        log(f"  step {i}: loss_sum {values['loss_sum']:.4f} "
            + " ".join(f"{k} {v:.4g}" for k, v in values.items() if k.endswith("_loss"))
            + f"; {times[-1]:.1f} ms")
    launches = {"nms": nms_kernel.greedy_nms.launches, "roi_align": roi_kernel.roi_align.launches,
                "roi_align_backward": roi_kernel.roi_align_backward.launches}
    if launches != {"nms": 5, "roi_align": 10, "roi_align_backward": 10}:
        raise AssertionError(f"5 steps launched {launches}; expected 5, 10, 10")
    names = [n for n, _ in state.model.named_parameters()]
    unchanged = [n for n, p, q in zip(names, state.model.parameters(), before)
                 if n.endswith("weight") and torch.equal(p.detach(), q)]
    if unchanged:
        raise AssertionError(f"weights unchanged after 5 steps: {unchanged}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    if not all(p.dtype == torch.float32 for p in state.model.parameters()):
        raise AssertionError("the master weights are not float32")
    log(f"  median step {float(np.median(times[1:])):.1f} ms over steps 2-5; peak memory {peak:.0f} MiB; "
        f"launches {launches}; float32 master weights ({card})")
    return launches


# ---------------------------------------------------------------------------
# train_model from a dataset
# ---------------------------------------------------------------------------


def launch_counts():
    return (nms_kernel.greedy_nms.launches, roi_kernel.roi_align.launches, roi_kernel.roi_align_backward.launches)


def zero_launch_counts():
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    roi_kernel.roi_align_backward.launches = 0


class Stop(Exception):
    """Ends a run at the first step of its second epoch, as a crash would."""


def shapes_datasets(root):
    """12 training and 4 validation images of 512x512 synthetic shapes,
    through a COCO directory with COCO's 80 categories."""
    sets = shapes_coco_datasets(root, (12, 4), 512, SEED + 10, class_names=COCO_CLASS_NAMES)
    log(f"  dataset: {len(sets[0])} + {len(sets[1])} images of 512x512 shapes written as COCO (JPEG, RLE; the "
        f"shapes are 3 of its 80 categories) under a temporary directory and read back through CocoDataset")
    return sets


def run_train_model(device, card, root):
    """Phase 10 (see the module's docstring), in ``root``. Returns the launch
    counts of the main run, its configuration and the validation set."""
    log("== train_model: ResNet-50-FPN, 512x512, bf16, batch 2, 81 classes from the dataset, device augmentation, "
        "2 epochs of 3 steps with validation")
    train, val = shapes_datasets(os.path.join(root, "coco"))
    cfg = flagship_train_config().replace(
        num_classes=train.num_classes, epochs=2, log_per_steps=1, augment_on_device=True,
        augment_scale_jitter=0.25, augment_photometric=0.2, reduce_lr_patience=1, reduce_lr_factor=0.5,
        sample_cache_dir=os.path.join(root, "cache"), checkpoints_dir=os.path.join(root, "ckpt"))
    steps = 3

    # the loader alone on the host: decoding, resizing, mini masks, collation
    start = time.perf_counter()
    n_images = sum(len(b["images"]) for b in DataLoader(train, cfg.replace(sample_cache_dir=None)).epoch())
    loader_ips = n_images / (time.perf_counter() - start)

    def run(base, **kw):
        state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
        history = []
        state = train_model(cfg, train, val, state=state, checkpoint_base=os.path.join(root, base),
                            steps_per_epoch=steps, rng_seed=SEED, history=history, **kw)
        return state, history

    # (a), (b), (c): the main run
    state = create_train_state(cfg, torch.Generator().manual_seed(SEED), device=device)
    before = [p.detach().clone() for p in state.model.parameters()]
    losses = []
    history = []
    eval_steps = cfg.epochs * sum(1 for _ in DataLoader(val, cfg, shuffle=False).epoch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    start = time.perf_counter()
    state = train_model(cfg, train, val, state=state, checkpoint_base=os.path.join(root, "main"),
                        steps_per_epoch=steps, rng_seed=SEED, history=history,
                        metric_writer=lambda step, values: losses.append(values))
    wall = time.perf_counter() - start
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_steps = sum(h["steps"] for h in history)
    want = (n_steps + eval_steps, 2 * n_steps + 2 * eval_steps, 2 * n_steps)
    if n_steps != cfg.epochs * steps or launches != want:
        raise AssertionError(f"train_model: {n_steps} steps, {eval_steps} eval steps launched (NMS, ROIAlign, "
                             f"backward) = {launches}; expected {want}")
    if not all(np.isfinite(v) for values in losses for v in values.values()) or \
            not all(np.isfinite(v) for h in history for k, v in h.items() if "loss" in k):
        raise AssertionError(f"train_model: a loss is not finite: {losses} {history}")
    names = [n for n, _ in state.model.named_parameters()]
    unchanged = [n for n, p, q in zip(names, state.model.parameters(), before)
                 if n.endswith("weight") and torch.equal(p.detach(), q)]
    if unchanged:
        raise AssertionError(f"train_model: weights unchanged: {unchanged}")
    manager = ckpt_lib.make_manager(cfg, os.path.join(root, "main"))
    files = sorted(f for f in os.listdir(manager.directory) if f.endswith(".pt"))
    if manager.all_steps() != [0, 1] or len(files) != 2 or cfg.save_best_only is not True:
        raise AssertionError(f"train_model: best-only checkpoints {manager.all_steps()}, files {files}")
    log(f"  (a) {n_steps} steps and {eval_steps} eval steps launched NMS, ROIAlign forward, backward "
        f"{launches} times, as expected; (b) finite losses (val_loss_sum by epoch "
        f"{[round(h['val_loss_sum'], 4) for h in history]}), every weight moved; (c) best-only checkpoints "
        f"of epochs {manager.all_steps()} on disk, ranked by val_loss_sum "
        f"{[round(manager.metrics(e)['val_loss_sum'], 4) for e in manager.all_steps()]}")
    final = {"step": state.step, "lr": state.opt_state.hyperparams["learning_rate"],
             "weights": [p.detach().clone() for p in state.model.parameters()]}
    del state, before

    # (d) the SIGTERM drill
    def send_sigterm(step, values):
        if step == 2:  # the second step of epoch 1
            os.kill(os.getpid(), signal.SIGTERM)

    state, _ = run("drill", metric_writer=send_sigterm)
    pre = ckpt_lib.make_preempt_manager(cfg, os.path.join(root, "drill"))
    if state.step != 2 or pre.all_steps() != [0] or ckpt_lib.make_manager(cfg, os.path.join(root, "drill")).all_steps():
        raise AssertionError(f"SIGTERM drill: stopped at step {state.step}, preemption checkpoints {pre.all_steps()}")
    state, _ = run("drill")
    if state.step != 2 + steps:
        raise AssertionError(f"SIGTERM drill: resumed to step {state.step}, expected {2 + steps}")
    log(f"  (d) SIGTERM at step 2 left a preemption checkpoint of epoch 0 (step 2); resume ran epoch 2 to "
        f"step {state.step}")
    del state

    # (e) a run stopped at the epoch boundary, then resumed
    def crash(step, values):
        if step == steps + 1:
            raise Stop

    try:
        run("boundary", metric_writer=crash)
        raise AssertionError("the boundary run did not stop")
    except Stop:
        pass
    saved = ckpt_lib.make_manager(cfg, os.path.join(root, "boundary"))
    extra = saved.restore(0, "cpu")["extra"]
    state, resumed = run("boundary")
    lr = state.opt_state.hyperparams["learning_rate"]
    unbroken_extra = manager.restore(1, "cpu")["extra"]
    resumed_extra = saved.restore(1, "cpu")["extra"]
    if (state.step, lr) != (final["step"], final["lr"]) or resumed_extra["bad_epochs"] != unbroken_extra["bad_epochs"] \
            or resumed_extra["lr"] != unbroken_extra["lr"] or len(resumed) != 1:
        raise AssertionError(f"epoch-boundary resume: step {state.step}, lr {lr}, plateau {resumed_extra}; the "
                             f"unbroken run: step {final['step']}, lr {final['lr']}, plateau {unbroken_extra}")
    diff = max(float((p.detach() - q).abs().max()) for p, q in zip(state.model.parameters(), final["weights"]))
    log(f"  (e) stopped at step {steps + 1}, resumed from epoch 0's checkpoint (step {steps}, plateau {extra}): "
        f"step {state.step}, lr {lr:g}, plateau {resumed_extra}, as the unbroken run's (plateau "
        f"{unbroken_extra}); weights within {diff:.3g} of the unbroken run's")
    del state, final

    step_ips = [h["steps"] * cfg.batch_size / h["train_seconds"] for h in history]
    wait = [h["loader_wait_s"] / h["train_seconds"] for h in history]
    log(f"  loader alone on the host (JPEG decode, resize, mini masks, batches of 2, no cache): "
        f"{loader_ips:.2f} images/s ({card})")
    log(f"  train_model: {step_ips[-1]:.2f} images/s over epoch 2's training steps ({step_ips[0]:.2f} in epoch "
        f"1, its first step included); with validation and checkpoint {history[-1]['images_per_s']:.2f} and "
        f"{history[0]['images_per_s']:.2f} images/s; {wall:.1f} s for the run ({card})")
    log(f"  loader wait: {wait[-1]:.4f} of epoch 2's training time, {wait[0]:.4f} of epoch 1's ({card})")
    log(f"  peak memory {peak:.0f} MiB in train_model ({card})")
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches)), cfg, val


# ---------------------------------------------------------------------------
# pretrained weights, evaluation and the CLIs
# ---------------------------------------------------------------------------


def run_pretrained(device, card, root):
    """Phase 11: fine-tune from a torchvision-keyed ResNet-50 file. Returns the
    launch counts of its 2 steps."""
    log("== pretrained: a seeded torchvision-keyed ResNet-50 state_dict into the flagship's training state")
    path = os.path.join(root, "resnet50.pth")
    sd = resnet_state_dict("resnet50", SEED + 12)
    torch.save(sd, path)
    mib = os.path.getsize(path) / 2**20
    tcfg = flagship_train_config().replace(backbone_init_weights=path)
    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        state = create_train_state(tcfg, torch.Generator().manual_seed(SEED), device=device)
    load_s = time.perf_counter() - start
    coverage = printed.getvalue().strip()
    if "265/265 leaves" not in coverage:
        raise AssertionError(f"pretrained coverage: {coverage!r}; expected 265/265")
    got = state.model.state_dict()
    differ = [k for k, v in convert_torch_backbone(sd).items() if not torch.equal(got["backbone." + k].cpu(), v)]
    if differ or len(convert_torch_backbone(sd)) != 265:
        raise AssertionError(f"pretrained: backbone entries differ from the file's: {differ[:5]}")
    step = make_train_step(tcfg)
    batch = synthetic_batch(tcfg, 2, SEED + 6, device)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    zero_launch_counts()
    losses = []
    for i in range(2):
        state, values = step(state, batch, rng=gen)
        losses.append({k: float(v) for k, v in values.items()})
        if not all(np.isfinite(v) for v in losses[-1].values()) or losses[-1]["grad_finite"] != 1.0:
            raise AssertionError(f"pretrained step {i}: {losses[-1]}")
    launches = launch_counts()
    if launches != (2, 4, 4):
        raise AssertionError(f"2 fine-tune steps launched (NMS, ROIAlign, backward) = {launches}; expected (2, 4, 4)")
    log(f"  {coverage} ({mib:.1f} MiB file, create_train_state {load_s:.2f} s); every backbone entry equals the "
        f"file's bit for bit; 2 steps: loss_sum {[round(v['loss_sum'], 4) for v in losses]}, grad_finite 1, "
        f"launches {launches} ({card})")
    del state, step, batch
    torch.cuda.empty_cache()
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches))


def rehome_checkpoint(src_cfg, src_base, dst_cfg):
    """Save the best of ``src_cfg``'s checkpoints where ``dst_cfg``'s manager
    (a CLI's) looks for it; returns the model's state_dict."""
    src = ckpt_lib.make_manager(src_cfg, src_base)
    best = min(src.all_steps(), key=lambda e: src.metrics(e)["val_loss_sum"])
    payload = src.restore(best, "cpu")
    ckpt_lib.make_manager(dst_cfg).save(best, payload, src.metrics(best))
    return payload["model"]


def images_per_s(fn, images):
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn(images)
    return len(images) / (time.perf_counter() - start)


def run_evaluate(device, card, root, train_cfg, val):
    """Phase 12. Returns the launch counts of the ``detect`` and the
    ``detect_stream`` routes and the CLI configuration's state_dict."""
    log("== evaluate: phase 10's best checkpoint through cli.evaluate, evaluate_dataset over detect and over "
        "detect_stream (batch 2, depth 2)")
    size = train_cfg.image_shape[0]
    cfg = cli_evaluate.coco_config(backbone=train_cfg.backbone, num_classes=81, image_shape=(size, size, 3),
                                   image_min_dim=size, image_max_dim=size, batch_size=2,
                                   checkpoints_dir=os.path.join(root, "cli"))
    state_dict = rehome_checkpoint(train_cfg, os.path.join(root, "main"), cfg)
    out = os.path.join(root, "ap.json")
    batches = -(-len(val) // cfg.batch_size)
    routes = {}
    for name, run in (
        ("cli", lambda: cli_evaluate.main(["--dataset_path", os.path.join(root, "coco"), "--backbone", cfg.backbone,
                                           "--img_size", str(size), "--batch_size", "2", "--checkpoints_dir",
                                           cfg.checkpoints_dir, "--out", out, "--device", device.type])),
        ("detect", lambda: evaluate_dataset(predictor, val, cfg, verbose=False)),
        ("stream", lambda: evaluate_dataset(predictor, val, cfg, verbose=False, stream_depth=2)),
    ):
        printed = io.StringIO()
        torch.cuda.synchronize()
        zero_launch_counts()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats = run()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        if launches != (2 * batches, 2 * batches, 0):
            raise AssertionError(f"evaluate ({name}): {batches} batches launched (NMS, ROIAlign, backward) = "
                                 f"{launches}; expected 2, 2, 0 a batch")
        if name == "cli":
            if "WARNING" in printed.getvalue():
                raise AssertionError("cli.evaluate found no checkpoint")
            predictor = Predictor(cfg, state_dict, device=device)
        routes[name] = (stats, seconds, launches)
    dicts = {name: json.dumps(r[0], sort_keys=True) for name, r in routes.items()}
    with open(out) as f:
        written = json.dumps(json.load(f), sort_keys=True)
    if len(set(dicts.values())) != 1 or written != dicts["cli"]:
        raise AssertionError(f"evaluate: the AP dicts differ: {dicts}, written {written}")
    for kind, stats in routes["cli"][0].items():
        if not all(0.0 <= v <= 1.0 for k, v in stats.items() if not (k.startswith("AP_") and np.isnan(v))):
            raise AssertionError(f"evaluate: {kind} stats outside [0, 1]: {stats}")
    ap = {k: {m: round(v, 4) for m, v in d.items()} for k, d in routes["cli"][0].items()}
    log(f"  {len(val)} images, {batches} batches of 2: the CLI's, detect's and detect_stream's AP dicts equal: {ap}")
    log(f"  launches (NMS, ROIAlign forward, backward) per route: {routes['detect'][2]}; seconds per image: CLI "
        f"{routes['cli'][1] / len(val):.3f} (restore and model build included), evaluate_dataset over detect "
        f"{routes['detect'][1] / len(val):.3f}, over detect_stream {routes['stream'][1] / len(val):.3f} ({card})")

    # detect_stream against detect over the same chunks, image for image, and
    # their rates in turns (detect, stream, stream, detect)
    images = [val.load_image(i % len(val)) for i in range(8)]
    want = [r for k in range(0, len(images), 2) for r in predictor.detect(images[k:k + 2])]
    got = list(predictor.detect_stream(images, batch_size=2, depth=2))
    for g, w in zip(got, want):
        if g.keys() != w.keys() or not all(np.array_equal(g[k], w[k]) for k in w):
            raise AssertionError("detect_stream differs from detect over the same chunks")
    rates = {"detect": [], "stream": []}
    for name in ("detect", "stream", "stream", "detect"):
        if name == "detect":
            rates[name].append(images_per_s(lambda ims: [predictor.detect(ims[k:k + 2]) for k in range(0, 8, 2)],
                                            images))
        else:
            rates[name].append(images_per_s(lambda ims: list(predictor.detect_stream(ims, 2, 2)), images))
    log(f"  detect_stream equals detect over the same chunks on {len(images)} images "
        f"({sum(len(r['class_ids']) for r in got)} detections at detection_min_confidence "
        f"{cfg.detection_min_confidence}); images/s at batch 2: detect {rates['detect']}, detect_stream (depth 2) "
        f"{rates['stream']} ({card})")
    return routes["detect"][2], routes["stream"][2], cfg, state_dict


def run_detect_cli(device, card, root, eval_cfg, state_dict):
    """Phase 13: ``cli.detect.main`` on 2 JPEGs, against ``Predictor.detect``."""
    log("== detect CLI: 2 JPEGs, --out")
    size = eval_cfg.image_shape[0]
    cfg = cli_detect.MaskRCNNConfig(backbone=eval_cfg.backbone, num_classes=81, image_shape=(size, size, 3),
                                    image_min_dim=size, image_max_dim=size,
                                    checkpoints_dir=os.path.join(root, "cli_detect"))
    ckpt_lib.make_manager(cfg).save(0, {"step": 0, "model": state_dict, "opt_state": {
        "count": 0, "hyperparams": {}, "slots": {}}}, {"val_loss_sum": 0.0})
    rs = np.random.RandomState(SEED + 13)
    paths = []
    for i, hw in enumerate(((480, 640), (375, 500))):
        paths.append(os.path.join(root, f"request_{i}.jpg"))
        image_io.imwrite(paths[-1], smooth_image(rs, *hw))
    out = os.path.join(root, "detect_out")
    printed = io.StringIO()
    torch.cuda.synchronize()
    zero_launch_counts()
    with contextlib.redirect_stdout(printed):
        cli_detect.main(["--backbone", cfg.backbone, "--num_classes", "81", "--img_size", str(size),
                         "--checkpoints_dir", cfg.checkpoints_dir, "--images", *paths, "--out", out,
                         "--device", device.type])
    launches = launch_counts()
    if "WARNING" in printed.getvalue() or launches != (4, 4, 0):
        raise AssertionError(f"cli.detect: {printed.getvalue()!r}, launches {launches}; expected (4, 4, 0)")
    predictor = Predictor(cfg, state_dict, device=device)
    counts = []
    for i, path in enumerate(paths):
        r = predictor.detect([image_io.imread(path)])[0]
        base = os.path.join(out, f"request_{i}")
        with open(base + ".json") as f:
            written = json.load(f)
        want = {"rois": r["rois"].tolist(), "class_ids": r["class_ids"].tolist(), "scores": r["scores"].tolist()}
        if written != want or not os.path.getsize(base + "_det.png"):
            raise AssertionError(f"cli.detect {path}: JSON {written} against Predictor.detect {want}")
        counts.append(len(r["class_ids"]))
    log(f"  JSON equal to Predictor.detect's results ({counts} detections), overlays written; launches "
        f"{launches} ({card})")


# ---------------------------------------------------------------------------
# the backbone zoo
# ---------------------------------------------------------------------------

ZOO_FULL_WIDTH = ("seresnet34", "seresnext50", "senet154", "mobilenet", "mobilenetv2", "efficientnetb0")


def seeded_predictor(cfg, device):
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    params = count_params(model)
    return Predictor(cfg, model.state_dict(), device=device), params


def serve_counted(predictor, images, cfg):
    """One request through ``Predictor.detect``; it must launch NMS and the
    ROIAlign forward twice each. Returns its latency in ms."""
    before = launch_counts()
    start = time.perf_counter()
    results = predictor.detect(images)  # returns host arrays: synchronized
    ms = (time.perf_counter() - start) * 1e3
    rose = tuple(a - b for a, b in zip(launch_counts(), before))
    if rose != (2, 2, 0):
        raise AssertionError(f"{cfg.backbone}: a request launched (NMS, ROIAlign, backward) = {rose}; expected (2, 2, 0)")
    check_results(results, images, cfg)
    return ms


def train_counted(state, step, batch, gen, steps):
    """``steps`` training steps; each must launch (NMS, ROIAlign forward,
    backward) = (1, 2, 2), give finite losses and ``grad_finite`` 1. Returns
    the step times in ms and the last losses."""
    times = []
    for i in range(steps):
        before = launch_counts()
        start = time.perf_counter()
        state, losses = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        values = {k: float(v) for k, v in losses.items()}
        rose = tuple(a - b for a, b in zip(launch_counts(), before))
        name = state.model.config.backbone
        if rose != (1, 2, 2):
            raise AssertionError(f"{name} step {i}: launched (NMS, ROIAlign, backward) = {rose}; expected (1, 2, 2)")
        if not all(np.isfinite(v) for v in values.values()) or values["grad_finite"] != 1.0:
            raise AssertionError(f"{name} step {i}: {values}")
    return times, values


def zoo_full_width(device, card, requests):
    """Phase 14a: each of ``ZOO_FULL_WIDTH`` at the flagship's serving and
    training configurations: 2 requests and 2 training steps."""
    log("== zoo, full width: 512x512, 81 classes, bf16, 256-wide FPN and heads; 2 requests of 2 images and 2 "
        "training steps of batch 2 each, seeded random weights")
    for name in ZOO_FULL_WIDTH:
        cfg = flagship_config().replace(backbone=name)
        predictor, params = seeded_predictor(cfg, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        latencies = [serve_counted(predictor, images, cfg) for images in requests[:2]]
        serve_peak = torch.cuda.max_memory_allocated() / 2**20
        del predictor
        torch.cuda.empty_cache()

        tcfg = flagship_train_config().replace(backbone=name)
        gen = torch.Generator().manual_seed(SEED)
        state = create_train_state(tcfg, gen, device=device)
        before = [p.detach().clone() for p in state.model.parameters()]
        step, batch = make_train_step(tcfg), synthetic_batch(tcfg, 2, SEED + 6, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, values = train_counted(state, step, batch, gen, 2)
        train_peak = torch.cuda.max_memory_allocated() / 2**20
        unchanged = [n for (n, p), q in zip(state.model.named_parameters(), before)
                     if n.endswith("weight") and torch.equal(p.detach(), q)]
        if unchanged:
            raise AssertionError(f"{name}: weights unchanged after 2 steps: {unchanged[:5]}")
        log(f"  {name}: {params:,d} parameters; requests {latencies[0]:.1f} (the model's first), "
            f"{latencies[1]:.1f} ms, peak {serve_peak:.0f} MiB; training steps {times[0]:.1f} (the first), "
            f"{times[1]:.1f} ms, peak {train_peak:.0f} MiB, loss_sum {values['loss_sum']:.4f}, every weight moved "
            f"({card})")
        del state, step, batch, before
        torch.cuda.empty_cache()


def zoo_sweep(device, card):
    """Phase 14b: every key builds on the card and serves one request of one
    256x256 image."""
    log("== zoo sweep: all 25 keys, one request of 1 image at 256x256 each (bf16, 81 classes; the latency is "
        "the model's first request)")
    rs = np.random.RandomState(SEED + 14)
    image = smooth_image(rs, 256, 256)
    for name in backbone_names():
        cfg = flagship_config().replace(backbone=name, image_shape=(256, 256, 3), image_min_dim=256,
                                        image_max_dim=256)
        predictor, params = seeded_predictor(cfg, device)
        ms = serve_counted(predictor, [image], cfg)
        log(f"  {name:15s} {params:>12,d} parameters  {ms:8.1f} ms")
        del predictor
    torch.cuda.empty_cache()
    log(f"  ({card})")


def zoo_pretrained(device, card, root):
    """Phase 14c: a seeded timm EfficientNet-B0 file and a torchvision
    MobileNetV2 file through ``create_train_state`` at full coverage, bit-equal
    to the file, then one training step each."""
    log("== zoo pretrained: seeded timm efficientnet_b0 and torchvision mobilenet_v2 state_dicts into the "
        "flagship's training state")
    for name, sd, total in (("efficientnetb0", timm_efficientnet_state_dict("efficientnetb0", SEED + 15), 304),
                            ("mobilenetv2", torchvision_mobilenet_v2_state_dict(SEED + 16), 255)):
        path = os.path.join(root, f"{name}.pth")
        torch.save(sd, path)
        tcfg = flagship_train_config().replace(backbone=name, backbone_init_weights=path)
        printed = io.StringIO()
        gen = torch.Generator().manual_seed(SEED)
        with contextlib.redirect_stdout(printed):
            state = create_train_state(tcfg, gen, device=device)
        coverage = printed.getvalue().strip()
        if f"{total}/{total} leaves" not in coverage:
            raise AssertionError(f"{name}: pretrained coverage {coverage!r}; expected {total}/{total}")
        got = state.model.state_dict()
        converted = convert_torch_backbone(sd)
        differ = [k for k, v in converted.items() if not torch.equal(got["backbone." + k].cpu(), v)]
        if differ or len(converted) != total:
            raise AssertionError(f"{name}: backbone entries differ from the file's: {differ[:5]}")
        _, values = train_counted(state, make_train_step(tcfg), synthetic_batch(tcfg, 2, SEED + 6, device), gen, 1)
        log(f"  {name}: {coverage}; every backbone entry equals the file's bit for bit; 1 step: loss_sum "
            f"{values['loss_sum']:.4f}, grad_finite 1, launches (1, 2, 2) ({card})")
        del state
        torch.cuda.empty_cache()


def zoo_cross_check(device):
    """Phase 14d: small float32 backbones with the same seeded weights on the
    card (channels_last, TF32 off) and on the CPU: C1..C5 within 1e-4 of max
    |CPU|, with the batch norms on their running averages (randomised) and on
    batch statistics. EfficientNet-B0 runs cuDNN's 3x3 and 5x5 depthwise
    convs, SENet154's code at one block a stage its grouped 64x4d convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.RandomState(SEED + 17).normal(size=(2, 3, 128, 128)).astype(np.float32))
    for name, make in (("efficientnetb0", lambda: get_backbone("efficientnetb0")),
                       ("senet154, one block a stage", lambda: ResNet(
                           stage_sizes=(1, 1, 1, 1), block="bottleneck", groups=64, base_width=4, use_se=True,
                           deep_stem=True))):
        cpu = lecun_init_(make(), torch.Generator().manual_seed(SEED))
        g = torch.Generator().manual_seed(SEED + 1)
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    for t, lo, hi in ((m.weight, 0.5, 1.5), (m.running_var, 0.5, 1.5)):
                        t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
                    for t in (m.bias, m.running_mean):
                        t.copy_(torch.randn(t.shape, generator=g) * 0.1)
        card = copy.deepcopy(cpu).to(device, memory_format=torch.channels_last)
        worst = {}
        for mode in ("running averages", "batch statistics"):
            train = mode == "batch statistics"
            with torch.no_grad():
                want = cpu.train(train)(x)
                got = card.train(train)(x.to(device).contiguous(memory_format=torch.channels_last))
            for level, ref in want.items():
                err = float((got[level].cpu() - ref).abs().max() / ref.abs().max())
                worst[mode] = max(worst.get(mode, 0.0), err)
                if not err <= 1e-4:
                    raise AssertionError(f"{name} ({mode}): {level} differs by {err} of max |CPU| between card and CPU")
        log(f"== zoo cross-check, {name}, float32 at 128x128, card (channels_last, TF32 off) vs CPU: C1..C5 within "
            + ", ".join(f"{v:.3g} on {k}" for k, v in worst.items()))


def run_zoo(device, card, root, requests):
    """Phase 14. Returns the launch counts of its main path (14a-14c)."""
    seconds = [time.perf_counter()]
    torch.cuda.synchronize()
    zero_launch_counts()
    zoo_full_width(device, card, requests)
    seconds.append(time.perf_counter())
    zoo_sweep(device, card)
    seconds.append(time.perf_counter())
    zoo_pretrained(device, card, root)
    launches = launch_counts()
    seconds.append(time.perf_counter())
    zoo_cross_check(device)
    seconds.append(time.perf_counter())
    parts = ", ".join(f"{name} {b - a:.1f} s" for name, a, b in zip(("full width", "sweep", "pretrained", "cross-check"),
                                                                    seconds, seconds[1:]))
    log(f"== zoo phase done in {seconds[-1] - seconds[0]:.1f} s ({parts}); launches (NMS, ROIAlign forward, "
        f"backward) {launches}")
    return dict(zip(("nms", "roi_align", "roi_align_backward"), launches))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this script needs the card")
    device = torch.device("cuda")
    t0 = time.time()
    card = card_line()
    log(f"== device: {torch.cuda.get_device_name(0)} ({card}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")

    logs = _build.build(["nms", "roi_align"])
    for name, out in logs.items():
        log(f"== build {name}.cu:\n" + "\n".join("  " + ln for ln in out.strip().splitlines()))
    log(f"== build done at {time.time() - t0:.1f} s (into {_build.BUILD_DIR})")

    cfg = flagship_config()
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED))
    predictor = Predictor(cfg, model.state_dict(), device=device)
    del model
    rs = np.random.RandomState(SEED)
    requests = [[smooth_image(rs, *hw) for hw in pair] for pair in REQUEST_SIZES]
    calls = capture_inputs(predictor, requests[0])
    log(f"== capture: warm-up request done at {time.time() - t0:.1f} s")

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=device)  # > 50 MB L2
    log("== holds: greedy NMS kernel (csrc/nms.cu) vs greedy_nms_plain")
    nms_stats = hold_nms(calls["nms"], flush, [("chains", *chain_case(device), 0.5, 1000)] + nms_edge_cases(device))
    log("  library: no single PyTorch call computes greedy NMS (torchvision is absent)")
    log("== holds: pyramid ROIAlign kernel (csrc/roi_align.cu) vs roi_align_plain")
    roi_stats = hold_roi_align(calls["roi_align"], flush)
    hold_roi_scalar_width(device)
    log("  library: no single PyTorch call computes pyramid ROIAlign (torchvision is absent)")
    del calls
    tiny_cross_check(device)

    log("== serving: 4 requests of 2 images, flagship config (ResNet-50-FPN, 512, 81 classes, bf16)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.greedy_nms.launches = 0
    roi_kernel.roi_align.launches = 0
    latencies, all_results = [], []
    for images in requests:
        before = (nms_kernel.greedy_nms.launches, roi_kernel.roi_align.launches)
        start = time.perf_counter()
        results = predictor.detect(images)  # returns host arrays: synchronized
        latencies.append((time.perf_counter() - start) * 1e3)
        all_results.append((images, results))
        rose = (nms_kernel.greedy_nms.launches - before[0], roi_kernel.roi_align.launches - before[1])
        if min(rose) < 2:
            raise AssertionError(f"a request launched (nms, roi_align) = {rose} times; expected >= 2 each")
    launches = {"nms": nms_kernel.greedy_nms.launches, "roi_align": roi_kernel.roi_align.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    for i, ((images, results), ms) in enumerate(zip(all_results, latencies)):
        check_results(results, images, cfg)
        log(f"  request {i}: sizes {[im.shape[:2] for im in images]} latency {ms:.1f} ms, "
            f"detections {[len(r['class_ids']) for r in results]}")
    # valid proposal and detection counts of the last request, from a direct forward
    molded, metas = zip(*(process_input(im, cfg, i) for i, im in enumerate(requests[-1])))
    out = predictor.model(torch.from_numpy(np.stack(molded)).to(device),
                          torch.from_numpy(np.stack(metas)).to(device))
    log(f"  valid proposals per image {out['rpn_rois_valid'].sum(1).tolist()}, valid detections "
        f"{(out['detections'][..., 4] > 0).sum(1).tolist()}; peak memory {peak:.0f} MiB; "
        f"launches {launches} ({card})")

    del predictor, out
    torch.cuda.empty_cache()

    state, step, batch, gen, tcalls = capture_train(device)
    log(f"== train capture: one step done at {time.time() - t0:.1f} s")
    log("== holds, training inputs: greedy NMS and pyramid ROIAlign forward kernels vs their plain versions")
    nms_train = hold_nms(tcalls["nms"], flush)
    roi_train = hold_roi_align(tcalls["roi_align"], flush)
    bwd_stats = hold_roi_backward(tcalls["roi_align_backward"], flush)
    del tcalls, flush
    tiny_train_cross_check(device)
    train_launches = run_training(state, step, batch, gen, card)
    del state, step, batch
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        loop_launches, loop_cfg, val = run_train_model(device, card, root)
        torch.cuda.empty_cache()
        pretrained_launches = run_pretrained(device, card, root)
        eval_launches, stream_launches, eval_cfg, state_dict = run_evaluate(device, card, root, loop_cfg, val)
        run_detect_cli(device, card, root, eval_cfg, state_dict)
        zoo_launches = run_zoo(device, card, root, requests)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    extra = {name: {"eval_launches": eval_launches[i], "stream_launches": stream_launches[i],
                    "pretrained_launches": pretrained_launches[name], "zoo_launches": zoo_launches[name]}
             for i, name in enumerate(("nms", "roi_align", "roi_align_backward"))}

    kernels = [
        dict(name="greedy_nms", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/nms.cu",
             replaces="maskrcnn_tf2_tpu/kernels/nms_pallas.py:29", launches=launches["nms"],
             train_launches=train_launches["nms"], train_model_launches=loop_launches["nms"], **nms_stats,
             library_ms=None,
             train_ms=nms_train["ms"], train_bound_ms=nms_train["bound_ms"], **extra["nms"]),
        dict(name="pyramid_roi_align", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:484",
             also_replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:224",
             launches=launches["roi_align"], train_launches=train_launches["roi_align"],
             train_model_launches=loop_launches["roi_align"],
             **roi_stats, library_ms=None, train_ms=roi_train["ms"], train_bound_ms=roi_train["bound_ms"],
             **extra["roi_align"]),
        dict(name="pyramid_roi_align_backward", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:967",
             also_replaces=["maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:865",
                            "maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:1316"],
             launches=train_launches["roi_align_backward"],
             train_model_launches=loop_launches["roi_align_backward"], **bwd_stats, library_ms=None,
             **extra["roi_align_backward"]),
    ]
    log(f"== done at {time.time() - t0:.1f} s; forward kernels' times per served batch of 2 images "
        f"(ms) and per training step (train_ms), the backward's per training step of 2 images (both "
        f"call sites summed); launches: serving's 4 requests, train_launches and the backward's: the 5 "
        f"training steps; train_model_launches: train_model's 6 steps and 4 eval steps; eval_launches and "
        f"stream_launches: evaluate_dataset over 4 images through detect and detect_stream; "
        f"pretrained_launches: 2 fine-tune steps from a pretrained file; zoo_launches: the backbone zoo's "
        f"{2 * len(ZOO_FULL_WIDTH)} requests and {2 * len(ZOO_FULL_WIDTH)} steps at full width, "
        f"{len(backbone_names())} requests of the sweep and 2 steps from pretrained files")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
