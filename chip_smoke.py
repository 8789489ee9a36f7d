#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card and hold its
kernels against their plain PyTorch versions.

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
               edge cases): NMS identical, ROIAlign within 1e-5 * max|feature|
               in float32 (TF32 off) and one bf16 ulp of max|feature| in bf16.
               Times come from CUDA events with the L2 cache flushed before
               each launch.
5. serving  -- launch counts set to 0, then 4 requests of 2 uint8 images of
               other sizes than 512; latency, valid proposals and detections,
               peak memory; every kernel must have launched twice a request.
6. report   -- a ``{"kernels": [...]}`` line, the card line, and last the
               ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export.inference import process_input
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.kernels import nms as nms_kernel
from maskrcnn_tf2_tpu_torch.kernels import roi_align as roi_kernel
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.ops import nms as nms_op
from maskrcnn_tf2_tpu_torch.ops import roi_align as roi_op
from maskrcnn_tf2_tpu_torch.predictor import Predictor
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


def smooth_image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Blocky colour noise plus grain: features that are not flat."""
    x = rs.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
    x = np.repeat(np.repeat(x, 16, axis=0), 16, axis=1)[:h, :w]
    return np.clip(x + rs.normal(0, 10, x.shape), 0, 255).astype(np.uint8)


def kernel_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each one timed on its
    own with CUDA events after the L2 cache was flushed."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
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


def chain_case(device):
    """Staircases of equal boxes, each step overlapping the next above the
    threshold but not the one after it: greedy order alternates kept and
    suppressed along each chain, inside and across the kernel's tiles."""
    rs = np.random.RandomState(SEED + 1)
    base = rs.uniform(0, 0.6, (200, 2))
    y1 = (base[:, None, 0] + 0.07 * np.arange(30)[None, :]).reshape(-1)
    x1 = np.repeat(base[:, 1], 30)
    boxes = np.stack([y1, x1, y1 + 0.3, x1 + 0.3], -1).astype(np.float32)[None]
    valid = rs.uniform(size=boxes.shape[:2]) > 0.05
    return torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)


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


def hold_nms(calls, flush):
    log("== holds: greedy NMS kernel (csrc/nms.cu) vs greedy_nms_plain")
    timings = []
    cases = [("path", *call[0]) for call in calls] + [
        ("chains", *chain_case(calls[0][0][0].device), 0.5, 1000)]
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
    log("  library: no single PyTorch call computes greedy NMS (torchvision is absent)")
    return summarize(0.0, timings)  # any differing index or flag raised above


def hold_roi_align(calls, flush):
    log("== holds: pyramid ROIAlign kernel (csrc/roi_align.cu) vs roi_align_plain")
    err, timings = 0.0, []
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons in full float32
    torch.backends.cudnn.allow_tf32 = False
    for args, _ in calls:
        features, boxes, pool, image_shape = args[:4]
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
        log(f"  {pool}x{pool}: boxes {tuple(boxes.shape)} maps {[tuple(f.shape) for f in features]} "
            f"{features[0].dtype}: max err bf16 {e16:.3g}, f32 {e32:.3g} (max|f| {scale:.3g}); "
            f"kernel {k:.4f} ms, plain {p:.3f} ms, bound {max(bt, ot) * 1e3:.3f} us")
    log("  library: no single PyTorch call computes pyramid ROIAlign (torchvision is absent)")
    return summarize(err, timings)


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
    nms_stats = hold_nms(calls["nms"], flush)
    roi_stats = hold_roi_align(calls["roi_align"], flush)
    del calls, flush
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

    kernels = [
        dict(name="greedy_nms", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/nms.cu",
             replaces="maskrcnn_tf2_tpu/kernels/nms_pallas.py:29", launches=launches["nms"],
             **nms_stats, library_ms=None),
        dict(name="pyramid_roi_align", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:484",
             also_replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:224",
             launches=launches["roi_align"], **roi_stats, library_ms=None),
    ]
    log(f"== done at {time.time() - t0:.1f} s; times per served batch of 2 images (both call sites summed)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
