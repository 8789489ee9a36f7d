#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and training step on one CUDA
card and hold its kernels against their plain PyTorch versions.

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
6. train capture -- one ``make_train_step`` step at the flagship's training
               configuration (batch 2, 2-8 seeded GT boxes per image, 56x56
               mini masks) records the inputs of ``greedy_nms``, ``roi_align``
               and ``roi_align_backward``: one, two and two calls.
7. holds, backward -- the ROIAlign backward kernel against its plain version
               on the captured 7x7 and 14x14 calls (bf16 within one bf16 ulp of
               max|plain|; float32 within 1e-5 * max|plain|, with zero-area,
               full-image and sliver boxes in front, where zero-area ROIs must
               leave the maps untouched) and on a float32 pyramid over 88 MiB
               (the TPU's second backward kernel's regime); times as in 4.
8. tiny train cross-check -- one training step of a small float32 model,
               card against CPU, same weights and draws: losses within 1e-4
               relative with the batch norms on batch statistics and on their
               running averages, and in the latter every gradient leaf within
               1e-4 of its max plus the step's largest gradient.
9. train    -- launch counts set to 0, then 5 steps at full width: finite
               losses, ``grad_finite`` 1, parameters changed, each step one NMS,
               two forward and two backward ROIAlign launches; median step time
               over steps 2-5 and peak memory.
10. report  -- a ``{"kernels": [...]}`` line, the card line, and last the
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
from maskrcnn_tf2_tpu_torch.ops.targets import draw_uniforms
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train.synthetic import smooth_image, synthetic_batch
from maskrcnn_tf2_tpu_torch.train.train_step import _loss, create_train_state, make_train_step
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


def capture_train(state, step, batch, gen):
    """One training step through the real path, recording the inputs of each
    kernel wrapper: one NMS call, two ROIAlign forwards, two backwards."""
    calls = {"nms": [], "roi_align": [], "roi_align_backward": []}

    def recorder(fn, key):
        def wrapped(*args, **kwargs):
            calls[key].append((args, kwargs))
            return fn(*args, **kwargs)

        return wrapped

    with mock.patch.object(nms_op, "greedy_nms", recorder(nms_kernel.greedy_nms, "nms")), \
            mock.patch.object(roi_op, "roi_align", recorder(roi_kernel.roi_align, "roi_align")), \
            mock.patch.object(roi_op, "roi_align_backward",
                              recorder(roi_kernel.roi_align_backward, "roi_align_backward")):
        state, losses = step(state, batch, rng=gen)
    torch.cuda.synchronize()
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"nms": 1, "roi_align": 2, "roi_align_backward": 2}:
        raise RuntimeError(f"a training step called the wrappers {counts} times; expected 1, 2, 2")
    return state, losses, calls


def bwd_bound(dout, boxes, level_hw):
    """Bytes: the cotangent and the boxes read once, the gradient maps written
    once in the cotangent's dtype. Operations: 4 multiplies and 4 adds per
    cotangent element."""
    item = dout.element_size()
    b, c = dout.shape[0], dout.shape[-1]
    nbytes = dout.numel() * item + boxes.numel() * 4 + sum(b * h * w * c for h, w in level_hw) * item
    return nbytes / HBM_BYTES_PER_S * 1e3, dout.numel() * 8 / F32_FLOPS * 1e3


def hold_backward_case(name, dout, boxes, level_hw, image_shape):
    """Kernel against plain: one bf16 ulp of max|plain| in bf16, 1e-5 * max|plain| in float32."""
    got = roi_kernel.roi_align_backward(dout, boxes, level_hw, image_shape)
    want = roi_kernel.roi_align_backward_plain(dout, boxes, level_hw, image_shape)
    torch.cuda.synchronize()
    scale = max(float(w.float().abs().max()) for w in want)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    tol = 1e-5 * scale if dout.dtype == torch.float32 else 2.0**-8 * scale
    if not err <= tol:
        raise AssertionError(f"ROIAlign backward ({name}, {dout.dtype}) error {err} > {tol}")
    return err, scale


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
    # the TPU falls back to its read-modify-write kernel above 88 MiB of float32
    # pyramid per image; 1024x1024 is 85 MiB, so 1152x1152 (108 MiB)
    rs = np.random.RandomState(SEED + 3)
    level_hw = [(1152 // s, 1152 // s) for s in (4, 8, 16, 32)]
    mib = sum(h * w for h, w in level_hw) * 256 * 4 / 2**20
    boxes = torch.from_numpy(roi_like_boxes(rs, 200)[None]).to(dout.device)
    big = torch.from_numpy(rs.normal(size=(1, 200, 14, 14, 256)).astype(np.float32)).to(dout.device)
    e_big, _ = hold_backward_case("1152x1152", big, boxes, level_hw, (1152, 1152))
    e_big16, _ = hold_backward_case("1152x1152", big.to(torch.bfloat16), boxes, level_hw, (1152, 1152))
    log(f"  pyramid of {mib:.1f} MiB f32 per image (1152x1152, batch 1, 14x14 over 200 ROIs): "
        f"max err f32 {e_big:.3g}, bf16 {e_big16:.3g}")
    log("  library: no single PyTorch call computes the ROIAlign backward (torchvision is absent)")
    return summarize(err, timings)


def roi_like_boxes(rs, n):
    y1, x1 = rs.uniform(0, 0.7, (2, n))
    h, w = rs.uniform(0.01, 0.3, (2, n))
    return np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1).astype(np.float32)


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

    tcfg = flagship_train_config()
    gen = torch.Generator().manual_seed(SEED)
    state = create_train_state(tcfg, gen, device=device)
    step = make_train_step(tcfg)
    batch = synthetic_batch(tcfg, 2, SEED + 6, device)
    state, _, tcalls = capture_train(state, step, batch, gen)
    log(f"== train capture: one step done at {time.time() - t0:.1f} s")
    bwd_stats = hold_roi_backward(tcalls["roi_align_backward"], flush)
    del tcalls, flush
    tiny_train_cross_check(device)
    train_launches = run_training(state, step, batch, gen, card)

    kernels = [
        dict(name="greedy_nms", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/nms.cu",
             replaces="maskrcnn_tf2_tpu/kernels/nms_pallas.py:29", launches=launches["nms"],
             train_launches=train_launches["nms"], **nms_stats, library_ms=None),
        dict(name="pyramid_roi_align", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:484",
             also_replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:224",
             launches=launches["roi_align"], train_launches=train_launches["roi_align"],
             **roi_stats, library_ms=None),
        dict(name="pyramid_roi_align_backward", route="cuda", source="maskrcnn_tf2_tpu_torch/csrc/roi_align.cu",
             replaces="maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:967",
             also_replaces=["maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:865",
                            "maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:1316"],
             launches=train_launches["roi_align_backward"], **bwd_stats, library_ms=None),
    ]
    log(f"== done at {time.time() - t0:.1f} s; forward kernels' times per served batch of 2 images, the "
        f"backward's per training step of 2 images (both call sites summed); launches: serving's 4 "
        f"requests, train_launches and the backward's: the 5 training steps")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
