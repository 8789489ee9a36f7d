"""Where the device time of one served batch goes, on a CUDA card.

    python -m maskrcnn_tf2_tpu_torch.profile_serving [--batch 2] [--reps 10] [--backbone KEY]
    python -m maskrcnn_tf2_tpu_torch.profile_serving --stream 16 [--depth 2] [--min-confidence 0.7]

Builds the flagship predictor (ResNet-50-FPN, 512x512, 81 classes, bf16,
seeded random weights, ``detection_min_confidence=0`` so every stage works;
``--backbone`` swaps in another of the 25 backbones)
and reports, with the card's name and power limit:

- the device forward of one batch (CUDA events over ``--reps`` forwards,
  after warm-up; no host preprocessing or unmold);
- one whole ``Predictor.detect`` request on the host clock, split into
  preprocessing, forward + fetch, and unmold;
- a ``torch.profiler`` table of device time by kernel for one forward, and
  the share of the hand-written kernels (NMS: mask and scan; ROIAlign) and
  of idle device time.

``--stream N`` instead serves N images of 480x640 through ``detect`` over
chunks of ``--batch`` and through ``detect_stream`` (``--depth`` batches in
flight), in turns (detect, stream, stream, detect), and prints both rates and
where ``detect_stream``'s host thread waits for the card: the host time of
the operators that synchronize (copies between host and card, scalar reads)
with the Python line that called each, from one profiled stream.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

KERNEL_NAMES = ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel")


def _image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    x = rs.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
    x = np.repeat(np.repeat(x, 16, axis=0), 16, axis=1)[:h, :w]
    return np.clip(x + rs.normal(0, 10, x.shape), 0, 255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backbone", default="resnet50", help="any key of models/backbones/factory.py::backbone_names()")
    ap.add_argument("--stream", type=int, default=0, metavar="N", help="compare detect_stream on N images")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--min-confidence", type=float, default=0.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone=args.backbone,
                         compute_dtype="bfloat16", detection_min_confidence=args.min_confidence)
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(args.seed))
    pred = Predictor(cfg, model.state_dict(), device="cuda")
    rs = np.random.RandomState(args.seed)
    if args.stream:
        return profile_stream(pred, [_image(rs, 480, 640) for _ in range(args.stream)], args, card)
    images = [_image(rs, 480, 640) for _ in range(args.batch)]

    t0 = time.perf_counter()
    molded, metas = zip(*(process_input(im, cfg, i) for i, im in enumerate(images)))
    x = torch.from_numpy(np.stack(molded)).cuda()
    m = torch.from_numpy(np.stack(metas)).cuda()
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    for _ in range(3):
        pred.model(x, m)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        pred.model(x, m)
    end.record()
    end.synchronize()
    fwd_ms = start.elapsed_time(end) / args.reps

    t0 = time.perf_counter()
    out = pred.model(x, m)
    dets, masks = out["detections"].cpu().numpy(), gather_class_masks(out).cpu().numpy()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = [unmold_detections(dets[i], masks[i], im.shape, cfg.image_shape, metas[i][7:11])
               for i, im in enumerate(images)]
    t_unmold = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.model(x, m)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): operator rows repeat their time
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy_us = sum(device_us.values())

    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"{args.backbone}, batch {args.batch} x 480x640 -> 512x512, bf16")
    print(f"device forward: {fwd_ms:.3f} ms per batch (CUDA events, mean of {args.reps})")
    print(f"one request on the host clock: preprocess {t_pre * 1e3:.1f} ms, forward + fetch "
          f"{t_fwd * 1e3:.1f} ms, unmold {t_unmold * 1e3:.1f} ms "
          f"({sum(len(r['class_ids']) for r in results)} detections)")
    print(f"profiled forward: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}")
    for name in KERNEL_NAMES:
        us = sum(v for k, v in device_us.items() if name in k)
        print(f"  {name}: {us / 1e3:.3f} ms ({us / busy_us:.3%} of device time)")
    print("device time by kernel (one forward):")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3:9.3f} ms  {us / busy_us:7.2%}  {key[:100]}")


SYNC_OPS = ("aten::copy_", "aten::_local_scalar_dense", "aten::item", "aten::nonzero")


def profile_stream(pred: Predictor, images, args, card: str) -> None:
    b = args.batch

    def run_detect():
        return [r for k in range(0, len(images), b) for r in pred.detect(images[k:k + b])]

    def run_stream():
        return list(pred.detect_stream(images, batch_size=b, depth=args.depth))

    n_det = sum(len(r["class_ids"]) for r in run_detect())  # warm-up
    run_stream()
    rates = {"detect": [], "detect_stream": []}
    for name, fn in (("detect", run_detect), ("detect_stream", run_stream),
                     ("detect_stream", run_stream), ("detect", run_detect)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        rates[name].append(len(images) / (time.perf_counter() - t0))
    # every call that makes the host wait for the card, by its line
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_stream()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                                if "synchronizing" in str(w.message))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_stream()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"{len(images)} images of 480x640 -> 512x512, bf16, batch {b}, detection_min_confidence "
          f"{args.min_confidence} ({n_det} detections)")
    print(f"images/s: detect {rates['detect']}, detect_stream (depth {args.depth}) {rates['detect_stream']}")
    print(f"synchronizing calls in one detect_stream of {-(-len(images) // b)} batches, by line:")
    for site, count in sites.most_common(15):
        print(f"  {count:5d}  {site}")
    sync = {e.key: (e.cpu_time_total, e.count) for e in prof.key_averages() if e.key in SYNC_OPS}
    print(f"profiled detect_stream: wall {wall_us / 1e3:.1f} ms; host time of the operators that can "
          f"synchronize: " + ", ".join(f"{k} {t / 1e3:.1f} ms in {c} calls" for k, (t, c) in sync.items()))


if __name__ == "__main__":
    main()
