"""Where the device time of one served batch goes, on a CUDA card.

    python -m maskrcnn_tf2_tpu_torch.profile_serving [--batch 2] [--reps 10] [--backbone KEY] [--int8]

Builds the flagship predictor (ResNet-50-FPN, 512x512, 81 classes, bf16,
seeded random weights, ``detection_min_confidence=0`` so every stage works;
``--backbone`` swaps in another of the 25 backbones)
and reports, with the card's name and power limit:

- the device forward of one batch (CUDA events over ``--reps`` forwards,
  after warm-up; no host preprocessing or unmold);
- one whole ``Predictor.detect`` request on the host clock, split into
  preprocessing, forward + fetch, and unmold;
- a ``torch.profiler`` table of device time by kernel for one forward, the
  share of the hand-written kernels (NMS: mask and scan; ROIAlign; the int8
  convolution), and the forward's longest idle gaps on the device, each
  labelled with the program's span that the host was in
  (``utils/profiling.py::idle_gaps``).

``--int8`` calibrates the predictor on the timed batch
(``export/quantize.py::quantize_for_inference``) and profiles the int8
forward instead; its device time is also split into the int8 convolution's
kernels, the quantize passes (every kernel launched inside the program's
``mrcnn::quant.quantize_input`` range, at a site or at a ResNet block's
output) and the rest.

The waits of ``Predictor.detect_stream`` and its host syncs are the
program's own spans and counters: run it under ``utils/profiling.trace``,
then read ``profiling.recorded()`` and ``profiling.idle_gaps``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.export.quantize import quantize_for_inference
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.utils import profiling
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

KERNEL_NAMES = ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel", "int8_conv_mma_kernel",
                "int8_conv_grouped_kernel")
QUANTIZE_RANGE = profiling.PREFIX + "quant.quantize_input"


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
    ap.add_argument("--min-confidence", type=float, default=0.0)
    ap.add_argument("--int8", action="store_true", help="calibrate on the timed batch and profile in int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone=args.backbone,
                         compute_dtype="bfloat16", detection_min_confidence=args.min_confidence)
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(args.seed))
    rs = np.random.RandomState(args.seed)
    images = [_image(rs, 480, 640) for _ in range(args.batch)]

    t0 = time.perf_counter()
    molded, metas = zip(*(process_input(im, cfg, i) for i, im in enumerate(images)))
    x = torch.from_numpy(np.stack(molded)).cuda()
    m = torch.from_numpy(np.stack(metas)).cuda()
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    if args.int8:
        t0 = time.perf_counter()
        cfg, state = quantize_for_inference(cfg, model.state_dict(), [(x.cpu(), m.cpu())], device="cuda")
        calib_s = time.perf_counter() - t0
        pred = Predictor(cfg, state, device="cuda")
    else:
        pred = Predictor(cfg, model.state_dict(), device="cuda")
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
    with tempfile.TemporaryDirectory(prefix="mrcnn_trace_") as trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, "forward.trace.json.gz"))
        gaps = profiling.idle_gaps(trace_dir, k=10)
    events = prof.key_averages()
    # device-side rows only (kernels, copies): operator rows repeat their time, and a
    # range's own device-side row spans its kernels and the gaps between them
    device_us = {e.key: e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                 and not e.key.startswith(profiling.PREFIX)}
    busy_us = sum(device_us.values())

    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"{args.backbone}, batch {args.batch} x 480x640 -> 512x512, "
          + (f"int8 (calibrated on this batch in {calib_s:.2f} s), bf16 elsewhere" if args.int8 else "bf16"))
    print(f"device forward: {fwd_ms:.3f} ms per batch (CUDA events, mean of {args.reps})")
    print(f"one request on the host clock: preprocess {t_pre * 1e3:.1f} ms, forward + fetch "
          f"{t_fwd * 1e3:.1f} ms, unmold {t_unmold * 1e3:.1f} ms "
          f"({sum(len(r['class_ids']) for r in results)} detections)")
    print(f"profiled forward: wall {wall_us / 1e3:.3f} ms, device time {busy_us / 1e3:.3f} ms; longest idle "
          f"gaps on the device (the program's span the host was in): "
          + ", ".join(f"{g.label} {g.seconds * 1e3:.3f} ms" for g in gaps))
    for name in KERNEL_NAMES:
        us = sum(v for k, v in device_us.items() if name in k)
        print(f"  {name}: {us / 1e3:.3f} ms ({us / busy_us:.3%} of device time)")
    if args.int8:
        k7_us = sum(v for k, v in device_us.items() if "int8_conv_" in k)
        # the kernels launched inside the range, through its host-side events
        ranges = [e for e in prof.events() if e.name == QUANTIZE_RANGE and e.device_type == DeviceType.CPU]
        quant_us = sum(e.device_time_total for e in ranges)
        calls = len(ranges)
        rest = busy_us - k7_us - quant_us
        print(f"int8 device time: K7 {k7_us / 1e3:.3f} ms ({k7_us / busy_us:.1%}), input-quantize passes "
              f"{quant_us / 1e3:.3f} ms in {calls} calls ({quant_us / busy_us:.1%}), the rest "
              f"{rest / 1e3:.3f} ms ({rest / busy_us:.1%}) of {busy_us / 1e3:.3f} ms of device time")
    print("device time by kernel (one forward):")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3:9.3f} ms  {us / busy_us:7.2%}  {key[:100]}")


if __name__ == "__main__":
    main()
