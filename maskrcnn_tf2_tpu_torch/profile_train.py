"""Where the time of one training step goes, on a CUDA card.

    python -m maskrcnn_tf2_tpu_torch.profile_train [--batch 2] [--steps 10]

Builds the flagship at its training defaults (ResNet-50-FPN, 512x512, 81
classes, bf16, 2000 proposals, 200 ROIs per image, adamax) with seeded random
weights and a seeded synthetic batch, and reports, with the card's name and
power limit:

- the step time on the host clock (each step ends in the loss guard's
  synchronisation), median and spread over ``--steps`` steps after warm-up;
- a ``torch.profiler`` table of device time by kernel for one step, the share
  of the hand-written kernels and of idle device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.train.synthetic import synthetic_batch
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state, make_train_step

KERNEL_NAMES = ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel", "roi_align_backward_kernel",
                "cast_to_bf16")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                         compute_dtype="bfloat16", batch_size=args.batch)
    gen = torch.Generator().manual_seed(args.seed)
    state = create_train_state(cfg, gen, device="cuda")
    step = make_train_step(cfg)
    batch = synthetic_batch(cfg, args.batch, args.seed, "cuda")
    for _ in range(3):
        state, _ = step(state, batch, rng=gen)
    torch.cuda.synchronize()

    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, losses = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, rng=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): operator rows repeat their time
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy_us = sum(device_us.values())
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)

    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"batch {args.batch} x 512x512, bf16, {cfg.post_nms_rois_training} proposals, "
          f"{cfg.train_rois_per_image} ROIs per image, {cfg.optimizer}")
    print(f"step on the host clock: median {np.median(times):.1f} ms, min {min(times):.1f}, "
          f"max {max(times):.1f} over {args.steps} steps; loss_sum {float(losses['loss_sum']):.4f}")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"profiled step: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}, {launches} device kernels and copies")
    for name in KERNEL_NAMES:
        us = sum(v for k, v in device_us.items() if name in k)
        print(f"  {name}: {us / 1e3:.3f} ms ({us / busy_us:.3%} of device time)")
    print("device time by kernel (one step):")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {us / 1e3:9.3f} ms  {us / busy_us:7.2%}  {key[:100]}")


if __name__ == "__main__":
    main()
