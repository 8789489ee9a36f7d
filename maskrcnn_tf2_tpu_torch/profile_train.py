"""Where the time of one training step goes, on a CUDA card.

    python -m maskrcnn_tf2_tpu_torch.profile_train [--batch 2] [--steps 10] [--train-model]

Builds the flagship at its training defaults (ResNet-50-FPN, 512x512, 81
classes, bf16, 2000 proposals, 200 ROIs per image, adamax) with seeded random
weights and a seeded synthetic batch, and reports, with the card's name and
power limit:

- the step time on the host clock (each step ends in the loss guard's
  synchronisation), median and spread over ``--steps`` steps after warm-up;
- a ``torch.profiler`` table of device time by kernel for one step, the share
  of the hand-written kernels and of idle device time.

With ``--train-model`` it profiles one epoch of ``train.loop.train_model``
instead (``--steps`` steps of ``--batch`` images with device augmentation, from
a synthetic shapes dataset written as a COCO directory in a temporary
directory, its sample cache warm, then validation over 4 images and the
checkpoint): the epoch's wall time split into training steps, loader waits and
validation plus checkpoint, and the device's busy time and idle share over the
whole epoch.
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
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
from maskrcnn_tf2_tpu_torch.train.loop import train_model
from maskrcnn_tf2_tpu_torch.train.synthetic import shapes_coco_datasets, synthetic_batch
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state, make_train_step

KERNEL_NAMES = ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel", "roi_align_backward_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-model", action="store_true", help="profile an epoch of train_model instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.train_model:
        profile_train_model(args, card)
        return
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
    device_us = _device_us(prof)
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


def _device_us(prof):
    """Device time by kernel and copy: the device-side rows only (operator
    rows repeat their time)."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def profile_train_model(args, card) -> None:
    with tempfile.TemporaryDirectory() as root:
        train, val = shapes_coco_datasets(os.path.join(root, "coco"), (args.steps * args.batch, 4), 512, args.seed)
        cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=train.num_classes, backbone="resnet50",
                             compute_dtype="bfloat16", batch_size=args.batch, epochs=1, log_per_steps=10**9,
                             augment_on_device=True, augment_scale_jitter=0.25, augment_photometric=0.2,
                             sample_cache_dir=os.path.join(root, "cache"), checkpoints_dir=os.path.join(root, "ckpt"))
        for ds in (train, val):  # a warm sample cache: the steady state of later epochs
            list(DataLoader(ds, cfg, shuffle=False).epoch())
        train_model(cfg, train, checkpoint_base=os.path.join(root, "warm"), steps_per_epoch=3, rng_seed=args.seed)
        state = create_train_state(cfg, torch.Generator().manual_seed(args.seed), device="cuda")
        torch.cuda.synchronize()
        history = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_model(cfg, train, val, state=state, checkpoint_base=os.path.join(root, "profiled"),
                        rng_seed=args.seed, history=history)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    (h,) = history
    device_us = _device_us(prof)
    busy = sum(device_us.values()) / 1e6
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"train_model, one epoch of {h['steps']} steps of {args.batch} images (512x512, bf16, ResNet-50-FPN, "
          f"{cfg.num_classes} classes, device augmentation), validation over 4 images, checkpoint; profiled")
    print(f"epoch wall {wall:.3f} s: training steps {h['train_seconds']:.3f} s ({h['steps'] * args.batch / h['train_seconds']:.2f} "
          f"images/s), of which waiting for the loader {h['loader_wait_s']:.3f} s "
          f"({h['loader_wait_s'] / h['train_seconds']:.4f}); validation and checkpoint "
          f"{h['seconds'] - h['train_seconds']:.3f} s")
    print(f"device busy {busy:.3f} s of {wall:.3f} s: idle share {max(0.0, 1 - busy / wall):.3f}")
    for name in KERNEL_NAMES:
        us = sum(v for k, v in device_us.items() if name in k)
        print(f"  {name}: {us / 1e3:.3f} ms ({us / 1e6 / busy:.3%} of device time)")
    print("device time by kernel (the epoch):")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms  {us / 1e6 / busy:7.2%}  {key[:100]}")


if __name__ == "__main__":
    main()
