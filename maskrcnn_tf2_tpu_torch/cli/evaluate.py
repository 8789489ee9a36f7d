"""Evaluation CLI: COCO-style bbox+segm AP over a dataset, from the port's
checkpoint (counterpart of ``maskrcnn_tf2_tpu/cli/evaluate.py``).

Usage:
  python -m maskrcnn_tf2_tpu_torch.cli.evaluate --dataset_path /data/coco \\
      --backbone resnet50 [--limit 500] [--minitrain] [--device cpu]

The checkpoint is the newest one under
``{checkpoints_dir}/maskrcnn_{backbone}_{md5[:8]}`` for the configuration
these arguments build (``train/checkpoint.py``). ``--device`` defaults to the
card and raises without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from maskrcnn_tf2_tpu_torch.config import coco_config
from maskrcnn_tf2_tpu_torch.data.coco import CocoDataset
from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.eval.coco_eval import evaluate_dataset
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state

MINITRAIN_CLASSES = ["person", "bicycle", "car", "motorcycle"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--subset", default="val")
    p.add_argument("--year", default="2017")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--minitrain", action="store_true")
    p.add_argument("--checkpoints_dir", default="logs")
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    class_names = MINITRAIN_CLASSES if args.minitrain else None
    cfg = coco_config(
        backbone=args.backbone,
        num_classes=(1 + len(class_names)) if class_names else 81,
        image_shape=(args.img_size, args.img_size, 3),
        image_min_dim=args.img_size,
        image_max_dim=args.img_size,
        batch_size=args.batch_size,
        checkpoints_dir=args.checkpoints_dir,
    )
    ds = CocoDataset()
    ds.load_coco(args.dataset_path, args.subset, args.year, class_names=class_names)
    ds.prepare()

    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, epoch, _ = ckpt_lib.restore(ckpt_lib.make_manager(cfg), state)
    if epoch == 0:
        print("WARNING: no checkpoint found — evaluating random weights")

    pred = Predictor(cfg, state.model.state_dict(), device=device)
    stats = evaluate_dataset(pred, ds, cfg, limit=args.limit)
    print(json.dumps(stats, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats, f)
    return stats


if __name__ == "__main__":
    main()
