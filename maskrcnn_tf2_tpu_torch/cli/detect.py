"""Inference CLI: run detection on images with a trained checkpoint of the
port (counterpart of ``maskrcnn_tf2_tpu/cli/detect.py``).

Usage:
  python -m maskrcnn_tf2_tpu_torch.cli.detect --checkpoints_dir logs \\
      --backbone resnet50 --num_classes 81 --images a.jpg b.jpg [--out out/] [--int8] [--device cpu]
  python -m maskrcnn_tf2_tpu_torch.cli.detect --checkpoints_dir logs \\
      --build_engine mrcnn.engine [--engine_batch 2] [--int8 --images a.jpg ...] [--device cpu]

With ``--out``, each image gets ``{name}.json`` (rois, class_ids, scores) and
``{name}_det.png``: each detection's box outlined in red (2 px, as
``cv2.rectangle`` draws it) and its mask blended half with green, detection
by detection. ``--int8`` calibrates on the ``--images``, one image a batch,
then serves the int8 model (``export/quantize.py``). ``--build_engine PATH``
compiles the served forward at ``--engine_batch`` into an engine
(``export/engine.py``), writes it to PATH and exits: a plain build needs no
images, an int8 one calibrates on ``--images``. ``--device`` defaults to the
card and raises without one; an engine is built for that device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import image_io, raster
from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.export.engine import build_engine
from maskrcnn_tf2_tpu_torch.export.inference import process_input
from maskrcnn_tf2_tpu_torch.export.quantize import quantize_for_inference
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state


def overlay(image: np.ndarray, result) -> np.ndarray:
    """The image with each detection's box outline and mask blend."""
    out = image.copy()
    for i, (y1, x1, y2, x2) in enumerate(result["rois"]):
        raster.outline_rectangle(out, (x1, y1), (x2, y2), (255, 0, 0), 2)
        m = result["masks"][:, :, i]
        out[m] = (0.5 * out[m] + 0.5 * np.array([0, 255, 0])).astype(np.uint8)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--num_classes", type=int, default=81)
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--checkpoints_dir", default="logs")
    p.add_argument("--images", nargs="+", default=None,
                   help="image paths; required unless --build_engine is given without --int8 (int8 calibrates on "
                        "them)")
    p.add_argument("--out", default=None, help="directory for JSON + overlays")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training quantization: calibrate on the images, then serve the int8 model")
    p.add_argument("--build_engine", default=None, metavar="PATH",
                   help="compile the served forward ahead of time (AOTInductor) into an engine at PATH, then exit")
    p.add_argument("--engine_batch", type=int, default=1, help="the batch an engine of --build_engine serves")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.images is None and not (args.build_engine and not args.int8):
        p.error("--images is required (only a plain --build_engine run, without --int8 calibration, can omit it)")
    device = resolve_device(args.device)

    cfg = MaskRCNNConfig(
        backbone=args.backbone,
        num_classes=args.num_classes,
        image_shape=(args.img_size, args.img_size, 3),
        image_min_dim=args.img_size,
        image_max_dim=args.img_size,
        checkpoints_dir=args.checkpoints_dir,
    )
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state, epoch, _ = ckpt_lib.restore(ckpt_lib.make_manager(cfg), state)
    if epoch == 0:
        print("WARNING: no checkpoint found — using random weights")

    state_dict = state.model.state_dict()
    if args.int8:
        def calib_batches():
            for path in args.images:
                molded, meta = process_input(image_io.imread(path), cfg, image_id=0)
                yield torch.from_numpy(molded[None]), torch.from_numpy(meta[None])

        cfg, state_dict = quantize_for_inference(cfg, state_dict, calib_batches(), device=device)
    if args.build_engine:
        out = build_engine(cfg, state_dict, args.build_engine, batch_size=args.engine_batch, device=device)
        print(f"engine written: {out} (batch={args.engine_batch})")
        return out
    pred = Predictor(cfg, state_dict, device=device)
    results = []
    for path in args.images:
        img = image_io.imread(path)
        r = pred.detect([img])[0]
        results.append(r)
        print(
            f"{path}: {len(r['class_ids'])} instances "
            f"classes={r['class_ids'].tolist()} scores={np.round(r['scores'], 3).tolist()}"
        )
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            base = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(args.out, base + ".json"), "w") as f:
                json.dump({"rois": r["rois"].tolist(), "class_ids": r["class_ids"].tolist(),
                           "scores": r["scores"].tolist()}, f)
            image_io.imwrite(os.path.join(args.out, base + "_det.png"), overlay(img, r))
    return results


if __name__ == "__main__":
    main()
