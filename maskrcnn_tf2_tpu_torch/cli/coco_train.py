"""COCO training CLI (counterpart of ``maskrcnn_tf2_tpu/cli/coco_train.py``):
the same flags, both spellings, the same defaults, the same configuration
and datasets; training runs through ``train_model`` on the card.

Usage:
  python -m maskrcnn_tf2_tpu_torch.cli.coco_train -backbone=resnet50 \\
      -epochs=50 -batch_size=8 -dataset_path=/data/coco [--minitrain] \\
      [--img_size=512] [--augment_weather] [--augment_extended] \\
      [--tensorboard DIR] [--device cpu]

Host augmentation (``data/augment.py``) is on unless ``--no_augment`` or
``--device_augment``. ``--device`` defaults to the card and raises without
one.

Data-parallel training: under ``torchrun`` (``WORLD_SIZE`` set) the CLI joins
the process group (``parallel.distributed.initialize``), one rank per card
(``cuda:{LOCAL_RANK}`` over NCCL), or on the CPU with ``--device cpu`` over
gloo; ``-batch_size`` is the global batch. ``--sync_bn`` takes the batch
norms' statistics across the ranks and needs a process group:

  torchrun --nproc_per_node 8 -m maskrcnn_tf2_tpu_torch.cli.coco_train \
      -dataset_path=/data/coco -batch_size=8 --sync_bn
"""

from __future__ import annotations

import argparse
import os

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig, coco_config
from maskrcnn_tf2_tpu_torch.data.augment import get_training_augmentation
from maskrcnn_tf2_tpu_torch.data.coco import CocoDataset
from maskrcnn_tf2_tpu_torch.device import resolve_device
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import check_sync_bn
from maskrcnn_tf2_tpu_torch.parallel import distributed
from maskrcnn_tf2_tpu_torch.train.loop import train_model
from maskrcnn_tf2_tpu_torch.utils.tb_writer import make_tb_writer

MINITRAIN_CLASSES = ["person", "bicycle", "car", "motorcycle"]


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-backbone", "--backbone", default="resnet50")
    p.add_argument("-epochs", "--epochs", type=int, default=50)
    p.add_argument("-batch_size", "--batch_size", type=int, default=8)
    p.add_argument("-dataset_path", "--dataset_path", required=True)
    p.add_argument("-img_size", "--img_size", type=int, default=512)
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-3)
    p.add_argument("-optimizer", "--optimizer", default="adamax")
    p.add_argument("--year", default="2017")
    p.add_argument("--minitrain", action="store_true", help="4-class subset (person/bicycle/car/motorcycle)")
    p.add_argument("--n_train", type=int, default=None)
    p.add_argument("--n_val", type=int, default=None)
    p.add_argument("--no_mini_masks", action="store_true", help="disable mini-mask targets (on by default)")
    p.add_argument("--config", default=None, help="YAML config file; flags typed on the command line override it")
    p.add_argument("--checkpoints_dir", default="logs")
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--augment_weather", action="store_true", help="add the weather set (snow/rain/fog/sun flare)")
    p.add_argument("--augment_extended", action="store_true",
                   help="add the extended set (shift-scale/perspective/CLAHE/gamma/sharpen/motion blur/"
                        "contrast/HSV) and channel shuffle")
    p.add_argument("--weights", default=None, dest="backbone_init_weights",
                   help="pretrained backbone: 'imagenet' or a .npz/.pt/.pth path")
    p.add_argument("--device_augment", action="store_true",
                   help="flip/scale/photometric augmentation on the card instead of the host's")
    p.add_argument("--sample_cache", default=None, help="directory for the decoded-sample cache")
    p.add_argument("--sync_bn", action="store_true", help="cross-replica BatchNorm statistics over the data-parallel ranks "
                        "(use when the per-card batch is small, e.g. 1 image a card)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--tensorboard", default=None, metavar="DIR", help="write the training losses to DIR")
    return p


def _explicit_flags(argv):
    """Dests the user actually typed (every default suppressed)."""
    p = build_argparser()
    for a in p._actions:
        if a.dest != "help":
            a.default = argparse.SUPPRESS
    return set(vars(p.parse_args(argv)))


def build_config(args, argv) -> MaskRCNNConfig:
    """The JAX CLI's configuration: without ``--config`` every flag feeds
    ``coco_config``; with it only the flags typed override the YAML."""
    class_names = MINITRAIN_CLASSES if args.minitrain else None
    num_classes = (1 + len(class_names)) if class_names else 81
    provided = _explicit_flags(argv) if args.config else None
    overrides = {}

    def put(key, value, flag):
        if provided is None or flag in provided:
            overrides[key] = value

    put("backbone", args.backbone, "backbone")
    put("epochs", args.epochs, "epochs")
    put("batch_size", args.batch_size, "batch_size")
    put("num_classes", num_classes, "minitrain")
    put("image_shape", (args.img_size, args.img_size, 3), "img_size")
    put("image_min_dim", args.img_size, "img_size")
    put("image_max_dim", args.img_size, "img_size")
    put("learning_rate", args.learning_rate, "learning_rate")
    put("optimizer", args.optimizer, "optimizer")
    put("use_mini_masks", not args.no_mini_masks, "no_mini_masks")
    put("checkpoints_dir", args.checkpoints_dir, "checkpoints_dir")
    put("backbone_init_weights", args.backbone_init_weights, "backbone_init_weights")
    put("augment_on_device", args.device_augment, "device_augment")
    put("augment_scale_jitter", 0.25 if args.device_augment else 0.0, "device_augment")
    put("augment_photometric", 0.2 if args.device_augment else 0.0, "device_augment")
    put("sample_cache_dir", args.sample_cache, "sample_cache")
    put("sync_bn", args.sync_bn, "sync_bn")
    if args.config:
        return MaskRCNNConfig.from_yaml(args.config, **overrides)
    return coco_config(**overrides)


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    group = None
    if os.environ.get("WORLD_SIZE"):  # under torchrun: one rank per card, or gloo ranks on the CPU
        device = device if device.type == "cpu" else distributed.local_device()
        group = distributed.initialize(device=device)
    cfg = build_config(args, argv)
    try:
        check_sync_bn(cfg, group)
    except ValueError as e:
        p.error(str(e))
    primary = distributed.is_primary(group)
    writer = make_tb_writer(args.tensorboard) if args.tensorboard and primary else None
    if args.tensorboard and primary and writer is None:
        p.error("--tensorboard needs the tensorboard package")
    class_names = MINITRAIN_CLASSES if args.minitrain else None

    train_ds = CocoDataset()
    train_ds.load_coco(args.dataset_path, "train", args.year, class_names=class_names, max_images=args.n_train)
    train_ds.prepare()
    val_ds = CocoDataset()
    val_ds.load_coco(args.dataset_path, "val", args.year, class_names=class_names, max_images=args.n_val)
    val_ds.prepare()
    if primary:
        print(f"train: {len(train_ds)} images, val: {len(val_ds)} images, "
              f"{cfg.num_classes} classes, backbone={cfg.backbone}"
              + (f", {distributed.world_size(group)} ranks" if group is not None else ""))

    augment = (
        None
        if (args.no_augment or args.device_augment)
        else get_training_augmentation(extended=args.augment_extended, weather=args.augment_weather)
    )
    return train_model(cfg, train_ds, val_ds, augment_fn=augment, metric_writer=writer, device=device, group=group)


if __name__ == "__main__":
    main()
