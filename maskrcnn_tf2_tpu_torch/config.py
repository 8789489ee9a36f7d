"""Typed configuration of the PyTorch/CUDA port.

The port keeps its own copy of ``maskrcnn_tf2_tpu/config.py`` so that it
imports nothing of the JAX package: the same frozen dataclass, the same knob
names and defaults, ``to_dict``/``from_dict`` and the derived quantities. A
dict written by either package builds the same configuration in the other.
Knobs that only steer a TPU rewrite (``proposal_approx_topk``,
``rpn_slim_inference``, ``quant_*``, the mesh and parallel fields) are kept
for that round trip; the port's inference path reads none of them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Tuple

DEFAULT_CLASS_DICT = {"background": 0, "balloon": 1}


def _tuplify(x):
    if isinstance(x, (list, tuple)):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    """Static hyperparameters for model build, data pipeline and training."""

    # ---- image geometry ----
    image_shape: Tuple[int, int, int] = (512, 512, 3)
    image_min_dim: int = 300
    image_min_scale: float = 0.0
    image_max_dim: int = 512
    image_resize_mode: str = "square"  # square | pad64 | crop | none

    # ---- classes ----
    num_classes: int = len(DEFAULT_CLASS_DICT)

    # ---- normalization: "imagenet" (x/255 - mean) / std, or per-image "maxmin"
    normalization: str = "imagenet"
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    # ---- masks ----
    use_mini_masks: bool = True
    mini_mask_shape: Tuple[int, int] = (56, 56)
    mask_shape: Tuple[int, int] = (28, 28)

    # ---- backbone / FPN ----
    backbone: str = "resnet18"
    backbone_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    top_down_pyramid_size: int = 256
    backbone_init_weights: str | None = None
    train_bn: bool = True
    train_bn_backbone: bool = True
    sync_bn: bool = False

    # ---- anchors ----
    rpn_anchor_scales: Tuple[int, ...] = (32, 64, 128, 256, 512)
    rpn_anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_anchor_stride: int = 1

    # ---- RPN / proposals ----
    rpn_train_anchors_per_image: int = 256
    max_gt_instances: int = 100
    rpn_bbox_std_dev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    bbox_std_dev: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    rpn_nms_threshold: float = 0.7
    use_rpn_rois: bool = True
    random_rois: int = 0
    pre_nms_limit: int = 6000
    post_nms_rois_training: int = 2000
    post_nms_rois_inference: int = 1000
    proposal_approx_topk: bool = True  # TPU-only; the port's top-k is exact
    rpn_slim_inference: bool = True  # TPU-only; the port runs the dense RPN

    # ---- detection ----
    detection_min_confidence: float = 0.7
    detection_nms_threshold: float = 0.3
    detection_max_instances: int = 100

    # ---- ROI heads ----
    train_rois_per_image: int = 200
    roi_positive_ratio: float = 0.33
    pool_size: int = 7
    mask_pool_size: int = 14
    fpn_cls_fc_layers_size: int = 1024
    mask_conv_channels: int = 256
    mask_train_slim: bool = True

    # ---- losses / regularization ----
    loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    weight_decay: float = 2e-4
    l2_reg_batchnorm: bool = False

    # ---- optimizer ----
    optimizer: str = "adamax"
    learning_rate: float = 1e-3
    clipvalue: float | None = 5.0
    clipnorm: float | None = None

    # ---- training loop ----
    epochs: int = 100
    batch_size: int = 1
    log_per_steps: int = 5
    prefetch_size: int = 2

    # ---- device-side augmentation ----
    augment_on_device: bool = False
    augment_flip: bool = True
    augment_scale_jitter: float = 0.0
    augment_photometric: float = 0.0

    sample_cache_dir: str | None = None

    # ---- checkpointing / LR schedule ----
    checkpoints_dir: str = "logs"
    reduce_lr_factor: float = 0.98
    reduce_lr_patience: int = 10
    save_best_only: bool = True

    # ---- activation options ----
    resnet_leaky_relu: bool = False
    mask_head_leaky_relu: bool = False
    cls_head_leaky_relu: bool = False

    # ---- multistage training ----
    tune_rpn_model_only: bool = False
    frozen_backbone: bool = False
    frozen_rpn_model: bool = False
    frozen_mask_head: bool = False
    frozen_cls_head: bool = False

    # ---- compute dtype and the JAX package's device knobs ----
    compute_dtype: str = "bfloat16"  # activations dtype on the card
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    parallel_mode: str = "shard_map"
    tp_shards: int = 1
    quant_mode: str = "off"
    quant_mask_head: bool = False
    quant_classifier: bool = False
    debug_nans: bool = False
    nonfinite_guard: str = "loss"

    # ------------------------------------------------------------------
    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list):
                object.__setattr__(self, f.name, _tuplify(v))
        if self.image_resize_mode not in ("square", "pad64", "crop", "none"):
            raise ValueError(f"image_resize_mode {self.image_resize_mode!r}")
        if self.normalization not in ("imagenet", "maxmin"):
            raise ValueError(f"normalization {self.normalization!r}")
        if len(self.rpn_anchor_scales) != len(self.backbone_strides):
            raise ValueError("one anchor scale per pyramid level")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    # ---- derived quantities ----
    @property
    def meta_size(self) -> int:
        """``[image_id(1), original_shape(3), resized_shape(3), window(4),
        scale(1), active_class_ids(num_classes)]``."""
        return 1 + 3 + 3 + 4 + 1 + self.num_classes

    @property
    def num_pyramid_levels(self) -> int:
        return len(self.backbone_strides)

    @property
    def anchors_per_location(self) -> int:
        return len(self.rpn_anchor_ratios)

    def backbone_feature_shapes(self) -> Tuple[Tuple[int, int], ...]:
        h, w = self.image_shape[0], self.image_shape[1]
        return tuple(
            (int((h + s - 1) // s), int((w + s - 1) // s))
            for s in self.backbone_strides
        )

    def num_anchors(self) -> int:
        return sum(
            hh * ww * self.anchors_per_location
            for hh, ww in self.backbone_feature_shapes()
        )

    def post_nms_rois(self, training: bool) -> int:
        return self.post_nms_rois_training if training else self.post_nms_rois_inference

    # ---- construction / serialization ----
    def replace(self, **kw) -> "MaskRCNNConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MaskRCNNConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def md5(self) -> str:
        """Hash of every knob, named in checkpoint directories. The port's
        fields and defaults are the JAX package's, so one configuration
        hashes the same in both."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.md5(blob.encode()).hexdigest()

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=True)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "MaskRCNNConfig":
        """A configuration from a YAML file, ``overrides`` winning; an unknown
        key raises."""
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f) or {}
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        d.update(overrides)
        return cls(**d)


def coco_config(**overrides) -> MaskRCNNConfig:
    """The COCO preset (the JAX package's ``coco_config``, after the
    reference's COCO_CONFIG): 81 classes, 512x512, 100 GT instances, 56x56
    mini masks; ``overrides`` win."""
    base = dict(
        num_classes=81,
        image_shape=(512, 512, 3),
        image_min_dim=512,
        image_max_dim=512,
        max_gt_instances=100,
        use_mini_masks=True,
        mini_mask_shape=(56, 56),
    )
    base.update(overrides)
    return MaskRCNNConfig(**base)
