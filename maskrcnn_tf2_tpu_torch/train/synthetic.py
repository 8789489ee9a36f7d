"""Seeded synthetic training data, for smoke runs and profiles on the card: a
batch of tensors, datasets of shapes images written as a COCO directory, and
``state_dict``s in the five pretrained-weights layouts the port reads
(torchvision ResNet, timm SE-ResNet/SENet154, torchvision MobileNet V2, timm
MobileNet V1, timm EfficientNet) to stand in for ImageNet weights."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.data.coco import CocoDataset
from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
from maskrcnn_tf2_tpu_torch.data.synthetic_coco import export_coco_format
from maskrcnn_tf2_tpu_torch.models.backbones.efficientnet import (_BLOCK_ARGS, EFFICIENTNET_PARAMS, round_filters,
                                                                  round_repeats)
from maskrcnn_tf2_tpu_torch.models.backbones.mobilenet import MobileNetV1, MobileNetV2
from maskrcnn_tf2_tpu_torch.models.backbones.resnet import RESNET_VARIANTS
from maskrcnn_tf2_tpu_torch.ops.image import compose_image_meta


def smooth_image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Blocky colour noise plus grain: features that are not flat."""
    x = rs.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
    x = np.repeat(np.repeat(x, 16, axis=0), 16, axis=1)[:h, :w]
    return np.clip(x + rs.normal(0, 10, x.shape), 0, 255).astype(np.uint8)


def synthetic_batch(config, batch_size: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """uint8 images at ``image_shape``, 2-8 GT boxes per image with classes in
    ``1..num_classes-1`` (zero-padded to ``max_gt_instances``), and elliptic
    mini masks at ``mini_mask_shape``."""
    rs = np.random.RandomState(seed)
    h, w, _ = config.image_shape
    g, (mh, mw) = config.max_gt_instances, config.mini_mask_shape
    ids = np.zeros((batch_size, g), np.int32)
    boxes = np.zeros((batch_size, g, 4), np.float32)
    yy, xx = np.mgrid[0:mh, 0:mw]
    ellipse = ((yy - (mh - 1) / 2) / (mh / 2)) ** 2 + ((xx - (mw - 1) / 2) / (mw / 2)) ** 2 <= 1.0
    masks = np.zeros((batch_size, g, mh, mw), np.float32)
    for i in range(batch_size):
        k = rs.randint(2, 9)
        y1, x1 = rs.uniform(0, 0.6, (2, k))
        bh, bw = rs.uniform(0.1, 0.4, (2, k))
        boxes[i, :k] = np.stack([y1, x1, y1 + bh, x1 + bw], -1)
        ids[i, :k] = rs.randint(1, config.num_classes, k)
        masks[i, :k] = ellipse
    meta = compose_image_meta(0, (h, w, 3), (h, w, 3), (0, 0, h, w), 1.0, np.ones(config.num_classes))
    batch = {
        "images": np.stack([smooth_image(rs, h, w) for _ in range(batch_size)]),
        "image_meta": np.tile(meta, (batch_size, 1)),
        "gt_class_ids": ids,
        "gt_boxes": boxes,
        "gt_masks": masks,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def shapes_coco_datasets(root: str, counts=(12, 4), size: int = 512, seed: int = 0,
                         class_names: Optional[Sequence[str]] = None) -> List[CocoDataset]:
    """``SyntheticShapesDataset`` sets of ``counts`` images (up to 6 shapes of
    3 classes each, ``size`` a side) written under ``root`` as the COCO
    subsets ``train``, ``val``, ... (JPEG images, RLE masks; needs Pillow) and
    read back through ``CocoDataset``, the path a user's data takes.
    ``class_names`` (background first; ``data.coco.COCO_CLASS_NAMES`` for
    COCO's 80 categories) names the categories written, the shapes taking the
    first three; by default they are the shapes'."""
    out = []
    for i, (n, subset) in enumerate(zip(counts, ("train", "val", "test"))):
        ds = SyntheticShapesDataset()
        ds.load_shapes(n, size, size, max_shapes=6, seed=seed + i)
        ds.prepare()
        export_coco_format(ds, root, subset=subset, class_names=class_names)
        coco = CocoDataset()
        coco.load_coco(root, subset)
        coco.prepare()
        out.append(coco)
    return out


class _SeededStateDict:
    """Seeded tensors under a weights file's own names: kernels normal with
    std 1/sqrt(fan_in), batch-norm scales and variances in [0.5, 1.5), biases
    and means normal with std 0.1, classifier biases zero."""

    def __init__(self, seed: int):
        self.rs = np.random.RandomState(seed)
        self.sd: Dict[str, torch.Tensor] = {}

    def _put(self, name: str, value: np.ndarray) -> None:
        self.sd[name] = torch.from_numpy(np.asarray(value, np.float32))

    def conv(self, name: str, cout: int, cin: int, k: int, bias: bool = False) -> None:
        """``cin`` is the input channels of one group (1 for a depthwise conv)."""
        self._put(name + ".weight", self.rs.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k))
        if bias:
            self._put(name + ".bias", self.rs.normal(0, 0.1, cout))

    def bn(self, name: str, c: int) -> None:
        for leaf, draw in (("weight", lambda: self.rs.uniform(0.5, 1.5, c)), ("bias", lambda: self.rs.normal(0, 0.1, c)),
                           ("running_mean", lambda: self.rs.normal(0, 0.1, c)),
                           ("running_var", lambda: self.rs.uniform(0.5, 1.5, c))):
            self._put(f"{name}.{leaf}", draw())
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def conv_bn(self, conv: str, bn: str, cout: int, cin: int, k: int) -> None:
        self.conv(conv, cout, cin, k)
        self.bn(bn, cout)

    def classifier(self, name: str, cin: int) -> Dict[str, torch.Tensor]:
        self._put(name + ".weight", self.rs.normal(size=(1000, cin)) / np.sqrt(cin))
        self.sd[name + ".bias"] = torch.zeros(1000)
        return self.sd


def resnet_state_dict(variant, seed: int, layout: str = "torchvision") -> Dict[str, torch.Tensor]:
    """A ResNet-family ``state_dict`` for ``variant`` (a key of
    ``RESNET_VARIANTS`` or its constructor kwargs) under a file layout's
    names, at the port's shapes, with the 1000-class classifier:

    - ``"torchvision"`` (ResNet, ResNeXt): ``conv1``, ``bn1``,
      ``layer{s}.{b}.conv{i}``/``bn{i}``, ``downsample.0/1``, ``fc``;
    - ``"timm"`` (``legacy_seresnet*``, ``legacy_senet154``): the stem as
      ``layer0.conv1``/``bn1`` (``conv1..3``/``bn1..3`` for the deep stem),
      squeeze-excite as 1x1 convs with bias ``layer{s}.{b}.se_module.fc{1,2}``,
      ``last_linear``."""
    kw = RESNET_VARIANTS[variant] if isinstance(variant, str) else variant
    bottleneck = kw.get("block", "basic") == "bottleneck"
    groups, base_width = kw.get("groups", 1), kw.get("base_width", 64)
    timm = layout == "timm"
    w = _SeededStateDict(seed)
    if kw.get("deep_stem", False):
        for i, (cout, cin) in enumerate(((64, 3), (64, 64), (128, 64)), start=1):
            w.conv_bn(f"layer0.conv{i}", f"layer0.bn{i}", cout, cin, 3)
        cin = 128
    else:
        w.conv_bn("layer0.conv1" if timm else "conv1", "layer0.bn1" if timm else "bn1", 64, 3, 7)
        cin = 64
    for s, blocks in enumerate(kw["stage_sizes"], start=1):
        planes = 64 * 2 ** (s - 1)
        width = int(planes * base_width / 64) * groups
        out = planes * 4 if bottleneck else planes
        for b in range(blocks):
            pre = f"layer{s}.{b}"
            convs = ([(width, cin, 1), (width, width // groups, 3), (out, width, 1)] if bottleneck
                     else [(planes, cin, 3), (planes, planes, 3)])
            for i, (cout, c, k) in enumerate(convs, start=1):
                w.conv_bn(f"{pre}.conv{i}", f"{pre}.bn{i}", cout, c, k)
            if kw.get("use_se", False):
                hidden = max(out // 16, 1)
                w.conv(f"{pre}.se_module.fc1", hidden, out, 1, bias=True)
                w.conv(f"{pre}.se_module.fc2", out, hidden, 1, bias=True)
            if cin != out or (b == 0 and s > 1):  # the shortcut changes shape
                w.conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1", out, cin, 1)
            cin = out
    return w.classifier("last_linear" if timm else "fc", cin)


def torchvision_mobilenet_v2_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """torchvision ``mobilenet_v2``'s names and shapes: ``features.0`` the
    stem, ``features.1..17`` the inverted residuals (``conv.0.0``/``conv.0.1``
    expand, ``conv.1.0``/``conv.1.1`` depthwise, ``conv.2``/``conv.3`` project;
    without the expansion ``conv.0.*`` depthwise and ``conv.1``/``conv.2``
    project), ``features.18`` the 1280-wide head conv, ``classifier.1``."""
    w = _SeededStateDict(seed)
    w.conv_bn("features.0.0", "features.0.1", 32, 3, 3)
    cin, i = 32, 1
    for expand, cout, repeats, _ in MobileNetV2.SCHEDULE:
        for _ in range(repeats):
            pre, mid = f"features.{i}.conv", cin * expand
            if expand != 1:
                w.conv_bn(f"{pre}.0.0", f"{pre}.0.1", mid, cin, 1)
                dw, project = ("1.0", "1.1"), ("2", "3")
            else:
                dw, project = ("0.0", "0.1"), ("1", "2")
            w.conv_bn(f"{pre}.{dw[0]}", f"{pre}.{dw[1]}", mid, 1, 3)
            w.conv_bn(f"{pre}.{project[0]}", f"{pre}.{project[1]}", cout, mid, 1)
            cin, i = cout, i + 1
    w.conv_bn("features.18.0", "features.18.1", 1280, cin, 1)
    return w.classifier("classifier.1", 1280)


def timm_mobilenet_v1_state_dict(seed: int) -> Dict[str, torch.Tensor]:
    """timm ``mobilenetv1_100``'s names and shapes: ``conv_stem``/``bn1``, then
    13 depthwise-separable ``blocks.{s}.{b}`` in stages of 1, 2, 2, 6 and 2
    (``conv_dw``/``bn1``, ``conv_pw``/``bn2``), ``classifier``."""
    w = _SeededStateDict(seed)
    w.conv_bn("conv_stem", "bn1", 32, 3, 3)
    cin, plan = 32, iter(MobileNetV1.PLAN)
    for s, blocks in enumerate((1, 2, 2, 6, 2)):
        for b in range(blocks):
            cout, _ = next(plan)
            w.conv_bn(f"blocks.{s}.{b}.conv_dw", f"blocks.{s}.{b}.bn1", cin, 1, 3)
            w.conv_bn(f"blocks.{s}.{b}.conv_pw", f"blocks.{s}.{b}.bn2", cout, cin, 1)
            cin = cout
    return w.classifier("classifier", cin)


def timm_efficientnet_state_dict(backbone: str, seed: int) -> Dict[str, torch.Tensor]:
    """timm ``efficientnet_b*``'s names and shapes for ``backbone``
    (``efficientnetb0``..``b7``): ``conv_stem``/``bn1``; ``blocks.{s}.{b}``
    with ``conv_pw``/``bn1``, ``conv_dw``/``bn2``, ``se.conv_reduce``/
    ``se.conv_expand`` (1x1 convs with bias), ``conv_pwl``/``bn3``, or in the
    unexpanded blocks ``conv_dw``/``bn1``, the SE convs, ``conv_pw``/``bn2``;
    then ``conv_head``/``bn2`` and ``classifier``."""
    width, depth = EFFICIENTNET_PARAMS[backbone]
    w = _SeededStateDict(seed)
    cin = round_filters(32, width)
    w.conv_bn("conv_stem", "bn1", cin, 3, 3)
    for s, (kernel, _, expand, features, repeats) in enumerate(_BLOCK_ARGS):
        cout = round_filters(features, width)
        for b in range(round_repeats(repeats, depth)):
            pre, mid, se = f"blocks.{s}.{b}", cin * expand, max(1, int(cin * 0.25))
            if expand != 1:
                w.conv_bn(f"{pre}.conv_pw", f"{pre}.bn1", mid, cin, 1)
            w.conv_bn(f"{pre}.conv_dw", f"{pre}.bn2" if expand != 1 else f"{pre}.bn1", mid, 1, kernel)
            w.conv(f"{pre}.se.conv_reduce", se, mid, 1, bias=True)
            w.conv(f"{pre}.se.conv_expand", mid, se, 1, bias=True)
            if expand != 1:
                w.conv_bn(f"{pre}.conv_pwl", f"{pre}.bn3", cout, mid, 1)
            else:
                w.conv_bn(f"{pre}.conv_pw", f"{pre}.bn2", cout, mid, 1)
            cin = cout
    head = round_filters(1280, width)
    w.conv_bn("conv_head", "bn2", head, cin, 1)
    return w.classifier("classifier", head)
