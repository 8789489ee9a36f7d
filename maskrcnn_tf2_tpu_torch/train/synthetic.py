"""Seeded synthetic training data, for smoke runs and profiles on the card: a
batch of tensors, or datasets of shapes images written as a COCO directory."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.data.coco import CocoDataset
from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
from maskrcnn_tf2_tpu_torch.data.synthetic_coco import export_coco_format
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


def shapes_coco_datasets(root: str, counts=(12, 4), size: int = 512, seed: int = 0) -> List[CocoDataset]:
    """``SyntheticShapesDataset`` sets of ``counts`` images (up to 6 shapes of
    3 classes each, ``size`` a side) written under ``root`` as the COCO
    subsets ``train``, ``val``, ... (JPEG images, RLE masks; needs Pillow) and
    read back through ``CocoDataset``, the path a user's data takes."""
    out = []
    for i, (n, subset) in enumerate(zip(counts, ("train", "val", "test"))):
        ds = SyntheticShapesDataset()
        ds.load_shapes(n, size, size, max_shapes=6, seed=seed + i)
        ds.prepare()
        export_coco_format(ds, root, subset=subset)
        coco = CocoDataset()
        coco.load_coco(root, subset)
        coco.prepare()
        out.append(coco)
    return out
