"""Dataset registry, the VIA-JSON adapter and per-image GT assembly
(counterpart of ``maskrcnn_tf2_tpu/data/dataset.py``).

Subclasses register images and implement ``load_image``/``load_mask``;
``load_image_gt`` assembles one fixed-shape training sample on the host
(resized image, meta vector, normalized GT boxes, class ids, mini masks).
Images are read through ``data/image_io.py`` (Pillow) and polygons filled
through ``data/raster.py``, where the JAX package uses cv2.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import image_io, raster, transforms
from maskrcnn_tf2_tpu_torch.ops.anchors import norm_boxes_np
from maskrcnn_tf2_tpu_torch.ops.image import compose_image_meta


class SegmentationDataset:
    """A registry of images and classes. Class 0 is the background;
    ``source`` tags each class with its dataset of origin, so that a
    multi-dataset run masks the inactive classes in the loss
    (``active_class_ids``)."""

    def __init__(self):
        self._image_info: List[Dict] = []
        self.class_info: List[Dict] = [{"source": "", "id": 0, "name": "background"}]
        self.source_class_ids: Dict[str, List[int]] = {}

    def add_class(self, source: str, class_id: int, class_name: str):
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return
        self.class_info.append({"source": source, "id": class_id, "name": class_name})

    def add_image(self, source: str, image_id, path: Optional[str], **kwargs):
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self._image_info.append(info)

    def prepare(self):
        """Contiguous internal class ids and the per-source class lists."""
        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [c["name"] for c in self.class_info]
        self.num_images = len(self._image_info)
        self.class_from_source = {f"{c['source']}.{c['id']}": i for i, c in enumerate(self.class_info)}
        sources = {c["source"] for c in self.class_info if c["source"]}
        self.source_class_ids = {
            s: [0] + [i for i, c in enumerate(self.class_info) if i > 0 and c["source"] == s] for s in sources
        }

    @property
    def image_info(self):
        return self._image_info

    def __len__(self):
        return len(self._image_info)

    def image_reference(self, idx: int):
        return self._image_info[idx].get("path")

    def load_image(self, idx: int) -> np.ndarray:
        """RGB uint8 ``[H, W, 3]``."""
        return image_io.imread(self._image_info[idx]["path"])

    def load_mask(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(masks [H, W, N] bool, class_ids [N] int32)``."""
        raise NotImplementedError

    def active_class_ids(self, idx: int) -> np.ndarray:
        source = self._image_info[idx]["source"]
        active = np.zeros((self.num_classes,), np.float32)
        active[self.source_class_ids.get(source, list(range(self.num_classes)))] = 1.0
        return active


class VIADataset(SegmentationDataset):
    """VGG Image Annotator JSON datasets: polygon regions, a class per
    region from its ``region_attributes["class"]`` (1 when absent)."""

    def load_via(self, dataset_dir: str, annotations_json: str, class_dict: Dict[str, int], source: str = "via"):
        for name, cid in class_dict.items():
            if cid != 0:
                self.add_class(source, cid, name)
        with open(os.path.join(dataset_dir, annotations_json)) as f:
            annotations = json.load(f)
        if isinstance(annotations, dict):
            annotations = list(annotations.values())
        for ann in annotations:
            regions = ann.get("regions")
            if not regions:
                continue
            if isinstance(regions, dict):
                regions = list(regions.values())
            path = os.path.join(dataset_dir, ann["filename"])
            try:
                h, w = image_io.imread(path).shape[:2]
            except OSError:  # missing or unreadable: skipped, as the JAX package skips it
                continue
            self.add_image(
                source,
                image_id=ann["filename"],
                path=path,
                width=w,
                height=h,
                polygons=[r["shape_attributes"] for r in regions],
                region_classes=[r.get("region_attributes", {}).get("class", None) for r in regions],
                class_dict=class_dict,
            )

    def load_mask(self, idx: int):
        info = self._image_info[idx]
        n = len(info["polygons"])
        masks = np.zeros((info["height"], info["width"], n), dtype=bool)
        class_ids = np.ones((n,), np.int32)
        for i, poly in enumerate(info["polygons"]):
            pts = np.stack([poly["all_points_x"], poly["all_points_y"]], axis=1).astype(np.int32)
            canvas = np.zeros((info["height"], info["width"]), np.uint8)
            masks[:, :, i] = raster.fill_polygon(canvas, pts, 1).astype(bool)
            cls_name = info["region_classes"][i]
            if cls_name is not None and cls_name in info["class_dict"]:
                class_ids[i] = info["class_dict"][cls_name]
        return masks, class_ids


def load_image_gt(
    dataset: SegmentationDataset,
    config: MaskRCNNConfig,
    idx: int,
    augment_fn: Optional[Callable] = None,
    rng: Optional[np.random.RandomState] = None,
):
    """One fixed-shape training sample on the host: load -> resize image and
    masks -> optional ``augment_fn(image, masks, py_rng, np_rng)`` (the host
    augmentation of ``data/augment.py``) -> drop empty masks ->
    subsample to ``max_gt_instances`` -> boxes from masks -> mini masks ->
    meta. GT boxes come back normalized.

    ``rng`` draws the subsample (``rng.choice``, which draws what the JAX
    package's global ``np.random.choice`` draws after ``np.random.seed`` of
    the same seed) and seeds, in ``crop`` mode, the crop's generator and then,
    with ``augment_fn``, the augmentation's ``random.Random`` and
    ``RandomState``; without ``augment_fn`` it draws nothing for them.

    Returns a dict with ``image`` uint8 ``[H, W, 3]``, ``image_meta [M]``,
    ``gt_class_ids [G]``, ``gt_boxes [G, 4]``, ``gt_masks [G, mh, mw]`` uint8,
    ``window`` and ``original_shape``; or None if no instance is left.
    """
    rng = rng if rng is not None else np.random.RandomState()
    image = dataset.load_image(idx)
    masks, class_ids = dataset.load_mask(idx)
    original_shape = image.shape

    crop_rng = random.Random(int(rng.randint(2**31 - 1))) if config.image_resize_mode == "crop" else None
    image, window, scale, padding, crop = transforms.resize_image(
        image,
        min_dim=config.image_min_dim,
        max_dim=config.image_max_dim,
        min_scale=config.image_min_scale,
        mode=config.image_resize_mode,
        rng=crop_rng,
    )
    masks = transforms.resize_mask(masks, scale, padding, crop)
    if augment_fn is not None:  # its two generators drawn from rng, as the crop's is
        py_rng = random.Random(int(rng.randint(2**31 - 1)))
        np_rng = np.random.RandomState(int(rng.randint(2**31 - 1)))
        image, masks = augment_fn(image, masks, py_rng, np_rng)

    keep = np.where(masks.any(axis=(0, 1)))[0]  # instances that cropping or augmenting emptied
    masks = masks[:, :, keep]
    class_ids = np.asarray(class_ids)[keep]
    if class_ids.size == 0:
        return None

    g = config.max_gt_instances
    if class_ids.shape[0] > g:
        sel = rng.choice(class_ids.shape[0], g, replace=False)
        masks = masks[:, :, sel]
        class_ids = class_ids[sel]

    boxes_pix = transforms.extract_bboxes(masks).astype(np.float32)
    boxes = norm_boxes_np(boxes_pix, image.shape[:2])
    masks_out = transforms.minimize_mask(boxes_pix, masks, tuple(config.mini_mask_shape)) if config.use_mini_masks else masks
    masks_out = np.transpose(masks_out, (2, 0, 1)).astype(np.uint8)  # [N, h, w]

    n = class_ids.shape[0]
    mh, mw = masks_out.shape[1:]
    gt_class_ids = np.zeros((g,), np.int32)
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_masks = np.zeros((g, mh, mw), np.uint8)
    gt_class_ids[:n] = class_ids
    gt_boxes[:n] = boxes
    gt_masks[:n] = masks_out
    meta = compose_image_meta(idx, original_shape, image.shape, window, scale, dataset.active_class_ids(idx))
    return {
        "image": image.astype(np.uint8),
        "image_meta": meta,
        "gt_class_ids": gt_class_ids,
        "gt_boxes": gt_boxes,
        "gt_masks": gt_masks,
        "window": np.asarray(window, np.float32),
        "original_shape": np.asarray(original_shape, np.int32),
    }
