"""COCO instances datasets, with no pycocotools (counterpart of
``maskrcnn_tf2_tpu/data/coco.py``).

Instances-JSON loading, a class registry with contiguous internal ids,
polygon and RLE segmentations to binary masks, and the crowd -> negative
class id convention. The RLE codec is the public COCO mask-RLE spec
(column-major runs; compressed counts are base-48 varints) in numpy; the JAX
package's native C decoder (``native/rle.py``) is not ported. Polygons are
filled through ``data/raster.py``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from maskrcnn_tf2_tpu_torch.data import raster
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset

# The 80 COCO thing classes and the background, in the order of the
# reference's COCO_CONFIG class dict.
COCO_CLASS_NAMES = [
    "background", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def _decode_rle_counts(s: str) -> List[int]:
    """COCO compressed RLE counts string -> run lengths."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    """RLE dict (``{"counts": str | list, "size": [h, w]}``) -> bool mask ``[h, w]``."""
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decode_rle_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    vals = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(counts)  # runs alternate 0-runs and 1-runs, column-major
    starts = ends - counts
    for j in range(1, len(counts), 2):
        vals[starts[j] : ends[j]] = 1
    if total < h * w:
        vals = np.pad(vals, (0, h * w - total))
    return vals[: h * w].reshape(w, h).T.astype(bool)


def mask_to_rle(mask: np.ndarray) -> Dict:
    """bool mask ``[h, w]`` -> uncompressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(np.uint8)
    change = np.nonzero(np.diff(flat))[0] + 1  # runs, starting with a 0-run
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return {"counts": runs.tolist(), "size": [h, w]}


def annotation_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygons or RLE) -> bool mask ``[h, w]``."""
    seg = ann["segmentation"]
    if isinstance(seg, list):  # polygons, each filled on its own
        canvas = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.round(np.asarray(poly, np.float64).reshape(-1, 2)).astype(np.int32)
            raster.fill_polygon(canvas, pts, 1)
        return canvas.astype(bool)
    if isinstance(seg, dict):
        return rle_to_mask(seg, h, w)
    raise ValueError(f"unsupported segmentation type: {type(seg)}")


class CocoDataset(SegmentationDataset):
    """COCO instances dataset; ``load_coco`` filters classes and caps the
    image count."""

    def load_coco(
        self,
        dataset_dir: str,
        subset: str,
        year: str = "2017",
        class_ids: Optional[Sequence[int]] = None,
        class_names: Optional[Sequence[str]] = None,
        max_images: Optional[int] = None,
        annotations_path: Optional[str] = None,
        images_dir: Optional[str] = None,
    ):
        ann_path = annotations_path or os.path.join(dataset_dir, "annotations", f"instances_{subset}{year}.json")
        img_dir = images_dir or os.path.join(dataset_dir, f"{subset}{year}")
        with open(ann_path) as f:
            coco = json.load(f)

        cats = {c["id"]: c for c in coco["categories"]}
        if class_names:
            name_to_id = {c["name"]: c["id"] for c in coco["categories"]}
            class_ids = [name_to_id[n] for n in class_names]
        use_cats = [cid for cid in sorted(cats) if cid in set(class_ids)] if class_ids else sorted(cats)
        for cid in use_cats:
            self.add_class("coco", cid, cats[cid]["name"])

        wanted = set(use_cats)
        anns_by_image = defaultdict(list)
        for ann in coco["annotations"]:
            if ann["category_id"] in wanted:
                anns_by_image[ann["image_id"]].append(ann)

        images = coco["images"]
        if class_ids:
            images = [im for im in images if anns_by_image.get(im["id"])]
        if max_images:
            images = images[:max_images]
        for im in images:
            self.add_image("coco", image_id=im["id"], path=os.path.join(img_dir, im["file_name"]),
                           width=im["width"], height=im["height"], annotations=anns_by_image.get(im["id"], []))

    def load_mask(self, idx: int):
        info = self._image_info[idx]
        h, w = info["height"], info["width"]
        masks, class_ids = [], []
        for ann in info["annotations"]:
            cls = self.class_from_source.get(f"coco.{ann['category_id']}")
            if cls is None:
                continue
            m = annotation_to_mask(ann, h, w)
            if not m.any():
                continue
            masks.append(m)
            class_ids.append(-cls if ann.get("iscrowd", 0) else cls)
        if not masks:
            return np.zeros((h, w, 0), bool), np.zeros((0,), np.int32)
        return np.stack(masks, axis=-1), np.asarray(class_ids, np.int32)
