"""Export any ``SegmentationDataset`` as an on-disk COCO-format dataset
(counterpart of ``maskrcnn_tf2_tpu/data/synthetic_coco.py``):
``{root}/{subset}{year}/*.jpg`` and
``{root}/annotations/instances_{subset}{year}.json`` with per-instance RLE
segmentations. Masks round-trip exactly through the RLE codec; JPEG pixels
are lossy. Images are written through ``data/image_io.py`` (Pillow).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from maskrcnn_tf2_tpu_torch.data import image_io
from maskrcnn_tf2_tpu_torch.data.coco import mask_to_rle
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset


def export_coco_format(
    dataset: SegmentationDataset,
    root: str,
    subset: str = "train",
    year: str = "2017",
    jpeg_quality: int = 95,
    max_images: Optional[int] = None,
    class_names: Optional[Sequence[str]] = None,
) -> str:
    """Render ``dataset`` to ``root`` in the COCO instances layout; returns
    the annotations JSON path. Category ids are the dataset's internal ids
    (background excluded), so a model trained on ``dataset`` and one trained
    on the export share class numbers. ``class_names`` (background first, at
    least the dataset's classes) replaces the dataset's names and may list
    more categories than it uses."""
    img_dir = os.path.join(root, f"{subset}{year}")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    categories = [{"id": int(cid), "name": name, "supercategory": "shape"}
                  for cid, name in enumerate(class_names or dataset.class_names) if cid != 0]

    images, annotations = [], []
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for idx in range(n):
        img = dataset.load_image(idx)
        h, w = img.shape[:2]
        file_name = f"{subset}_{idx:06d}.jpg"
        image_io.imwrite(os.path.join(img_dir, file_name), img, jpeg_quality)
        image_id = idx + 1  # COCO ids are 1-based
        images.append({"id": image_id, "file_name": file_name, "width": w, "height": h})
        masks, class_ids = dataset.load_mask(idx)
        for i in range(masks.shape[-1]):
            m = masks[..., i].astype(bool)
            ys, xs = np.nonzero(m)
            if ys.size == 0:
                continue
            y1, x1, y2, x2 = int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1
            cid = int(class_ids[i])
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": image_id,
                "category_id": abs(cid),
                "segmentation": mask_to_rle(m),
                "area": int(m.sum()),
                "bbox": [x1, y1, x2 - x1, y2 - y1],  # COCO xywh
                "iscrowd": 1 if cid < 0 else 0,
            })

    ann_path = os.path.join(ann_dir, f"instances_{subset}{year}.json")
    with open(ann_path, "w") as f:
        json.dump({"info": {"description": "synthetic COCO-format export"}, "images": images,
                   "annotations": annotations, "categories": categories}, f)
    return ann_path
