"""Synthetic shapes dataset (counterpart of
``maskrcnn_tf2_tpu/data/synthetic.py``): circles, squares and triangles on
noise backgrounds, the class being the shape. The same registration draws
from ``RandomState(seed)`` as the JAX package, drawn through
``data/raster.py`` where it uses cv2.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.data import raster
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset

SHAPE_CLASSES = {"background": 0, "circle": 1, "square": 2, "triangle": 3}


class SyntheticShapesDataset(SegmentationDataset):
    def load_shapes(self, count: int, height: int = 128, width: int = 128, max_shapes: int = 4, seed: int = 0):
        for name, cid in SHAPE_CLASSES.items():
            if cid:
                self.add_class("shapes", cid, name)
        rng = np.random.RandomState(seed)
        for i in range(count):
            n = rng.randint(1, max_shapes + 1)
            shapes = []
            for _ in range(n):
                kind = rng.randint(1, 4)
                size = rng.randint(height // 8, height // 4)
                cy = rng.randint(size, height - size)
                cx = rng.randint(size, width - size)
                color = tuple(int(c) for c in rng.randint(60, 255, 3))
                shapes.append((kind, cy, cx, size, color))
            self.add_image("shapes", image_id=i, path=None, height=height, width=width, shapes=shapes,
                           bg_seed=int(rng.randint(0, 2**31 - 1)))

    @staticmethod
    def _draw(canvas, kind, cy, cx, size, color):
        if kind == 1:
            return raster.fill_circle(canvas, (cx, cy), size, color)
        if kind == 2:
            return raster.fill_rectangle(canvas, (cx - size, cy - size), (cx + size, cy + size), color)
        return raster.fill_polygon(canvas, [[cx, cy - size], [cx - size, cy + size], [cx + size, cy + size]], color)

    def load_image(self, idx: int) -> np.ndarray:
        info = self._image_info[idx]
        rng = np.random.RandomState(info["bg_seed"])
        img = rng.randint(0, 50, (info["height"], info["width"], 3)).astype(np.uint8)
        for kind, cy, cx, size, color in info["shapes"]:
            self._draw(img, kind, cy, cx, size, color)
        return img

    def load_mask(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        info = self._image_info[idx]
        h, w = info["height"], info["width"]
        n = len(info["shapes"])
        masks = np.zeros((h, w, n), bool)
        class_ids = np.zeros((n,), np.int32)
        occupied = np.zeros((h, w), bool)
        for i in reversed(range(n)):  # later shapes occlude earlier ones, as when drawn
            kind, cy, cx, size, _ = info["shapes"][i]
            m = self._draw(np.zeros((h, w), np.uint8), kind, cy, cx, size, 1).astype(bool) & ~occupied
            occupied |= m
            masks[:, :, i] = m
            class_ids[i] = kind
        keep = masks.any(axis=(0, 1))
        return masks[:, :, keep], class_ids[keep]
