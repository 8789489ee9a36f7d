"""Random ROIs for head-only training with ``use_rpn_rois=False`` (a numpy
copy of ``maskrcnn_tf2_tpu/data/random_rois.py``): 90 % of the ROIs jittered
around the GT boxes, the rest uniform over the image; normalized and
zero-padded, attached by the loader as ``input_rois``."""

from __future__ import annotations

import numpy as np


def generate_random_rois(image_shape, count: int, gt_boxes: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """``gt_boxes [G, 4]`` normalized, zero-padded -> ``[count, 4]`` normalized."""
    valid = gt_boxes[(gt_boxes[:, 2] > gt_boxes[:, 0])]
    rois = np.zeros((count, 4), np.float32)

    n_around = int(count * 0.9) if len(valid) else 0
    if n_around:
        per_gt = max(1, n_around // len(valid))
        k = 0
        for gt in valid:
            gh = gt[2] - gt[0]
            gw = gt[3] - gt[1]
            for _ in range(per_gt):
                if k >= n_around:
                    break
                cy = (gt[0] + gt[2]) / 2 + rng.uniform(-gh, gh)
                cx = (gt[1] + gt[3]) / 2 + rng.uniform(-gw, gw)
                hh = gh * rng.uniform(0.5, 1.5)
                ww = gw * rng.uniform(0.5, 1.5)
                rois[k] = [cy - hh / 2, cx - ww / 2, cy + hh / 2, cx + ww / 2]
                k += 1
        n_around = k
    for i in range(n_around, count):
        y1, x1 = rng.uniform(0, 0.9, 2)
        rois[i] = [y1, x1, y1 + rng.uniform(0.05, 1 - y1), x1 + rng.uniform(0.05, 1 - x1)]
    return np.clip(rois, 0.0, 1.0)
