"""Inference I/O on the host: resize + meta in, unmold out (counterpart of
``maskrcnn_tf2_tpu/export/inference.py``).

Resizing and unmolding are ``data/transforms.py``'s, in every resize mode;
that module says where they differ from the JAX package's cv2 versions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.transforms import resize_image, unmold_mask
from maskrcnn_tf2_tpu_torch.ops.image import compose_image_meta


def process_input(
    image: np.ndarray, config: MaskRCNNConfig, image_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB image -> (molded image in the input dtype, meta vector).
    Normalization happens on the device inside the model."""
    original_shape = image.shape
    molded, window, scale, _, _ = resize_image(
        image,
        min_dim=config.image_min_dim,
        max_dim=config.image_max_dim,
        min_scale=config.image_min_scale,
        mode=config.image_resize_mode,
    )
    meta = compose_image_meta(
        image_id, original_shape, molded.shape, window, scale,
        np.ones(config.num_classes, np.float32),
    )
    return molded, meta


def unmold_detections(
    detections: np.ndarray, masks: np.ndarray, original_shape, image_shape, window
) -> Dict[str, np.ndarray]:
    """One image's padded outputs -> original-image-space results.

    ``detections [D, 6]`` normalized; ``masks [D, mh, mw, C]`` per class, or
    ``[D, mh, mw]`` already gathered at each detection's class on the device
    (the ``Predictor``'s path). Returns
    rois ``[N, 4]`` pixel int32, class_ids ``[N]``, scores ``[N]`` and masks
    ``[H0, W0, N]`` bool.
    """
    zero_ix = np.where(detections[:, 4] == 0)[0]
    n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]

    boxes = detections[:n, :4].copy()
    class_ids = detections[:n, 4].astype(np.int32)
    scores = detections[:n, 5]
    masks = masks[np.arange(n), :, :, class_ids] if masks.ndim == 4 else masks[:n]

    h, w = image_shape[0], image_shape[1]
    wy1, wx1, wy2, wx2 = window
    wy1, wx1, wy2, wx2 = wy1 / (h - 1), wx1 / (w - 1), (wy2 - 1) / (h - 1), (wx2 - 1) / (w - 1)
    shift = np.array([wy1, wx1, wy1, wx1])
    scale_arr = np.array([wy2 - wy1, wx2 - wx1, wy2 - wy1, wx2 - wx1])
    boxes = (boxes - shift) / np.maximum(scale_arr, 1e-10)
    oh, ow = original_shape[:2]
    boxes = np.around(
        boxes * np.array([oh - 1, ow - 1, oh - 1, ow - 1]) + np.array([0, 0, 1, 1])
    ).astype(np.int32)

    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = np.where(areas > 0)[0]
    boxes, class_ids, scores, masks = boxes[keep], class_ids[keep], scores[keep], masks[keep]

    full_masks = np.zeros(tuple(original_shape[:2]) + (len(keep),), dtype=bool)
    for i in range(len(keep)):
        full_masks[:, :, i] = unmold_mask(masks[i], boxes[i], original_shape)
    return {"rois": boxes, "class_ids": class_ids, "scores": scores, "masks": full_masks}
