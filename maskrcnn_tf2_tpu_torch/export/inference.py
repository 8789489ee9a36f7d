"""Inference I/O on the host: resize + meta in, unmold out (counterpart of
``maskrcnn_tf2_tpu/export/inference.py``).

Resizing and unmolding are ``data/transforms.py``'s, in every resize mode;
that module says where they differ from the JAX package's cv2 versions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.transforms import resize_image, unmold_mask
from maskrcnn_tf2_tpu_torch.ops.image import compose_image_meta
from maskrcnn_tf2_tpu_torch.utils import profiling


def process_input(
    image: np.ndarray, config: MaskRCNNConfig, image_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB image -> (molded image in the input dtype, meta vector).
    Normalization happens on the device inside the model."""
    with profiling.span("ingress"):
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


def unmold_boxes(detections: np.ndarray, original_shape, image_shape, window):
    """``(n, boxes [n, 4] int32, keep)``: ``n`` the detections before the first
    of class 0, their boxes in the original image's pixels, and the indices of
    those of positive area, in order."""
    zero_ix = np.where(detections[:, 4] == 0)[0]
    n = zero_ix[0] if zero_ix.shape[0] > 0 else detections.shape[0]
    boxes = detections[:n, :4].copy()
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
    return n, boxes, np.where(areas > 0)[0]


def unmold_detections(
    detections: np.ndarray, masks: Optional[np.ndarray], original_shape, image_shape, window,
    pasted: Optional[np.ndarray] = None, batch: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One image's padded outputs -> original-image-space results.

    ``detections [D, 6]`` normalized; ``masks [D, mh, mw, C]`` per class, or
    ``[D, mh, mw]`` already gathered at each detection's class on the device.
    ``pasted``, when given, is the image's masks already pasted by
    ``kernels/paste_masks.py`` (``[H0, W0, N]`` bytes, 0 or 1: the
    ``Predictor``'s path on the card); they are copied into the result and
    ``masks`` is not read. ``batch`` is the id the spans carry, for a call on
    a worker thread, which has no outer span to take it from. Returns
    rois ``[N, 4]`` pixel int32, class_ids ``[N]``, scores ``[N]`` and masks
    ``[H0, W0, N]`` bool.
    """
    with profiling.span("unmold", batch) as span:
        n, boxes, keep = unmold_boxes(detections, original_shape, image_shape, window)
        class_ids = detections[:n, 4].astype(np.int32)
        boxes, scores = boxes[keep], detections[:n, 5][keep]
        oh, ow = original_shape[:2]

        span.n = len(keep)
        with profiling.span("unmold.masks") as pasting:
            pasting.n = len(keep)
            if pasted is not None:
                if pasted.shape != (oh, ow, len(keep)):
                    raise RuntimeError(f"pasted masks {pasted.shape} do not match the {len(keep)} kept "
                                       f"detections of a {oh}x{ow} image")
                full_masks = pasted.view(bool).copy()
            else:
                masks = masks[np.arange(n), :, :, class_ids] if masks.ndim == 4 else masks[:n]
                masks = masks[keep]
                full_masks = np.zeros((oh, ow, len(keep)), dtype=bool)
                for i in range(len(keep)):
                    full_masks[:, :, i] = unmold_mask(masks[i], boxes[i], original_shape)
        return {"rois": boxes, "class_ids": class_ids[keep], "scores": scores, "masks": full_masks}
