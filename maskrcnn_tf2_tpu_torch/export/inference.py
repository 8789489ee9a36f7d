"""Inference I/O on the host: resize + meta in, unmold out (counterpart of
``maskrcnn_tf2_tpu/export/inference.py``).

Resizing and unmolding are ``data/transforms.py``'s, in every resize mode;
that module says where they differ from the JAX package's cv2 versions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.transforms import paste_kept_masks, resize_image, unmold_boxes
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


def unmold_detections(
    detections: np.ndarray, masks: Optional[np.ndarray], original_shape, image_shape, window,
    pasted: Optional[np.ndarray] = None, batch: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One image's padded outputs -> original-image-space results.

    ``detections [D, 6]`` normalized; ``masks [D, mh, mw, C]`` per class, or
    ``[D, mh, mw]`` already gathered at each detection's class on the device.
    ``pasted``, when given, is the image's masks already pasted by
    ``kernels/paste_masks.py`` (``[H0, W0, N]`` bytes, 0 or 1: the
    ``Predictor``'s path); they are copied into the result and ``masks`` is
    not read. ``batch`` is the id the spans carry, for a call on
    a worker thread, which has no outer span to take it from. Returns
    rois ``[N, 4]`` pixel int32, class_ids ``[N]``, scores ``[N]`` and masks
    ``[H0, W0, N]`` bool.
    """
    with profiling.span("unmold", batch) as span:
        n, boxes, keep = unmold_boxes(detections, original_shape, image_shape, window)
        class_ids = detections[:n, 4].astype(np.int32)
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
                masks = masks[np.arange(n), :, :, class_ids] if masks.ndim == 4 else masks
                full_masks = np.zeros((oh, ow, len(keep)), dtype=bool)
                paste_kept_masks(full_masks, masks, boxes, keep)
        return {"rois": boxes[keep], "class_ids": class_ids[keep], "scores": detections[:n, 5][keep],
                "masks": full_masks}
