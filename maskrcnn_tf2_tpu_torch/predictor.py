"""High-level inference API: ``Predictor.detect`` (counterpart of
``maskrcnn_tf2_tpu/predictor.py``; streaming and data-parallel serving are
not ported yet).

Host preprocessing -> one batched forward on the device (uint8 images go up,
normalization happens there) -> the class-mask gather on the device -> host
unmold.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.export.inference import process_input, unmold_detections
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks


class Predictor:
    """Batched inference with host unmolding.

    ``state_dict`` is the port's (see ``weights.flax_to_state_dict``).
    ``device=None`` runs on the card and raises if there is none.
    """

    def __init__(self, config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], device: DeviceLike = None):
        self.config = config
        self.model = MaskRCNN(config, device=device)
        self.model.load_state_dict(state_dict)
        self.model.cast_for_serving_()
        self.device = self.model.device

    @torch.no_grad()
    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Run detection on a list of RGB uint8 images of any sizes."""
        molded, metas = zip(*(process_input(img, self.config, image_id=i) for i, img in enumerate(images)))
        batch = torch.from_numpy(np.stack(molded)).to(self.device)
        meta = torch.from_numpy(np.stack(metas)).to(self.device)
        out = self.model(batch, meta)
        detections = out["detections"].cpu().numpy()
        masks = gather_class_masks(out).cpu().numpy()
        return [
            unmold_detections(detections[i], masks[i], img.shape, self.config.image_shape, metas[i][7:11])
            for i, img in enumerate(images)
        ]
