"""Int8 post-training quantization: calibration and the int8 configuration
(counterpart of ``maskrcnn_tf2_tpu/export/quantize.py``).

    int8_config, state_dict = quantize_for_inference(config, state_dict, batches)
    predictor = Predictor(int8_config, state_dict)

``calibrate`` runs the ordinary inference forward with ``quant_mode='calib'``,
in which every quantizable site records the running max of its input's
magnitude (and every ResNet block that of its output) into its amax buffer
(``models/quant.py``). ``quant_mode='int8'`` serves from those scales. The
weights are untouched: an int8 model quantizes them per output channel once,
when it is cast for serving.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.models.quant import is_quant_buffer


def calibrate(config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], batches: Iterable,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The per-site input amax over ``batches``.

    ``batches``: an iterable of ``(images, image_meta)``, as the inference
    forward takes them (raw 0..255 images ``[B, H, W, 3]``, tensors or numpy
    arrays). Amax entries already in ``state_dict`` are where the running max
    starts; the others start at 0. Returns ``state_dict`` with every amax
    entry added (CPU tensors). ``device=None`` calibrates on the card.
    """
    model = MaskRCNN(config.replace(quant_mode="calib"), device=device)
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not is_quant_buffer(k)]
    if missing or unexpected:
        raise KeyError(f"the state_dict does not fit {config.backbone}: missing {missing}, unexpected {unexpected}")
    n = 0
    with torch.no_grad():
        for images, meta in batches:
            model(torch.as_tensor(images).to(model.device), torch.as_tensor(meta).to(model.device))
            n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    out = dict(state_dict)
    out.update({k: v.detach().cpu() for k, v in model.state_dict().items() if is_quant_buffer(k)})
    return out


def quantize_for_inference(config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], batches: Iterable,
                           device: DeviceLike = None) -> Tuple[MaskRCNNConfig, Dict[str, torch.Tensor]]:
    """Calibrate and return ``(int8_config, state_dict)`` ready for ``Predictor``."""
    return config.replace(quant_mode="int8"), calibrate(config, state_dict, batches, device=device)
