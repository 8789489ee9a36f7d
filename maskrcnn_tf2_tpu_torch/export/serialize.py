"""Program export: a portable ``torch.export`` program of the served forward
(counterpart of ``maskrcnn_tf2_tpu/export/serialize.py``'s
``export_stablehlo`` and ``load_stablehlo``).

    export_program(config, state_dict, "mrcnn.pt2", batch_size=2)
    program = load_program("mrcnn.pt2", device="cpu")
    detections, masks = program(images, image_meta)

The program maps ``(images [B, H, W, 3] float32 0..255, image_meta [B,
meta_size] float32)`` to ``(detections [B, D, 6], mrcnn_masks [B, D, mh, mw,
num_classes])``, the contract of the JAX package's exports, with the weights
inside (cast for serving, as ``Predictor`` serves them). It is a graph, not
compiled code: it is pinned to no card, host or library build, and loads on
the card or on the CPU (``torch.export.passes.move_to_device_pass`` moves
it). The kernels are ops of the graph (``maskrcnn_tf2_tpu_torch::
greedy_nms``, ``roi_align``, ``int8_conv``), registered when this module is
imported, so the loader can resolve them; on the card they launch the
hand-written kernels.

``export_saved_model`` and ``export_onnx`` are not ported: tensorflow,
``tf2onnx`` and ``onnx`` have no place in the port.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device
from maskrcnn_tf2_tpu_torch.kernels import int8_conv, nms, roi_align  # noqa: F401  (registers the ops)
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN, gather_class_masks


class ServedForward(nn.Module):
    """``(images, image_meta) -> (detections, masks)`` of a model cast for
    serving: masks per class, or (``gather``) at each detection's class,
    gathered on the device."""

    def __init__(self, model: MaskRCNN, gather: bool):
        super().__init__()
        self.model = model
        self.gather = gather

    def forward(self, images: torch.Tensor, image_meta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.model(images, image_meta)
        return out["detections"], gather_class_masks(out) if self.gather else out["mrcnn_masks"]


def export_served(config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], batch_size: int,
                  device: torch.device, image_dtype: torch.dtype, gather: bool) -> torch.export.ExportedProgram:
    """The served forward at a fixed batch, traced under ``torch.no_grad()``
    (the model's inference ``set_grad_enabled(False)`` block is then no
    node of the graph). An int8 configuration's weights are quantized once,
    by ``cast_for_serving_``, before the trace."""
    model = MaskRCNN(config, device=device)
    model.load_state_dict(state_dict)
    model.cast_for_serving_()
    h, w, c = config.image_shape
    images = torch.zeros((batch_size, h, w, c), dtype=image_dtype, device=device)
    meta = torch.zeros((batch_size, config.meta_size), dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(ServedForward(model, gather), (images, meta), strict=False)


def export_program(config: MaskRCNNConfig, state_dict: Mapping[str, torch.Tensor], path: str, batch_size: int = 1,
                   device: DeviceLike = None) -> str:
    """Trace the served forward (float images, per-class masks) on
    ``device`` (the card by default) and save it with ``torch.export.save``.
    Returns ``path``."""
    program = export_served(config, state_dict, batch_size, resolve_device(device), torch.float32, gather=False)
    torch.export.save(program, path)
    return path


def load_program(path: str, device: DeviceLike = None):
    """The program of ``export_program`` on ``device`` (the card by default):
    a module ``(images, image_meta) -> (detections, mrcnn_masks)``. Load
    programs only from trusted sources."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), resolve_device(device))
    return program.module()
