"""Mask R-CNN inference forward (counterpart of ``models/mask_rcnn.py``).

normalize -> ResNet C2..C5 -> FPN P2..P6 -> shared RPN head -> proposals
(exact top-k, decode, clip, NMS kernel) -> 7x7 pyramid ROIAlign kernel ->
classifier -> class-offset NMS kernel -> 14x14 pyramid ROIAlign kernel ->
mask head. Module names follow the flax tree (``backbone``, ``fpn``, ``rpn``,
``classifier``, ``mask_head``) so that ``weights.flax_to_state_dict`` maps
paths one to one.

Images come in channels-last (``[B, H, W, 3]``, uint8 or float 0..255) as in
the JAX package; the convolutions run NCHW in ``channels_last`` memory, so
turning a pyramid level back to ``[B, H, W, C]`` for ROIAlign is a free view.
Convolutions, FCs and activations run in ``config.compute_dtype``; batch
norm parameters stay float32, and scores, boxes, NMS and detection
refinement run in float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.device import DeviceLike, resolve_device
from maskrcnn_tf2_tpu_torch.models.backbones.factory import get_backbone
from maskrcnn_tf2_tpu_torch.models.fpn import FPN
from maskrcnn_tf2_tpu_torch.models.heads import FPNClassifierHead, FPNMaskHead
from maskrcnn_tf2_tpu_torch.models.rpn import RPNHead
from maskrcnn_tf2_tpu_torch.ops.anchors import get_anchors
from maskrcnn_tf2_tpu_torch.ops.detection import refine_detections
from maskrcnn_tf2_tpu_torch.ops.image import (
    maxmin_normalize_image,
    norm_window,
    normalize_image,
    parse_image_meta,
)
from maskrcnn_tf2_tpu_torch.ops.proposal import generate_proposals
from maskrcnn_tf2_tpu_torch.ops.roi_align import pyramid_roi_align, pyramid_roi_align_deferred

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()  # a view when x is channels_last


class MaskRCNN(nn.Module):
    """The flagship detector, inference only so far.

    ``device=None`` places it on the card and raises if there is none;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, config: MaskRCNNConfig, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = get_backbone(cfg.backbone, leaky_relu=cfg.resnet_leaky_relu)
        c5 = self.backbone.out_channels
        self.fpn = FPN((c5 // 8, c5 // 4, c5 // 2, c5), cfg.top_down_pyramid_size)
        self.rpn = RPNHead(cfg.top_down_pyramid_size, cfg.anchors_per_location, conv_channels=512)
        self.classifier = FPNClassifierHead(
            cfg.top_down_pyramid_size, cfg.num_classes, cfg.pool_size,
            cfg.fpn_cls_fc_layers_size, leaky_relu=cfg.cls_head_leaky_relu,
        )
        self.mask_head = FPNMaskHead(
            cfg.top_down_pyramid_size, cfg.num_classes, cfg.mask_conv_channels,
            leaky_relu=cfg.mask_head_leaky_relu,
        )
        self.register_buffer("anchors", torch.from_numpy(get_anchors(cfg).copy()), persistent=False)
        device = resolve_device(device)
        self.to(device=device, memory_format=torch.channels_last)
        for m in self.modules():
            if not isinstance(m, nn.modules.batchnorm._BatchNorm):
                for name, p in m.named_parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    @torch.no_grad()
    def forward(self, images: torch.Tensor, image_meta: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        if train:
            raise NotImplementedError(
                "the PyTorch port serves inference only; the training step is "
                "ROADMAP.md item A.12 (the training slice)"
            )
        cfg = self.config
        if cfg.normalization == "maxmin":
            x = maxmin_normalize_image(images)
        else:
            x = normalize_image(images, cfg.pixel_mean, cfg.pixel_std)
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        endpoints = self.backbone(x)
        rpn_feats, mrcnn_feats = self.fpn(endpoints)
        rpn_logits, rpn_probs, rpn_bbox = self.rpn(rpn_feats)

        proposals, prop_valid = generate_proposals(
            rpn_probs,
            rpn_bbox,
            self.anchors,
            rpn_bbox_std=cfg.rpn_bbox_std_dev,
            pre_nms_limit=cfg.pre_nms_limit,
            proposal_count=cfg.post_nms_rois(False),
            nms_threshold=cfg.rpn_nms_threshold,
        )
        feats = [_to_nhwc(f) for f in mrcnn_feats]
        pooled, _ = pyramid_roi_align_deferred(feats, proposals, cfg.pool_size, cfg.image_shape)
        _, probs, deltas = self.classifier(pooled)

        windows = norm_window(parse_image_meta(image_meta.to(torch.float32))["window"], cfg.image_shape)
        detections = refine_detections(
            proposals,
            probs,
            deltas,
            windows,
            bbox_std=cfg.bbox_std_dev,
            min_confidence=cfg.detection_min_confidence,
            nms_threshold=cfg.detection_nms_threshold,
            max_instances=cfg.detection_max_instances,
        )
        mask_pooled = pyramid_roi_align(feats, detections[..., :4], cfg.mask_pool_size, cfg.image_shape)
        masks = self.mask_head(mask_pooled)
        return {
            "rpn_logits": rpn_logits,
            "rpn_probs": rpn_probs,
            "rpn_bbox": rpn_bbox,
            "rpn_rois": proposals,
            "rpn_rois_valid": prop_valid,
            "mrcnn_probs": probs,
            "mrcnn_deltas": deltas,
            "detections": detections,
            "mrcnn_masks": masks,
        }


def gather_class_masks(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[B, D, mh, mw, C]`` per-class masks -> ``[B, D, mh, mw]`` at each
    detection's own class, on the device (the fetch shrinks by the class count)."""
    masks = out["mrcnn_masks"]
    cls = out["detections"][..., 4].long()
    b, d, mh, mw, _ = masks.shape
    return torch.gather(masks, 4, cls[:, :, None, None, None].expand(b, d, mh, mw, 1))[..., 0]
