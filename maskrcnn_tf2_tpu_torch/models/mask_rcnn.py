"""Mask R-CNN forward, inference and training (counterpart of
``models/mask_rcnn.py``).

normalize -> backbone C2..C5 (any of the 25 keys) -> FPN P2..P6 -> shared
RPN head -> proposals (exact top-k, decode, clip, NMS kernel), then

- inference: 7x7 pyramid ROIAlign kernel -> classifier -> class-offset NMS
  kernel -> 14x14 pyramid ROIAlign kernel -> mask head;
- training (``train=True``): ``ops.targets.detection_targets`` samples the
  proposals (or the caller's ``input_rois``) into training slots -> 7x7
  ROIAlign -> classifier logits -> 14x14 ROIAlign -> mask head, through the
  differentiable ``ops.roi_align.PyramidRoIAlign``.

Module names follow the flax tree (``backbone``, ``fpn``, ``rpn``,
``classifier``, ``mask_head``) so that ``weights.flax_to_state_dict`` maps
paths one to one.

Images come in channels-last (``[B, H, W, 3]``, uint8 or float 0..255) as in
the JAX package; the convolutions run NCHW in ``channels_last`` memory, so
turning a pyramid level back to ``[B, H, W, C]`` for ROIAlign is a free view.
Parameters are float32 master weights; convolutions, FCs and activations run
in ``config.compute_dtype`` (each layer casts its weights at use), and
scores, boxes, NMS, targets and losses run in float32 whatever the compute
dtype. Each forward sets the batch norms' mode: batch statistics in the
backbone when ``train and train_bn and train_bn_backbone``, in the heads
when ``train and train_bn``, running averages otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

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
from maskrcnn_tf2_tpu_torch.ops.targets import detection_targets

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()  # a view when x is channels_last


class MaskRCNN(nn.Module):
    """The flagship detector.

    ``device=None`` places it on the card and raises if there is none;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, config: MaskRCNNConfig, device: DeviceLike = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.backbone = get_backbone(cfg.backbone, leaky_relu=cfg.resnet_leaky_relu)
        self.fpn = FPN(self.backbone.endpoint_channels, cfg.top_down_pyramid_size)
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
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.anchors.device

    @torch.no_grad()
    def cast_for_serving_(self) -> "MaskRCNN":
        """Cast every non-batch-norm parameter to the compute dtype, in place,
        so that serving casts nothing at use. Such a model has lost its
        float32 master weights: serve with it, do not train it."""
        for m in self.modules():
            if not isinstance(m, nn.modules.batchnorm._BatchNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(self.compute_dtype)
        return self

    def _backbone_fpn_rpn(self, images: torch.Tensor):
        cfg = self.config
        if cfg.normalization == "maxmin":
            x = maxmin_normalize_image(images)
        else:
            x = normalize_image(images, cfg.pixel_mean, cfg.pixel_std)
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        endpoints = self.backbone(x)
        if cfg.frozen_backbone:
            endpoints = {k: v.detach() for k, v in endpoints.items()}
        rpn_feats, mrcnn_feats = self.fpn(endpoints)
        rpn_logits, rpn_probs, rpn_bbox = self.rpn(rpn_feats)
        if cfg.frozen_rpn_model:
            rpn_logits, rpn_probs, rpn_bbox = rpn_logits.detach(), rpn_probs.detach(), rpn_bbox.detach()
        return mrcnn_feats, rpn_logits, rpn_probs, rpn_bbox

    def _proposals(self, rpn_probs, rpn_bbox, train: bool):
        cfg = self.config
        return generate_proposals(
            rpn_probs,
            rpn_bbox,
            self.anchors,
            rpn_bbox_std=cfg.rpn_bbox_std_dev,
            pre_nms_limit=cfg.pre_nms_limit,
            proposal_count=cfg.post_nms_rois(train),
            nms_threshold=cfg.rpn_nms_threshold,
        )

    def forward(
        self,
        images: torch.Tensor,
        image_meta: torch.Tensor,
        gt_class_ids: Optional[torch.Tensor] = None,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_masks: Optional[torch.Tensor] = None,
        input_rois: Optional[torch.Tensor] = None,
        train: bool = False,
        draws: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """``train=True`` needs the GT tensors and ``draws["det_pos"]``,
        ``draws["det_neg"]`` (``ops.targets.draw_uniforms``), and
        ``input_rois`` when ``use_rpn_rois=False``."""
        cfg = self.config
        if train and (gt_class_ids is None or gt_boxes is None or gt_masks is None or draws is None):
            raise ValueError("train=True needs gt_class_ids, gt_boxes, gt_masks and draws")
        if train and not cfg.use_rpn_rois and input_rois is None:
            raise ValueError("use_rpn_rois=False trains the heads on input_rois: pass them")
        train_bn = train and cfg.train_bn
        self.backbone.train(train_bn and cfg.train_bn_backbone)
        self.classifier.train(train_bn)
        self.mask_head.train(train_bn)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):  # inference is not differentiated
            mrcnn_feats, rpn_logits, rpn_probs, rpn_bbox = self._backbone_fpn_rpn(images)
            out = {"rpn_logits": rpn_logits, "rpn_probs": rpn_probs, "rpn_bbox": rpn_bbox}
            feats = [_to_nhwc(f) for f in mrcnn_feats]
            if not train:
                return self._detect(feats, out, image_meta)
            if cfg.use_rpn_rois:
                proposals, _ = self._proposals(rpn_probs, rpn_bbox, train=True)
            else:
                proposals = input_rois
            if not cfg.tune_rpn_model_only:  # else no sampling and no head compute
                out.update(self._train_heads(feats, proposals, gt_class_ids, gt_boxes, gt_masks, draws, train_bn))
            return out

    def _train_heads(self, feats, proposals, gt_class_ids, gt_boxes, gt_masks, draws, train_bn):
        cfg = self.config
        targets = detection_targets(
            proposals, gt_class_ids, gt_boxes, gt_masks, draws["det_pos"], draws["det_neg"],
            train_rois_per_image=cfg.train_rois_per_image,
            roi_positive_ratio=cfg.roi_positive_ratio,
            bbox_std=cfg.bbox_std_dev,
            mask_shape=cfg.mask_shape,
            use_mini_masks=cfg.use_mini_masks,
        )
        pooled = pyramid_roi_align(feats, targets.rois, cfg.pool_size, cfg.image_shape)
        logits, probs, deltas = self.classifier(pooled)
        # mask_train_slim: the loss reads only each positive slot's GT-class
        # channel, so the head projects that column alone; with frozen head
        # BNs it also runs on the leading positive slots only (under train_bn
        # the batch statistics span every slot, so all of them stay)
        mask_rois, mask_class_ids = targets.rois, None
        if cfg.mask_train_slim:
            mask_class_ids = targets.class_ids
            if not train_bn:
                k = max(int(cfg.train_rois_per_image * cfg.roi_positive_ratio), 1)
                mask_rois, mask_class_ids = targets.rois[:, :k], targets.class_ids[:, :k]
        mask_pooled = pyramid_roi_align(feats, mask_rois, cfg.mask_pool_size, cfg.image_shape)
        masks = self.mask_head(mask_pooled, class_ids=mask_class_ids)
        if cfg.frozen_cls_head:
            logits, probs, deltas = logits.detach(), probs.detach(), deltas.detach()
        if cfg.frozen_mask_head:
            masks = masks.detach()
        return {
            "rois": targets.rois,
            "target_class_ids": targets.class_ids,
            "target_deltas": targets.deltas,
            "target_masks": targets.masks,
            "target_positive_mask": targets.positive_mask,
            "target_valid_mask": targets.valid_mask,
            "mrcnn_class_logits": logits,
            "mrcnn_probs": probs,
            "mrcnn_deltas": deltas,
            "mrcnn_masks": masks,
        }

    def _detect(self, feats, out, image_meta):
        cfg = self.config
        proposals, prop_valid = self._proposals(out["rpn_probs"], out["rpn_bbox"], train=False)
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
        out.update({
            "rpn_rois": proposals,
            "rpn_rois_valid": prop_valid,
            "mrcnn_probs": probs,
            "mrcnn_deltas": deltas,
            "detections": detections,
            "mrcnn_masks": masks,
        })
        return out


def gather_class_masks(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``[B, D, mh, mw, C]`` per-class masks -> ``[B, D, mh, mw]`` at each
    detection's own class, on the device (the fetch shrinks by the class count)."""
    masks = out["mrcnn_masks"]
    cls = out["detections"][..., 4].long()
    b, d, mh, mw, _ = masks.shape
    return torch.gather(masks, 4, cls[:, :, None, None, None].expand(b, d, mh, mw, 1))[..., 0]
