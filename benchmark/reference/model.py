"""Plain float32 Mask R-CNN with a ResNet-FPN backbone, the benchmark's
reference network.

The layers follow matterport/Mask_RCNN (``mrcnn/model.py``: ``resnet_graph``,
the FPN, ``rpn_graph``, ``fpn_classifier_graph``, ``build_fpn_mask_graph``)
in the port's conventions: TF "SAME" padding (stride-2 layers pad the extra
pixel at the end), batch norm from its running statistics, P6 a stride-2 subsample of P5, the classifier's first FC over the
pooled patch flattened in (P, P, C) order, and each module named as the
port's ``state_dict`` names it, so that one seeded ``state_dict`` loads into
both. Convolutions run NCHW in float32; TF32 must be off (``plain_float32``).

``MaskRCNNReference`` exposes the inference stages one by one so that the
check can hold each stage of the program to this reference on the program's
own inputs to that stage (``benchmark/serving.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import ops

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


@contextlib.contextmanager
def plain_float32():
    """TF32 off for matmuls and cuDNN convolutions, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    def amounts(n):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2
    (t, b), (l, r) = amounts(x.shape[2]), amounts(x.shape[3])
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


class Conv(nn.Conv2d):
    """Conv with "SAME" padding."""

    def __init__(self, cin, cout, k, stride=1, bias=True):
        super().__init__(cin, cout, k, stride, padding=0, bias=bias)

    def forward(self, x):
        x = same_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight, self.bias, self.stride)


class Deconv(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride)


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm from its running statistics."""

    def __init__(self, c, eps=1e-5):
        super().__init__(c, eps=eps)

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        return (x - self.running_mean.reshape(shape)) * torch.rsqrt(self.running_var.reshape(shape) + self.eps) \
            * self.weight.reshape(shape) + self.bias.reshape(shape)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class Bottleneck(nn.Module):
    def __init__(self, cin, features, stride):
        super().__init__()
        out = features * 4
        self.conv1 = ConvBN(cin, features, 1)
        self.conv2 = ConvBN(features, features, 3, stride)
        self.conv3 = ConvBN(features, out, 1)
        if cin != out or stride != 1:
            self.downsample = ConvBN(cin, out, 1, stride)

    def forward(self, x):
        y = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(y + (self.downsample(x) if hasattr(self, "downsample") else x))


class ResNet(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2)
        cin, features, self.names = 64, 64, []
        for s, n in enumerate(stages):
            names = []
            for i in range(n):
                name = f"stage{s + 1}_block{i + 1}"
                self.add_module(name, Bottleneck(cin, features, 2 if i == 0 and s > 0 else 1))
                cin = features * 4
                names.append(name)
            self.names.append(names)
            features *= 2

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.stem(x))
        x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)
        out = []
        for names in self.names:
            for name in names:
                x = getattr(self, name)(x)
            out.append(x)
        return out  # C2..C5


class FPN(nn.Module):
    def __init__(self, widths, c=256):
        super().__init__()
        for i, w in zip((2, 3, 4, 5), widths):
            self.add_module(f"fpn_c{i}p{i}", Conv(w, c, 1))
            self.add_module(f"fpn_p{i}", Conv(c, c, 3))

    def forward(self, cs):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        p5 = self.fpn_c5p5(cs[3])
        p4 = self.fpn_c4p4(cs[2]) + up(p5)
        p3 = self.fpn_c3p3(cs[1]) + up(p4)
        p2 = self.fpn_c2p2(cs[0]) + up(p3)
        ps = [self.fpn_p2(p2), self.fpn_p3(p3), self.fpn_p4(p4), self.fpn_p5(p5)]
        return ps + [ps[3][:, :, ::2, ::2]]


class RPN(nn.Module):
    def __init__(self, c=256, k=3):
        super().__init__()
        self.k = k
        self.rpn_conv_shared = Conv(c, 512, 3)
        self.rpn_class_raw = Conv(512, 2 * k, 1)
        self.rpn_bbox_pred = Conv(512, 4 * k, 1)

    def forward(self, levels):
        logits, deltas = [], []
        for f in levels:
            shared = F.relu(self.rpn_conv_shared(f))
            logits.append(self.rpn_class_raw(shared).permute(0, 2, 3, 1).reshape(f.shape[0], -1, 2))
            deltas.append(self.rpn_bbox_pred(shared).permute(0, 2, 3, 1).reshape(f.shape[0], -1, 4))
        logits = torch.cat(logits, 1)
        return logits, torch.softmax(logits, -1), torch.cat(deltas, 1)


class Classifier(nn.Module):
    def __init__(self, c, classes, pool, fc):
        super().__init__()
        self.classes = classes
        self.mrcnn_class_conv1 = nn.Linear(pool * pool * c, fc)
        self.mrcnn_class_bn1 = BatchNorm(fc)
        self.mrcnn_class_conv2 = nn.Linear(fc, fc)
        self.mrcnn_class_bn2 = BatchNorm(fc)
        self.mrcnn_class_logits = nn.Linear(fc, classes)
        self.mrcnn_bbox_fc = nn.Linear(fc, classes * 4)

    def forward(self, pooled):  # [N, P, P, C]
        x = F.relu(self.mrcnn_class_bn1(self.mrcnn_class_conv1(pooled.reshape(pooled.shape[0], -1))))
        x = F.relu(self.mrcnn_class_bn2(self.mrcnn_class_conv2(x)))
        logits = self.mrcnn_class_logits(x)
        return logits, torch.softmax(logits, -1), self.mrcnn_bbox_fc(x).reshape(-1, self.classes, 4)


class MaskHead(nn.Module):
    def __init__(self, c, classes, width):
        super().__init__()
        cin = c
        for i in range(1, 5):
            self.add_module(f"mrcnn_mask_conv{i}", Conv(cin, width, 3))
            self.add_module(f"mrcnn_mask_bn{i}", BatchNorm(width))
            cin = width
        self.mrcnn_mask_deconv = Deconv(width, width, 2, stride=2)
        self.mrcnn_mask = Conv(width, classes, 1)

    def forward(self, pooled, class_ids):
        """``[N, P, P, C]`` pooled ROIs and ``[N]`` classes -> ``[N, 2P, 2P]``
        sigmoid masks of each ROI's class."""
        x = pooled.permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mrcnn_mask_bn{i}")(getattr(self, f"mrcnn_mask_conv{i}")(x)))
        x = torch.sigmoid(self.mrcnn_mask(F.relu(self.mrcnn_mask_deconv(x))))  # [N, classes, 2P, 2P]
        return x[torch.arange(len(x), device=x.device), class_ids.long()]


class MaskRCNNReference(nn.Module):
    """The network of a configuration dict (``benchmark/configs/*.json``)."""

    def __init__(self, cfg: dict, device="cpu"):
        super().__init__()
        self.cfg = cfg
        c = cfg["top_down_pyramid_size"]
        self.backbone = ResNet(STAGES[cfg["backbone"]])
        self.fpn = FPN((256, 512, 1024, 2048), c)
        self.rpn = RPN(c, len(cfg["rpn_anchor_ratios"]))
        self.classifier = Classifier(c, cfg["num_classes"], cfg["pool_size"], cfg["fpn_cls_fc_layers_size"])
        self.mask_head = MaskHead(c, cfg["num_classes"], cfg["mask_conv_channels"])
        self.register_buffer("anchors", torch.from_numpy(ops.pyramid_anchors(cfg)), persistent=False)
        self.to(device)
        self.eval()

    # ---- the inference stages, one image at a time
    def features(self, molded: np.ndarray) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
        """uint8 ``[H, W, 3]`` -> (P2..P5 channels-last ``[H_l, W_l, C]``, RPN
        logits ``[A, 2]``, probabilities, deltas ``[A, 4]``)."""
        x = self.normalize(torch.from_numpy(molded).to(self.anchors.device)[None])
        ps = self.fpn(self.backbone(x))
        logits, probs, deltas = self.rpn(ps)
        return [p[0].permute(1, 2, 0) for p in ps[:4]], logits[0], probs[0], deltas[0]

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` 0..255 -> NCHW float32, ImageNet mean and std."""
        mean = torch.tensor(self.cfg["pixel_mean"], device=images.device)
        std = torch.tensor(self.cfg["pixel_std"], device=images.device)
        return ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)

    def classify(self, feats, rois):
        pooled = ops.roi_align(feats, rois, self.cfg["pool_size"], self.cfg["image_shape"])
        _, probs, deltas = self.classifier(pooled)
        return probs, deltas

    def masks(self, feats, boxes, class_ids):
        pooled = ops.roi_align(feats, boxes, self.cfg["mask_pool_size"], self.cfg["image_shape"])
        return self.mask_head(pooled, class_ids)

    def window(self, meta: np.ndarray) -> torch.Tensor:
        h, w = self.cfg["image_shape"][0], self.cfg["image_shape"][1]
        win = torch.tensor(meta[7:11], dtype=torch.float32, device=self.anchors.device)
        return (win - win.new_tensor([0, 0, 1, 1])) / win.new_tensor([h - 1, w - 1, h - 1, w - 1])


@torch.no_grad()
def calibrate_class_logits(model: MaskRCNNReference, molded: List[np.ndarray]) -> None:
    """Scale the class-logit kernel so that the logits have unit standard
    deviation over the proposals of ``molded`` images. With seeded weights and
    identity batch-norm statistics the activations' scale, and with it the
    class scores and how many of the detection slots pass a threshold, is the
    seed's; at unit logits the scores are near uniform for every seed."""
    cfg = model.cfg
    dev = model.anchors.device
    logits = []
    for image in molded:
        feats, _, probs, deltas = model.features(image)
        rois, _ = ops.generate_proposals(probs, deltas, model.anchors, cfg, cfg["post_nms_rois_inference"])
        pooled = ops.roi_align(feats, rois, cfg["pool_size"], cfg["image_shape"])
        logits.append(model.classifier(pooled)[0])
    std = torch.cat(logits).std()
    model.classifier.mrcnn_class_logits.weight.div_(torch.clamp(std, min=1e-30).to(dev))


def load_reference(cfg: dict, state_dict: Dict[str, torch.Tensor], device) -> MaskRCNNReference:
    """The reference with ``state_dict`` (every entry, strictly) in float32."""
    with torch.device("meta"):
        model = MaskRCNNReference(cfg, device="meta")
    model = model.to_empty(device=device)
    model.anchors = torch.from_numpy(ops.pyramid_anchors(cfg)).to(device)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in state_dict.items()}, strict=True)
    return model
