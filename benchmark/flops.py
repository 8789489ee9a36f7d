"""Model FLOPs that a configuration's shapes require: every convolution,
transposed convolution and fully connected layer of the ResNet-FPN Mask R-CNN
(backbone, FPN, RPN, classifier head, mask head), at 2 FLOPs per
multiply-add, at the configuration's image size and its proposal and detection
counts. Element-wise work, batch norm, ROIAlign and NMS are
not counted. Padded slots count: the program computes them.
"""

from __future__ import annotations

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """A k x k convolution producing an ``h x w`` map."""
    return 2 * cin * cout * k * k * h * w


def fc(cin: int, cout: int) -> int:
    return 2 * cin * cout


def _same(n: int, s: int) -> int:
    return -(-n // s)


def bottleneck(cin: int, f: int, stride: int, h: int, w: int) -> int:
    """One bottleneck block on an ``h x w`` input: 1x1 to ``f``, 3x3 at
    ``stride``, 1x1 to ``4f``, and a 1x1 projection shortcut where the width
    or the stride changes."""
    oh, ow = _same(h, stride), _same(w, stride)
    total = conv(cin, f, 1, h, w) + conv(f, f, 3, oh, ow) + conv(f, 4 * f, 1, oh, ow)
    if cin != 4 * f or stride != 1:
        total += conv(cin, 4 * f, 1, oh, ow)
    return total


def backbone_fpn_rpn(cfg: dict) -> int:
    h, w = cfg["image_shape"][0], cfg["image_shape"][1]
    h, w = _same(h, 2), _same(w, 2)
    total = conv(3, 64, 7, h, w)
    h, w = _same(h, 2), _same(w, 2)  # 3x3/2 max-pool
    cin, f, sizes, widths = 64, 64, [], []
    for s, n in enumerate(STAGES[cfg["backbone"]]):
        for i in range(n):
            stride = 2 if i == 0 and s > 0 else 1
            total += bottleneck(cin, f, stride, h, w)
            h, w, cin = _same(h, stride), _same(w, stride), 4 * f
        sizes.append((h, w))
        widths.append(cin)
        f *= 2
    c = cfg["top_down_pyramid_size"]
    for (lh, lw), cw in zip(sizes, widths):
        total += conv(cw, c, 1, lh, lw) + conv(c, c, 3, lh, lw)
    levels = sizes + [(_same(sizes[-1][0], 2), _same(sizes[-1][1], 2))]
    k = len(cfg["rpn_anchor_ratios"])
    for lh, lw in levels:
        total += conv(c, 512, 3, lh, lw) + conv(512, 6 * k, 1, lh, lw)
    return total


def classifier(cfg: dict, rois: int) -> int:
    c, p, f, n = cfg["top_down_pyramid_size"], cfg["pool_size"], cfg["fpn_cls_fc_layers_size"], cfg["num_classes"]
    return rois * (fc(p * p * c, f) + fc(f, f) + fc(f, n) + fc(f, 4 * n))


def mask_head(cfg: dict, rois: int, classes: int) -> int:
    """``classes`` columns of the final 1x1 projection (all of them in
    inference)."""
    c, p, m = cfg["top_down_pyramid_size"], cfg["mask_pool_size"], cfg["mask_conv_channels"]
    per = conv(c, m, 3, p, p) + 3 * conv(m, m, 3, p, p) + 2 * m * m * 4 * p * p + conv(m, classes, 1, 2 * p, 2 * p)
    return rois * per


def inference_per_image(cfg: dict) -> int:
    return (backbone_fpn_rpn(cfg) + classifier(cfg, cfg["post_nms_rois_inference"])
            + mask_head(cfg, cfg["detection_max_instances"], cfg["num_classes"]))

