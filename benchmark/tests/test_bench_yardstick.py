"""The yardstick's arithmetic: FLOP counts by hand, and the bounds copied
from ``chip_smoke.py`` agreeing with it on the same inputs."""

import pytest
import torch

from benchmark import bounds, flops, harness


def test_bottleneck_by_hand():
    # 56x56 input, 256 -> 64 -> 64 -> 256, stride 1, identity shortcut
    by_hand = 2 * (256 * 64 * 56 * 56 + 64 * 64 * 9 * 56 * 56 + 64 * 256 * 56 * 56)
    assert flops.bottleneck(256, 64, 1, 56, 56) == by_hand
    # the first block of a stage: stride 2 on the 3x3, and a projection shortcut
    by_hand = 2 * (256 * 128 * 56 * 56 + 128 * 128 * 9 * 28 * 28 + 128 * 512 * 28 * 28 + 256 * 512 * 28 * 28)
    assert flops.bottleneck(256, 128, 2, 56, 56) == by_hand


def test_fc_and_heads_by_hand():
    assert flops.fc(12544, 1024) == 2 * 12544 * 1024
    cfg = harness.load_json("configs", "r50_fpn_512")
    per_roi = 2 * (7 * 7 * 256 * 1024 + 1024 * 1024 + 1024 * 81 + 1024 * 324)
    assert flops.classifier(cfg, 1000) == 1000 * per_roi
    mask = 2 * (4 * 256 * 256 * 9 * 14 * 14 + 256 * 256 * 4 * 14 * 14 + 256 * 81 * 28 * 28)
    assert flops.mask_head(cfg, 100, 81) == 100 * mask


def test_whole_forward_is_in_the_published_range():
    # ResNet-50 is ~4.1 GMACs at 224x224, ~43 GFLOPs at 512x512; P2's 3x3 output conv adds 19.3 and the
    # RPN's shared 3x3 at P2 38.7 GFLOPs
    cfg = harness.load_json("configs", "r50_fpn_512")
    assert 110e9 < flops.backbone_fpn_rpn(cfg) < 140e9
    r101 = dict(cfg, backbone="resnet101", image_shape=[1024, 1024, 3])
    assert flops.inference_per_image(r101) > 3 * flops.inference_per_image(cfg)


def test_bounds_match_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand((2, 300, 4), generator=g)
    valid = torch.rand((2, 300), generator=g) > 0.2
    positions = torch.sort(torch.randperm(300, generator=g)[:50]).values.expand(2, 50).to(torch.int32)
    out_valid = torch.rand((2, 50), generator=g) > 0.1
    assert bounds.nms_bound(boxes, valid, positions, out_valid) == chip_smoke.nms_bound(boxes, valid, positions,
                                                                                        out_valid)
    assert (bounds.HBM_BYTES_PER_S, bounds.F32_FLOPS, bounds.IOU_FLOPS) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOPS, chip_smoke.IOU_FLOPS)


def test_roi_bound_counts_the_pixels_its_samples_touch():
    """One box over a whole 512x512 image goes to P5 (16x16): 7 samples a side
    at 0, 2.5, ..., 15 touch rows and columns {0, 1, 2, 3, 5, 6, 7, 8, 10, 11,
    12, 13, 15}, 13 x 13 pixels; a zero box touches none."""
    feats = [torch.empty((1, s, s, 256), dtype=torch.bfloat16, device="meta") for s in (128, 64, 32, 16)]
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]]])
    assert bounds.roi_touched_pixels([(128, 128), (64, 64), (32, 32), (16, 16)], boxes, 7, (512, 512)) == 169
    want = (169 * 256 * 2 + 8 * 4 + 2 * 49 * 256 * 2) / bounds.HBM_BYTES_PER_S * 1e3
    assert bounds.roi_bound(feats, boxes, 7, (512, 512)) == (want, 2 * 49 * 256 * 8 / bounds.F32_FLOPS * 1e3)
