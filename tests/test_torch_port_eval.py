"""The port's evaluation against the JAX package's, on the CPU.

``eval/metrics.py`` and ``CocoEvalLite`` are numpy copies: on seeded random
scenes (``tests/test_cocoeval_golden.py::_random_scene``) every function's
output equals the JAX one's exactly, and every hand-derived golden case of
``tests/test_cocoeval_golden.py`` passes on the port's class.
``evaluate_dataset`` over a tiny synthetic COCO set: with one stub predictor
that returns fixed results, both packages' functions over both packages'
datasets give equal dicts; with real predictors on bridged weights, bbox
stats are equal and segm stats within ``SEGM_TOL``.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import test_cocoeval_golden as golden
from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.data.coco import CocoDataset as JaxCocoDataset
from maskrcnn_tf2_tpu.eval import coco_eval as jax_coco_eval
from maskrcnn_tf2_tpu.eval import metrics as jax_metrics
from maskrcnn_tf2_tpu.models import MaskRCNN as JaxMaskRCNN
from maskrcnn_tf2_tpu.ops.image import compose_image_meta
from maskrcnn_tf2_tpu.predictor import Predictor as JaxPredictor

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.coco import CocoDataset
from maskrcnn_tf2_tpu_torch.eval import coco_eval, metrics
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train.synthetic import shapes_coco_datasets
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

from torch_port_helpers import randomize

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_inference=32, detection_max_instances=10, num_classes=4,
            backbone="resnet18", top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64,
            compute_dtype="float32", detection_min_confidence=0.0, batch_size=2)

# The two predictors' masks agree on >= 99.5 % of pixels (the rule of
# tests/test_torch_port_slice.py: PyTorch's bilinear unmold against cv2's),
# so a mask IoU moves by about 1 % at most and only a detection whose IoU
# lies that close to one of the ten thresholds can change its match there;
# each such change moves a class's AP at one threshold by at most 1/n_gt,
# and a stat by a tenth of that over the classes. 0.02 covers one such flip
# in a class of 5 GT instances.
SEGM_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def scenes(use_masks, n=12):
    for case in range(n):
        rs = np.random.RandomState(700 + case)
        yield golden._random_scene(rs, n_images=rs.randint(1, 5), n_classes=rs.randint(1, 5), use_masks=use_masks)


def assert_same(a, b):
    """Equal values, types and shapes, recursively (NaN equal to NaN)."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("use_masks", [False, True])
def test_metrics_equal_jax(use_masks):
    """``compute_overlaps_*``, ``compute_matches``, ``compute_ap`` and
    ``compute_ap_range`` on every class of every image of 12 seeded scenes."""
    checked = 0
    for images in scenes(use_masks):
        for im in images:
            for cls in np.unique(np.concatenate([im["gt_class_ids"], im["dt_class_ids"]])):
                g, d = im["gt_class_ids"] == cls, im["dt_class_ids"] == cls
                args = (im["gt_boxes"][g], im["gt_class_ids"][g], im["gt_masks"][..., g] if use_masks else None,
                        im["dt_boxes"][d], im["dt_class_ids"][d], im["dt_scores"][d],
                        im["dt_masks"][..., d] if use_masks else None)
                for name, kw in (("compute_matches", dict(iou_threshold=0.6)), ("compute_ap", {}),
                                 ("compute_ap_range", {})):
                    assert_same(getattr(metrics, name)(*args, use_masks=use_masks, **kw),
                                getattr(jax_metrics, name)(*args, use_masks=use_masks, **kw))
                checked += 1
            assert_same(metrics.compute_overlaps_boxes(im["dt_boxes"], im["gt_boxes"]),
                        jax_metrics.compute_overlaps_boxes(im["dt_boxes"], im["gt_boxes"]))
            if use_masks:
                assert_same(metrics.compute_overlaps_masks(im["dt_masks"], im["gt_masks"]),
                            jax_metrics.compute_overlaps_masks(im["dt_masks"], im["gt_masks"]))
    assert checked >= 20


@pytest.mark.parametrize("use_masks", [False, True])
def test_coco_eval_lite_equals_jax(use_masks):
    """``summarize`` and the per-class AP and recall of every area range,
    on 12 seeded scenes, with crowd GT (negative ids) in half of them."""
    for case, images in enumerate(scenes(use_masks)):
        evs = [coco_eval.CocoEvalLite(use_masks=use_masks), jax_coco_eval.CocoEvalLite(use_masks=use_masks)]
        for im in images:
            ids = im["gt_class_ids"].copy()
            # a crowd instance where its class has detections: see test_crowd_without_detections
            if case % 2 and len(ids) and (im["dt_class_ids"] == ids[0]).any():
                ids[0] = -ids[0]
            for ev in evs:
                ev.add_image(im["gt_boxes"], ids, im["dt_boxes"], im["dt_class_ids"], im["dt_scores"],
                             gt_masks=im["gt_masks"], dt_masks=im["dt_masks"])
        if not evs[0]._classes:
            continue
        for area in coco_eval.AREA_KEYS:
            assert_same(evs[0]._accumulate(area), evs[1]._accumulate(area))
        assert_same(evs[0].summarize(verbose=False), evs[1].summarize(verbose=False))


def test_crowd_without_detections():
    """Crowd GT of a class with no detection of that class, in segm: the JAX
    copy fails to reshape the empty mask stack (a fault of the reference);
    the port scores it as pycocotools does, as the same image without the
    crowd instance: no detection to match or ignore."""
    masks = np.zeros((20, 20, 2), np.uint8)
    masks[2:8, 2:8, 0] = masks[10:18, 10:18, 1] = 1
    dt_mask = masks[..., :1].copy()
    boxes = np.array([[2, 2, 8, 8], [10, 10, 18, 18]], np.float64)
    args = (boxes, np.array([1, -2]), boxes[:1], np.array([1]), np.array([0.9]))
    with pytest.raises(ValueError):
        ev = jax_coco_eval.CocoEvalLite(use_masks=True)
        ev.add_image(*args, gt_masks=masks, dt_masks=dt_mask)
        ev.summarize(verbose=False)
    got = coco_eval.CocoEvalLite(use_masks=True)
    got.add_image(*args, gt_masks=masks, dt_masks=dt_mask)
    want = coco_eval.CocoEvalLite(use_masks=True)
    want.add_image(boxes[:1], np.array([1]), *args[2:], gt_masks=masks[..., :1], dt_masks=dt_mask)
    assert_same(got.summarize(verbose=False), want.summarize(verbose=False))
    assert got.summarize(verbose=False)["AP"] == pytest.approx(1.0)


GOLDEN_CASES = [(name, kw) for name in sorted(vars(golden)) if name.startswith("test_")
                for kw in ([{"use_masks": False}, {"use_masks": True}]
                           if "use_masks" in inspect.signature(getattr(golden, name)).parameters else [{}])]


@pytest.mark.parametrize("name,kw", GOLDEN_CASES, ids=[n + "".join(f"-{v}" for v in kw.values())
                                                      for n, kw in GOLDEN_CASES])
def test_golden_case_on_the_port(monkeypatch, name, kw):
    """The hand-derived golden cases, each run on the port's class."""
    monkeypatch.setattr(golden, "CocoEvalLite", coco_eval.CocoEvalLite)
    getattr(golden, name)(**kw)


def test_golden_cases_are_all_there():
    assert len(GOLDEN_CASES) == 14


# ---------------------------------------------------------------------------
# evaluate_dataset
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """5 + 3 synthetic shapes images of 64x64 written as COCO (JPEG, RLE)."""
    root = str(tmp_path_factory.mktemp("coco"))
    shapes_coco_datasets(root, (5, 3), size=64, seed=11)
    return root


def both_datasets(root):
    out = []
    for cls in (CocoDataset, JaxCocoDataset):
        ds = cls()
        ds.load_coco(root, "val")
        ds.prepare()
        out.append(ds)
    return out


class StubPredictor:
    """Fixed results: the k-th image it is handed gets boxes, classes,
    scores and masks drawn from ``RandomState(k)`` at that image's size."""

    def __init__(self):
        self.seen = 0

    def detect(self, images):
        out = []
        for img in images:
            rs = np.random.RandomState(self.seen)
            self.seen += 1
            h, w = img.shape[:2]
            n = rs.randint(0, 6)
            y1, x1 = rs.randint(0, h // 2, n), rs.randint(0, w // 2, n)
            y2, x2 = y1 + rs.randint(4, h // 2, n), x1 + rs.randint(4, w // 2, n)
            masks = np.zeros((h, w, n), bool)
            for i in range(n):
                masks[y1[i]:y2[i], x1[i]:x2[i], i] = True
            out.append({"rois": np.stack([y1, x1, y2, x2], -1).astype(np.int32).reshape(n, 4),
                        "class_ids": rs.randint(1, 4, n).astype(np.int32),
                        "scores": rs.uniform(0.5, 1, n).astype(np.float32), "masks": masks})
        return out


def test_evaluate_dataset_with_a_stub_equals_jax(coco_root):
    """One stub's results through both packages' ``evaluate_dataset`` and
    both packages' datasets (the ragged tail padded the same way)."""
    cfg = MaskRCNNConfig(**TINY)
    ours, theirs = both_datasets(coco_root)
    assert len(ours) == 3
    got = coco_eval.evaluate_dataset(StubPredictor(), ours, cfg, verbose=False)
    want = jax_coco_eval.evaluate_dataset(StubPredictor(), theirs, JaxConfig(**TINY), verbose=False)
    assert_same(got, want)


def test_evaluate_dataset_with_predictors_matches_jax(coco_root):
    """JAX and port predictors on bridged weights (64x64 images, no resize):
    bbox stats equal, segm stats within ``SEGM_TOL``; the port's stream
    route gives the same dict as its ``detect`` route."""
    dense = dict(TINY, rpn_anchor_scales=(16, 24, 32, 48, 64), post_nms_rois_inference=64, detection_max_instances=64)
    jcfg = JaxConfig(**dense)
    jmodel = JaxMaskRCNN(jcfg)
    img = np.zeros((1, 64, 64, 3), np.float32)
    meta = compose_image_meta(0, (64, 64, 3), (64, 64, 3), (0, 0, 64, 64), 1.0, np.ones(4))[None]
    variables = jax.jit(lambda r: jmodel.init({"params": r}, img, meta, train=False))(jax.random.PRNGKey(0))
    variables = randomize(jax.tree.map(np.asarray, variables), np.random.RandomState(1))
    # Random weights as they come match no GT. Smaller RPN class weights
    # spread the scores (no ties); small box deltas keep the detections on
    # their anchors, sized like the shapes; small class logits mix the
    # predicted classes; mask logits near +2 fill each box: some detections
    # match in both bbox and segm.
    p = variables["params"]
    for module, leaf, factor in (("rpn", "rpn_class_raw", 0.1), ("rpn", "rpn_bbox_pred", 0.01),
                                 ("classifier", "mrcnn_bbox_fc", 0.01), ("classifier", "mrcnn_class_logits", 0.05),
                                 ("mask_head", "mrcnn_mask", 0.01)):
        p[module][leaf] = {k: v * np.float32(factor) for k, v in p[module][leaf].items()}
    p["mask_head"]["mrcnn_mask"]["bias"] = p["mask_head"]["mrcnn_mask"]["bias"] + np.float32(2.0)
    cfg = MaskRCNNConfig(**dense)
    state = flax_to_state_dict(variables, MaskRCNN(cfg, device="cpu"))
    ours, theirs = both_datasets(coco_root)
    pred = Predictor(cfg, state, device="cpu")
    got = coco_eval.evaluate_dataset(pred, ours, cfg, verbose=False)
    want = jax_coco_eval.evaluate_dataset(JaxPredictor(jcfg, variables), theirs, jcfg, verbose=False)
    assert_same(got["bbox"], want["bbox"])
    assert got["bbox"]["AP50"] > 0 and got["segm"]["AP50"] > 0
    for k, v in want["segm"].items():
        assert np.isnan(v) == np.isnan(got["segm"][k]) and (np.isnan(v) or abs(got["segm"][k] - v) <= SEGM_TOL), k
    assert_same(coco_eval.evaluate_dataset(pred, ours, cfg, verbose=False, stream_depth=1), got)
