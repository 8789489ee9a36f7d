"""The PyTorch port's data pipeline against the JAX package's, on the CPU.

The JAX package uses cv2 for decoding, resizing and drawing; the port uses
Pillow (``data/image_io.py``), PyTorch's bilinear resize, numpy nearest
resizes and its own rasterizer (``data/raster.py``). Tolerances: window,
scale, padding and crop equal, uint8 pixels of a bilinear resize within 1
grey level (cv2's fixed-point weights); nearest resizes, mini masks, boxes,
class ids and meta exact; rectangles, circles and polygons inside the image
pixel for pixel equal to cv2's; polygons with vertices on or past the border
>= 99 % of each mask equal and boxes within 1 px; the RLE codec exact; the
loader's image order, skips and cycling exact; the port's JPEG export
decodes to the JAX exporter's pixels.
"""

import ast
import json
import random
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.data import coco as jax_coco
from maskrcnn_tf2_tpu.data import transforms as jax_transforms
from maskrcnn_tf2_tpu.data.dataset import SegmentationDataset as JaxSegmentationDataset
from maskrcnn_tf2_tpu.data.dataset import VIADataset as JaxVIADataset
from maskrcnn_tf2_tpu.data.dataset import load_image_gt as jax_load_image_gt
from maskrcnn_tf2_tpu.data.loader import DataLoader as JaxDataLoader
from maskrcnn_tf2_tpu.data.random_rois import generate_random_rois as jax_random_rois
from maskrcnn_tf2_tpu.data.synthetic import SyntheticShapesDataset as JaxShapes
from maskrcnn_tf2_tpu.export import inference as jax_inference

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import coco, raster, transforms
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset, VIADataset, load_image_gt
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader, prefetch, prefetch_to_device
from maskrcnn_tf2_tpu_torch.data.random_rois import generate_random_rois
from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
from maskrcnn_tf2_tpu_torch.data.synthetic_coco import export_coco_format
from maskrcnn_tf2_tpu_torch.export import inference as port_inference
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

REPO = Path(__file__).resolve().parents[1]
LOADER = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, num_classes=4, max_gt_instances=3,
              mini_mask_shape=(16, 16), batch_size=2)


def smooth_image(rs, h, w):
    x = rs.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3))
    x = np.repeat(np.repeat(x, 8, 0), 8, 1)[:h, :w]
    return np.clip(x + rs.normal(0, 8, x.shape), 0, 255).astype(np.uint8)


def shapes(cls, n, size=64, seed=1):
    ds = cls()
    ds.load_shapes(n, size, size, seed=seed)
    ds.prepare()
    return ds


# ---------------------------------------------------------------------------
# imports, configuration
# ---------------------------------------------------------------------------


def test_port_imports_no_jax_cv2_or_jax_package():
    """No module of the port and nothing in chip_smoke.py imports jax, flax,
    optax, orbax, cv2 or the JAX package."""
    banned = ("jax", "flax", "optax", "orbax", "cv2", "maskrcnn_tf2_tpu")
    files = sorted((REPO / "maskrcnn_tf2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert len(files) > 40 and not found, found


@pytest.mark.parametrize("over", [{}, dict(backbone="resnet50", image_shape=(256, 256, 3), augment_on_device=True)])
def test_config_md5_and_yaml_match_jax(over, tmp_path):
    """The same knobs hash the same in both packages (checkpoint directory
    names agree), and the YAML round trip is lossless and strict."""
    cfg = MaskRCNNConfig(**over)
    assert cfg.md5() == JaxConfig(**over).md5()
    cfg.to_yaml(str(tmp_path / "c.yaml"))
    assert MaskRCNNConfig.from_yaml(str(tmp_path / "c.yaml")) == cfg
    assert JaxConfig.from_yaml(str(tmp_path / "c.yaml")).md5() == cfg.md5()
    (tmp_path / "bad.yaml").write_text("image_shapes: [1, 2, 3]\n")
    with pytest.raises(ValueError, match="image_shapes"):
        MaskRCNNConfig.from_yaml(str(tmp_path / "bad.yaml"))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

RESIZE_CASES = {
    "square": dict(min_dim=100, max_dim=128),
    "pad64": dict(min_dim=128, max_dim=128),
    "crop": dict(min_dim=64, max_dim=64),
    "none": dict(min_dim=64, max_dim=128),
}


@pytest.mark.parametrize("mode", list(RESIZE_CASES))
def test_resize_image_matches_jax(mode):
    img = smooth_image(np.random.RandomState(0), 90, 120)
    kw = dict(RESIZE_CASES[mode], mode=mode)
    random.seed(3)  # the JAX package's crop draws from the global generator
    ref = jax_transforms.resize_image(img, **kw)
    ours = transforms.resize_image(img, **kw, rng=random.Random(3))
    for i in range(1, 5):  # window, scale, padding, crop
        assert ours[i] == ref[i], (mode, i)
    assert ours[0].shape == ref[0].shape and ours[0].dtype == ref[0].dtype
    assert np.abs(ours[0].astype(int) - ref[0].astype(int)).max() <= 1
    if mode == "crop":
        assert ref[4] is not None and ref[4][:2] != (0, 0)


def test_masks_boxes_and_mini_masks_match_jax():
    rs = np.random.RandomState(1)
    for h, w, scale in [(90, 120, 128 / 90), (64, 64, 1.0), (100, 80, 0.6), (37, 53, 2.5)]:
        masks = np.zeros((h, w, 3), bool)
        for i in range(3):
            y, x = rs.randint(0, h - 8), rs.randint(0, w - 8)
            masks[y : y + rs.randint(3, h - y), x : x + rs.randint(3, w - x), i] = rs.uniform(size=()) > 0.2
        masks[..., 1] &= rs.uniform(size=(h, w)) > 0.3  # ragged
        _, _, _, padding, _ = jax_transforms.resize_image(np.zeros((h, w, 3), np.uint8), min_dim=None,
                                                          max_dim=max(round(h * scale), round(w * scale)) + 6)
        got = transforms.resize_mask(masks, scale, padding)
        want = jax_transforms.resize_mask(masks, scale, padding)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(transforms.resize_mask(masks, scale, padding, (2, 3, 20, 30)),
                                      jax_transforms.resize_mask(masks, scale, padding, (2, 3, 20, 30)))
        boxes = transforms.extract_bboxes(got)
        np.testing.assert_array_equal(boxes, jax_transforms.extract_bboxes(want))
        for mini_shape in [(56, 56), (7, 11)]:
            mini = transforms.minimize_mask(boxes, got, mini_shape)
            np.testing.assert_array_equal(mini, jax_transforms.minimize_mask(boxes, want, mini_shape))
            np.testing.assert_array_equal(transforms.expand_mask(boxes, mini, got.shape),
                                          jax_transforms.expand_mask(boxes, mini, got.shape))


def test_raster_matches_cv2():
    rs = np.random.RandomState(2)
    for _ in range(100):
        h, w = rs.randint(16, 160, 2)
        c = tuple(int(v) for v in rs.randint(1, 255, 3))
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        p1, p2 = (int(rs.randint(-20, w + 20)), int(rs.randint(-20, h + 20))), (int(rs.randint(-20, w + 20)),
                                                                             int(rs.randint(-20, h + 20)))
        np.testing.assert_array_equal(raster.fill_rectangle(b, p1, p2, c), cv2.rectangle(a, p1, p2, c, -1))
        center, r = (int(rs.randint(-20, w + 20)), int(rs.randint(-20, h + 20))), int(rs.randint(0, 60))
        np.testing.assert_array_equal(raster.fill_circle(b, center, r, c), cv2.circle(a, center, r, c, -1))
    shares, box_err = [], 0
    for i in range(300):
        h, w = rs.randint(16, 200, 2)
        n = rs.randint(3, 40)
        ang = np.sort(rs.uniform(0, 2 * np.pi, n))
        rad = rs.uniform(2, min(h, w) * (0.45 if i % 2 else 0.8), n)
        pts = np.stack([w / 2 + rad * np.cos(ang), h / 2 + rad * np.sin(ang)], 1)
        inside = i % 2 == 1  # vertices strictly inside; else clipped onto [0, w] x [0, h]
        pts = np.round(np.clip(pts, 0, [w - 1, h - 1] if inside else [w, h])).astype(np.int32)
        a = cv2.fillPoly(np.zeros((h, w), np.uint8), [pts], 1)
        b = raster.fill_polygon(np.zeros((h, w), np.uint8), pts, 1)
        if inside:
            np.testing.assert_array_equal(a, b)
        shares.append((a == b).mean())
        ba, bb = (jax_transforms.extract_bboxes(m[..., None].astype(bool)) for m in (a, b))
        box_err = max(box_err, int(np.abs(ba - bb).max()))
    assert min(shares) >= 0.99 and box_err <= 1, (min(shares), box_err)


def test_synthetic_shapes_match_jax():
    """Same registration draws; images and masks drawn pixel for pixel as cv2
    draws them."""
    ours, ref = shapes(SyntheticShapesDataset, 6, 96, seed=4), shapes(JaxShapes, 6, 96, seed=4)
    assert ours.image_info == ref.image_info and ours.class_names == ref.class_names
    for i in range(6):
        np.testing.assert_array_equal(ours.load_image(i), ref.load_image(i))
        for got, want in zip(ours.load_mask(i), ref.load_mask(i)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# COCO, VIA
# ---------------------------------------------------------------------------


def _compress_counts(counts):
    """COCO's compressed RLE string of run lengths (the encoder of the spec)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((c & 0x10) == 0 and x == 0 or (c & 0x10) != 0 and x == -1)
            out.append(chr(c + 48 + (0x20 if more else 0)))
    return "".join(out)


def test_rle_codec_matches_jax():
    rs = np.random.RandomState(5)
    for h, w in [(1, 1), (17, 23), (64, 48)]:
        for p in (0.0, 0.3, 0.97):
            m = rs.uniform(size=(h, w)) < p
            rle = coco.mask_to_rle(m)
            assert rle == jax_coco.mask_to_rle(m)
            np.testing.assert_array_equal(coco.rle_to_mask(rle, h, w), m)
            s = _compress_counts(rle["counts"])
            assert coco._decode_rle_counts(s) == jax_coco._decode_rle_counts(s) == rle["counts"]
            np.testing.assert_array_equal(coco.rle_to_mask({"counts": s, "size": [h, w]}, h, w),
                                          jax_coco.rle_to_mask({"counts": s, "size": [h, w]}, h, w))


def test_export_coco_read_back_by_jax(tmp_path):
    """The port's export, read back by the JAX package's CocoDataset: masks
    and class ids exact; the JPEGs decode to the pixels of the JAX exporter's
    (Pillow and cv2 encode alike at quality 95), and image 0 of the JAX
    test's scene within its mean error of 8; the port's CocoDataset reads
    the same as the JAX one."""
    from maskrcnn_tf2_tpu.data.synthetic_coco import export_coco_format as jax_export

    src = shapes(SyntheticShapesDataset, 3, 64, seed=7)
    export_coco_format(src, str(tmp_path / "port"), subset="val")
    jax_export(shapes(JaxShapes, 3, 64, seed=7), str(tmp_path / "jax"), subset="val")
    sets = []
    for cls, root in ((jax_coco.CocoDataset, "port"), (coco.CocoDataset, "port"), (jax_coco.CocoDataset, "jax")):
        dst = cls()
        dst.load_coco(str(tmp_path / root), "val")
        dst.prepare()
        assert dst.class_names == src.class_names and len(dst) == 3
        for i in range(3):
            for got, want in zip(dst.load_mask(i), src.load_mask(i)):
                np.testing.assert_array_equal(got, want)
        sets.append([dst.load_image(i) for i in range(3)])
    assert np.abs(sets[0][0].astype(np.float32) - src.load_image(0)).mean() < 8.0
    for a, b, c in zip(*sets):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_coco_polygons_and_crowd_match_jax(tmp_path):
    rs = np.random.RandomState(7)
    anns = []
    for k in range(6):
        ang = np.sort(rs.uniform(0, 2 * np.pi, 12))
        xy = np.stack([50 + rs.uniform(5, 40, 12) * np.cos(ang), 40 + rs.uniform(5, 35, 12) * np.sin(ang)], 1)
        anns.append({"id": k + 1, "image_id": 1, "category_id": 1 + k % 2, "iscrowd": int(k == 5),
                     "segmentation": [np.clip(xy, 0, [100, 80]).reshape(-1).round(1).tolist()]})
    (tmp_path / "annotations").mkdir()
    (tmp_path / "annotations" / "instances_train2017.json").write_text(json.dumps({
        "images": [{"id": 1, "file_name": "a.png", "width": 100, "height": 80}], "annotations": anns,
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}, {"id": 3, "name": "c"}]}))
    sets = []
    for cls in (coco.CocoDataset, jax_coco.CocoDataset):
        ds = cls()
        ds.load_coco(str(tmp_path), "train", class_ids=[1, 2])
        ds.prepare()
        sets.append(ds.load_mask(0))
    np.testing.assert_array_equal(sets[0][1], sets[1][1])
    assert sets[0][1].tolist()[-1] < 0  # crowd -> negative class id
    for i in range(len(anns)):
        assert (sets[0][0][..., i] == sets[1][0][..., i]).mean() >= 0.99


def test_via_dataset_matches_jax(tmp_path):
    rs = np.random.RandomState(8)
    ann = {}
    for i in range(3):
        name = f"img{i}.png"
        cv2.imwrite(str(tmp_path / name), smooth_image(rs, 96, 120))
        ann[name] = {"filename": name, "regions": {
            "0": {"shape_attributes": {"all_points_x": [10, 50, 30], "all_points_y": [10, 15, 60]},
                  "region_attributes": {}},
            "1": {"shape_attributes": {"all_points_x": [70, 110, 104, 70], "all_points_y": [20, 20, 70, 66]},
                  "region_attributes": {"class": "balloon"}}}}
    ann["missing.png"] = {"filename": "missing.png", "regions": ann["img0.png"]["regions"]}
    (tmp_path / "via.json").write_text(json.dumps(ann))
    class_dict = {"background": 0, "balloon": 1, "kite": 2}
    ours, ref = VIADataset(), JaxVIADataset()
    for ds in (ours, ref):
        ds.load_via(str(tmp_path), "via.json", class_dict)
        ds.prepare()
    assert len(ours) == len(ref) == 3 and ours.image_info == ref.image_info
    cfg = dict(image_shape=(128, 128, 3), image_min_dim=100, image_max_dim=128, num_classes=3)
    for i in range(3):
        np.testing.assert_array_equal(ours.load_image(i), ref.load_image(i))
        for got, want in zip(ours.load_mask(i), ref.load_mask(i)):
            np.testing.assert_array_equal(got, want)
        got, want = load_image_gt(ours, MaskRCNNConfig(**cfg), i), jax_load_image_gt(ref, JaxConfig(**cfg), i)
        for k in ("gt_class_ids", "gt_boxes", "gt_masks", "image_meta", "window"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# load_image_gt, the loader
# ---------------------------------------------------------------------------


def _fixed(base):
    """A dataset class over fixed arrays, the same for both packages: image i
    has i % 5 instances (image 0 none), some of them more than
    max_gt_instances."""

    class Fixed(base):
        def __init__(self, n, h=64, w=64, seed=9):
            super().__init__()
            self.add_class("fx", 1, "a")
            self.add_class("fx", 2, "b")
            rs = np.random.RandomState(seed)
            for i in range(n):
                masks = np.zeros((h, w, i % 5), bool)
                for k in range(i % 5):
                    y, x = rs.randint(0, h - 12, 2)
                    masks[y : y + rs.randint(4, 12), x : x + rs.randint(4, 12), k] = True
                self.add_image("fx", i, None, image=smooth_image(rs, h, w), masks=masks,
                               ids=rs.randint(1, 3, i % 5).astype(np.int32))
            self.prepare()

        def load_image(self, idx):
            return self.image_info[idx]["image"]

        def load_mask(self, idx):
            return self.image_info[idx]["masks"], self.image_info[idx]["ids"]

    return Fixed


@pytest.mark.parametrize("size", [(64, 64), (48, 40)])
def test_load_image_gt_matches_jax(size):
    """Boxes, class ids, mini masks and meta exact (at scale 1 and through a
    resize); the max_gt_instances subsample draws what np.random.seed gives
    the JAX package."""
    ours, ref = _fixed(SegmentationDataset)(8, *size), _fixed(JaxSegmentationDataset)(8, *size)
    cfg = dict(LOADER, image_min_dim=64, image_max_dim=64)
    for i in range(8):
        got = load_image_gt(ours, MaskRCNNConfig(**cfg), i, rng=np.random.RandomState(100 + i))
        if i % 5 == 0:  # no instance (cv2 cannot resize the JAX package's empty [H, W, 0] masks)
            assert got is None
            continue
        np.random.seed(100 + i)
        want = jax_load_image_gt(ref, JaxConfig(**cfg), i)
        for k in want:
            if k == "image":
                assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= (0 if size == (64, 64) else 1)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["gt_masks"].dtype == np.uint8 and got["image"].dtype == np.uint8


def test_loader_order_skips_and_cycling_match_jax():
    ours, ref = _fixed(SegmentationDataset)(11), _fixed(JaxSegmentationDataset)(11)
    cfg = dict(LOADER, max_gt_instances=4)  # no subsample: both draw nothing
    lo, lj = DataLoader(ours, MaskRCNNConfig(**cfg), seed=3), JaxDataLoader(ref, JaxConfig(**cfg), seed=3)
    assert lo.steps_per_epoch == lj.steps_per_epoch == 5
    for fixed in (None, None, 7):
        got, want = list(lo.epoch(num_workers=3, fixed_steps=fixed)), list(lj.epoch(num_workers=3, fixed_steps=fixed))
        assert len(got) == len(want) == (fixed or 4)  # 11 images, 3 without instances, batch 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].astype(w[k].dtype), w[k], err_msg=k)
            assert g["images"].dtype == np.uint8 and g["gt_masks"].dtype == np.uint8
    # skip_epochs replays the shuffles: a fresh loader's 4th epoch is this one's
    fresh = DataLoader(ours, MaskRCNNConfig(**cfg), seed=3)
    fresh.skip_epochs(3)
    nxt = [b["image_meta"][:, 0].tolist() for b in lo.epoch()]
    assert [b["image_meta"][:, 0].tolist() for b in fresh.epoch()] == nxt
    assert [b["image_meta"][:, 0].tolist() for b in lj.epoch()] == nxt


def test_loader_sample_cache_and_random_rois(tmp_path):
    """Cached samples equal fresh ones and the cache misses when a knob or
    the dataset changes; random_rois attach one [R, 4] set per image."""
    ds = shapes(SyntheticShapesDataset, 4)
    cfg = MaskRCNNConfig(**LOADER, sample_cache_dir=str(tmp_path))
    cold = list(DataLoader(ds, cfg, shuffle=False).epoch())
    (tag,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert len(list(tag.glob("*.npz"))) == 4 and not list(tag.glob("*.tmp*"))
    warm = list(DataLoader(ds, cfg, shuffle=False).epoch())
    for c, w in zip(cold, warm):
        for k in c:
            np.testing.assert_array_equal(c[k], w[k])
    plain = list(DataLoader(ds, cfg.replace(sample_cache_dir=None), shuffle=False).epoch())
    for c, p in zip(cold, plain):
        for k in c:
            np.testing.assert_array_equal(c[k], p[k])
    list(DataLoader(ds, cfg.replace(mini_mask_shape=(8, 8)), shuffle=False).epoch())
    list(DataLoader(shapes(SyntheticShapesDataset, 4, seed=99), cfg, shuffle=False).epoch())
    assert len([p for p in tmp_path.iterdir() if p.is_dir()]) == 3
    rois = list(DataLoader(ds, cfg.replace(random_rois=10, sample_cache_dir=None), seed=1).epoch())
    assert all(b["input_rois"].shape == (2, 10, 4) for b in rois)
    again = list(DataLoader(ds, cfg.replace(random_rois=10, sample_cache_dir=None), seed=1).epoch())
    assert all(np.array_equal(a["input_rois"], b["input_rois"]) for a, b in zip(rois, again))


def test_random_rois_match_jax():
    gt = np.zeros((5, 4), np.float32)
    gt[:3] = [[0.1, 0.1, 0.4, 0.5], [0.5, 0.2, 0.9, 0.6], [0.3, 0.6, 0.6, 0.95]]
    for count, boxes in [(20, gt), (7, gt), (9, np.zeros((5, 4), np.float32))]:
        np.testing.assert_array_equal(generate_random_rois((64, 64, 3), count, boxes, np.random.RandomState(4)),
                                      jax_random_rois((64, 64, 3), count, boxes, np.random.RandomState(4)))


def test_prefetch_raises_the_producer_error_and_stops():
    def items():
        yield 1
        yield 2
        raise KeyError("bad sample")

    it = prefetch(items(), size=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="bad sample"):
        next(it)
    batches = prefetch_to_device(iter([{"a": np.ones(3, np.uint8)}] * 5), size=2, device="cpu")
    first = next(batches)
    assert first["a"].dtype == torch.uint8 and first["a"].device.type == "cpu"
    batches.close()  # leaving early stops the thread


# ---------------------------------------------------------------------------
# serving in other resize modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pad64", "crop", "none"])
def test_process_input_matches_jax_in_every_mode(mode):
    img = smooth_image(np.random.RandomState(10), 90, 120)
    kw = dict(image_resize_mode=mode, image_min_dim=128 if mode == "pad64" else 64, image_max_dim=128)
    random.seed(0)
    ref, ref_meta = jax_inference.process_input(img, JaxConfig(**kw), image_id=2)
    if mode == "crop":  # the JAX package draws from the global generator: only the geometry can agree
        random.seed(0)
    ours, meta = port_inference.process_input(img, MaskRCNNConfig(**kw), image_id=2)
    if mode != "crop":
        np.testing.assert_array_equal(meta, ref_meta)
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    assert ours.shape == ref.shape and ours.dtype == np.uint8


def test_serves_a_pad64_config():
    """A 90x120 image at min_dim 128: resized to 128x171, padded to 128x192,
    the configuration's image_shape; served on the CPU end to end."""
    cfg = MaskRCNNConfig(image_shape=(128, 192, 3), image_resize_mode="pad64", image_min_dim=128, image_max_dim=128,
                         rpn_anchor_scales=(8, 16, 32, 64, 128), backbone="resnet18", top_down_pyramid_size=64,
                         fpn_cls_fc_layers_size=64, mask_conv_channels=64, pre_nms_limit=256,
                         post_nms_rois_inference=64, num_classes=3, compute_dtype="float32",
                         detection_min_confidence=0.0)
    img = smooth_image(np.random.RandomState(11), 90, 120)
    ref, ref_meta = jax_inference.process_input(img, JaxConfig(**cfg.to_dict()), image_id=0)
    molded, meta = port_inference.process_input(img, cfg, image_id=0)
    np.testing.assert_array_equal(meta, ref_meta)
    assert molded.shape == ref.shape == (128, 192, 3)
    assert np.abs(molded.astype(int) - ref.astype(int)).max() <= 1
    model = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(0))
    (result,) = Predictor(cfg, model.state_dict(), device="cpu").detect([img])
    n = len(result["class_ids"])
    assert n >= 1 and result["masks"].shape == (90, 120, n)
    assert np.all(result["rois"][:, 2] <= 90) and np.all(result["rois"][:, 3] <= 120)
