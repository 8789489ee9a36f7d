"""The port's host augmentation (``data/augment.py``, ``data/imgproc.py``)
against cv2 and the JAX package's ``data/augment.py``, on the CPU.

Inputs are seeded: a 96x80 image with 2 masks (the size of
``tests/test_data_pipeline.py``'s augmentation tests) and a 512x512 image
with 7. Tolerances, as measured on this suite's cv2 (5.0, x86-64):

* every primitive equals cv2 bit for bit: both warps (bilinear images,
  nearest masks), both matrices, the Gaussian blurs (uint8 ksize 3/5, float32
  sigma 1/3), the 3x3 box blur, ``filter2D``, the float32 resize, CLAHE,
  ``cv2.line``, and the six colour conversions over all 2**24 uint8 inputs;
* every transform equals the JAX package's output bit for bit, masks
  included, and afterwards both pairs of generators give the same next draw;
* the whole augmentation with both sets at probability 1.0, over seeds that
  take every weather and extended branch, and at the default probabilities,
  is bit-equal to the JAX package's;
* ``load_image_gt`` with the augmentation equals the JAX package's sample
  when the JAX globals are seeded with the two generators' seeds, and a
  loader epoch with it is reproducible.

The port's module never imports cv2 (a subprocess with ``cv2`` blocked runs
it).
"""

import random
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.data import augment as jax_augment
from maskrcnn_tf2_tpu.data.dataset import SegmentationDataset as JaxSegmentationDataset
from maskrcnn_tf2_tpu.data.dataset import load_image_gt as jax_load_image_gt

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data import augment, imgproc
from maskrcnn_tf2_tpu_torch.data.dataset import SegmentationDataset, load_image_gt
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader

from test_torch_port_data import LOADER, _fixed

REPO = Path(__file__).resolve().parents[1]
SIZES = [(96, 80, 2), (512, 512, 7)]


def scene(h, w, n, seed=0):
    """A textured image (noise over colour ramps) and ``n`` rectangle masks."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)], -1)
    image = np.clip(rs.randint(0, 256, (h, w, 3)) * 0.3 + ramps * 0.7, 0, 255).astype(np.uint8)
    masks = np.zeros((h, w, n), bool)
    for i in range(n):
        y, x = rs.randint(0, h - 10), rs.randint(0, w - 10)
        masks[y : y + rs.randint(5, h // 2), x : x + rs.randint(5, w // 2), i] = True
    return image, masks


def assert_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    bad = got != want
    assert not bad.any(), f"{bad.mean():.2e} of the values differ, by up to {np.abs(got.astype(float) - want).max()}"


# ---------------------------------------------------------------------------
# primitives against cv2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,n", SIZES)
def test_rotation_warp_equals_cv2(h, w, n):
    image, masks = scene(h, w, n)
    for angle in np.random.RandomState(1).uniform(10, 270, 4):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        assert_equal(imgproc.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0), m)
        assert_equal(imgproc.warp_affine(image, m, (w, h)), cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR))
        u8 = masks.astype(np.uint8)
        assert_equal(imgproc.warp_affine(u8, m, (w, h), nearest=True), cv2.warpAffine(u8, m, (w, h), flags=cv2.INTER_NEAREST))
    # float32 matrix of the shift-scale, one mask ([H, W] in and out)
    m = np.array([[1.31, 0, -0.17 * w], [0, 1.31, 0.06 * h]], np.float32)
    assert_equal(imgproc.warp_affine(image, m, (w, h)), cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR))
    one = masks[..., 0].astype(np.uint8)
    assert_equal(imgproc.warp_affine(one, m, (w, h), nearest=True), cv2.warpAffine(one, m, (w, h), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("h,w,n", SIZES)
def test_perspective_warp_equals_cv2(h, w, n):
    image, masks = scene(h, w, n)
    rs = np.random.RandomState(2)
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    for _ in range(4):
        dst = (src + rs.uniform(-0.05, 0.05, (4, 2)) * [w, h]).astype(np.float32)
        m = cv2.getPerspectiveTransform(src, dst)
        assert_equal(imgproc.get_perspective_transform(src, dst), m)
        assert_equal(imgproc.warp_perspective(image, m, (w, h)), cv2.warpPerspective(image, m, (w, h), flags=cv2.INTER_LINEAR))
        u8 = masks.astype(np.uint8)
        assert_equal(imgproc.warp_perspective(u8, m, (w, h), nearest=True),
                     cv2.warpPerspective(u8, m, (w, h), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("h,w,n", SIZES + [(7, 5, 1)])
def test_filters_equal_cv2(h, w, n):
    image = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    for k in (3, 5):
        assert_equal(imgproc.gaussian_blur_u8(image, k), cv2.GaussianBlur(image, (k, k), 0))
    f = image.astype(np.float32) * np.float32(0.8123)
    assert_equal(imgproc.box_blur3_f32(f), cv2.blur(f, (3, 3)))
    for row in (True, False):
        kernel = np.zeros((3, 3), np.float32)
        kernel[(1, slice(None)) if row else (slice(None), 1)] = 1.0 / 3
        assert_equal(imgproc.filter2d_u8(image, kernel), cv2.filter2D(image, -1, kernel))
    if h > 8:
        assert_equal(imgproc.gaussian_blur_f32(image.astype(np.float32), 1.0),
                     cv2.GaussianBlur(image.astype(np.float32), (0, 0), 1.0))


@pytest.mark.parametrize("h,w", [(96, 80), (512, 512), (160, 136)])
def test_fog_field_equals_cv2(h, w):
    """The fog's field: a [h/8, w/8] float32 field blurred at sigma 3 (a
    kernel wider than the field) and resized back to [h, w]."""
    field = np.random.RandomState(3).rand(h // 8, w // 8).astype(np.float32)
    blurred = cv2.GaussianBlur(field, (0, 0), 3)
    assert_equal(imgproc.gaussian_blur_f32(field, 3), blurred)
    assert_equal(imgproc.resize_linear_f32(blurred, h, w), cv2.resize(blurred, (w, h)))


def _all_colours(chunk):
    """Every uint8 triplet, a quarter of them at a time ([1024, 4096, 3])."""
    c = np.arange(chunk << 22, (chunk + 1) << 22, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(1024, 4096, 3)


@pytest.mark.parametrize("name", ["hsv", "hls", "lab"])
def test_colour_conversions_equal_cv2_on_every_colour(name):
    fwd, back = getattr(imgproc, f"rgb_to_{name}"), getattr(imgproc, f"{name}_to_rgb")
    to, frm = getattr(cv2, f"COLOR_RGB2{name.upper()}"), getattr(cv2, f"COLOR_{name.upper()}2RGB")
    for chunk in range(4):
        x = _all_colours(chunk)
        assert_equal(fwd(x), cv2.cvtColor(x, to))
        assert_equal(back(x), cv2.cvtColor(x, frm))


@pytest.mark.parametrize("w", [80, 37, 7])
def test_hsv_to_rgb_vector_blocks_and_row_tail(w):
    """cv2 truncates in 32-pixel blocks of a row and rounds the rest."""
    rs = np.random.RandomState(w)
    hsv = np.stack([rs.randint(0, 180, (50, w)), rs.randint(0, 256, (50, w)), rs.randint(0, 256, (50, w))], -1)
    hsv = hsv.astype(np.uint8)
    assert_equal(imgproc.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("h,w", [(96, 80), (512, 512), (100, 37), (33, 50)])
def test_clahe_equals_cv2(h, w):
    rs = np.random.RandomState(h + w)
    ramp = np.add.outer(np.arange(h), np.arange(w)) * 0.7 + rs.randn(h, w) * 8 + 40
    for light in (rs.randint(0, 256, (h, w)), ramp):
        light = np.clip(light, 0, 255).astype(np.uint8)
        assert_equal(imgproc.clahe(light, 2.0, (8, 8)), cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(light))


@pytest.mark.parametrize("h,w", [(96, 80), (512, 512)])
def test_draw_lines_equals_cv2(h, w):
    """The rain's short slanted segments, then long ones with both ends
    outside the image."""
    rs = np.random.RandomState(4)
    for _ in range(3):
        n = h * w // 600
        p0 = np.stack([rs.randint(0, w, n), rs.randint(0, h, n)], 1)
        p1 = p0 + [rs.randint(-10, 11), rs.randint(5, 13)]
        want = np.zeros((h, w, 3), np.float32)
        for a, b in zip(p0, p1):
            cv2.line(want, tuple(map(int, a)), tuple(map(int, b)), (200, 200, 200), 1)
        assert_equal(imgproc.draw_lines(np.zeros((h, w, 3), np.float32), p0, p1, 200.0), want)
    p0, p1 = rs.randint(-50, w + 50, (200, 2)), rs.randint(-50, h + 50, (200, 2))
    want = np.zeros((h, w), np.float32)
    for a, b in zip(p0, p1):
        cv2.line(want, tuple(map(int, a)), tuple(map(int, b)), 1.0, 1)
    assert_equal(imgproc.draw_lines(np.zeros((h, w), np.float32), p0, p1, 1.0), want)


# ---------------------------------------------------------------------------
# transforms against the JAX package
# ---------------------------------------------------------------------------

PHOTOMETRIC = ["_snow", "_rain", "_fog", "_sun_flare", "_clahe", "_gamma", "_sharpen", "_motion_blur",
               "_brightness_contrast", "_hsv_shift"]


def generators(seed):
    """The JAX package's globals and the port's generators, seeded alike."""
    random.seed(seed)
    np.random.seed(seed + 1)
    return random.Random(seed), np.random.RandomState(seed + 1)


def assert_same_next_draw(py_rng, np_rng):
    assert random.random() == py_rng.random()
    assert np.random.rand() == np_rng.rand()


@pytest.mark.parametrize("h,w,n", SIZES)
@pytest.mark.parametrize("name", PHOTOMETRIC + ["_shift_scale", "_perspective"])
def test_transform_equals_jax(name, h, w, n):
    image, masks = scene(h, w, n, seed=len(name))
    for seed in range(2):
        py_rng, np_rng = generators(seed)
        if name in PHOTOMETRIC:
            got, want = getattr(augment, name)(image.copy(), py_rng, np_rng), getattr(jax_augment, name)(image.copy())
        else:
            got, got_m = getattr(augment, name)(image.copy(), masks.copy(), py_rng, np_rng)
            want, want_m = getattr(jax_augment, name)(image.copy(), masks.copy())
            assert_equal(got_m, want_m)
        assert_equal(got, want)
        assert_same_next_draw(py_rng, np_rng)


@pytest.mark.parametrize("h,w,n", SIZES)
def test_rotate_equals_jax(h, w, n):
    image, masks = scene(h, w, n)
    for angle in (10.0, 47.3, 269.9):
        got, got_m = augment._rotate(image, masks, angle)
        want, want_m = jax_augment._rotate(image, masks, angle)
        assert_equal(got, want)
        assert_equal(got_m, want_m)
    empty = np.zeros((h, w, 0), bool)
    assert augment._rotate(image, empty, 30.0)[1].shape == (h, w, 0)


ALL_ON = dict(hflip_prob=1.0, vflip_prob=1.0, rotate_prob=1.0, blur_prob=1.0, noise_prob=1.0,
              channel_shuffle_prob=1.0, weather_prob=1.0, extended_prob=1.0)


@pytest.mark.parametrize("h,w,n", SIZES)
def test_whole_augmentation_equals_jax(h, w, n, monkeypatch):
    """Both sets at probability 1.0 until every weather and extended branch
    has been taken, then the default probabilities."""
    image, masks = scene(h, w, n)
    taken = set()
    branches = {f.__name__ for f in augment.WEATHER + augment.EXTENDED}

    def recorded(fn):
        def wrapper(*args):
            taken.add(fn.__name__)
            return fn(*args)
        return wrapper

    monkeypatch.setattr(augment, "WEATHER", tuple(map(recorded, augment.WEATHER)))
    extended = tuple(map(recorded, augment.EXTENDED))
    monkeypatch.setattr(augment, "EXTENDED", extended)
    monkeypatch.setattr(augment, "GEOMETRIC", extended[:2])
    for probs, seeds in ((ALL_ON, range(40)), ({}, range(6))):
        port = augment.get_training_augmentation(extended=True, weather=True, **probs)
        ref = jax_augment.get_training_augmentation(extended=True, weather=True, **probs)
        for seed in seeds:
            py_rng, np_rng = generators(seed)
            got, got_m = port(image, masks, py_rng, np_rng)
            want, want_m = ref(image, masks)
            assert_equal(got, want)
            assert_equal(got_m, want_m)
            assert_same_next_draw(py_rng, np_rng)
            if probs and taken >= branches:
                break
        assert taken >= branches, branches - taken


def test_default_augmentation_equals_jax():
    """No optional set: flips, rotation, blur and noise only."""
    image, masks = scene(96, 80, 2)
    port, ref = augment.get_training_augmentation(), jax_augment.get_training_augmentation()
    for seed in range(10):
        py_rng, np_rng = generators(seed)
        got, got_m = port(image, masks, py_rng, np_rng)
        want, want_m = ref(image, masks)
        assert_equal(got, want)
        assert_equal(got_m, want_m)
        assert_same_next_draw(py_rng, np_rng)


def test_module_needs_no_cv2():
    """The port's augmentation runs with ``cv2`` unimportable."""
    code = textwrap.dedent(
        """
        import random, sys
        sys.modules["cv2"] = None
        import numpy as np
        from maskrcnn_tf2_tpu_torch.data.augment import get_training_augmentation
        aug = get_training_augmentation(extended=True, weather=True, rotate_prob=1.0, extended_prob=1.0)
        rs = np.random.RandomState(0)
        for seed in range(12):
            img, m = aug(rs.randint(0, 256, (64, 48, 3)).astype(np.uint8), rs.rand(64, 48, 2) > 0.5,
                         random.Random(seed), np.random.RandomState(seed))
            assert img.shape == (64, 48, 3) and m.shape == (64, 48, 2)
        assert "cv2" not in {k for k, v in sys.modules.items() if v is not None}
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# the sample and the loader
# ---------------------------------------------------------------------------


def test_load_image_gt_with_augmentation_equals_jax():
    """The per-sample ``rng`` seeds the augmentation's two generators; the
    JAX package's globals seeded with those seeds give the same sample
    (no instance subsample: at most 4 instances)."""
    ours, ref = _fixed(SegmentationDataset)(10), _fixed(JaxSegmentationDataset)(10)
    cfg = dict(LOADER, max_gt_instances=4)
    port_aug = augment.get_training_augmentation(extended=True, weather=True, rotate_prob=0.5)
    jax_aug = jax_augment.get_training_augmentation(extended=True, weather=True, rotate_prob=0.5)
    compared = 0
    for i in range(10):
        got = load_image_gt(ours, MaskRCNNConfig(**cfg), i, port_aug, rng=np.random.RandomState(200 + i))
        if i % 5 == 0:
            assert got is None
            continue
        seeds = np.random.RandomState(200 + i)
        random.seed(int(seeds.randint(2**31 - 1)))
        np.random.seed(int(seeds.randint(2**31 - 1)))
        want = jax_load_image_gt(ref, JaxConfig(**cfg), i, jax_aug)
        assert (got is None) == (want is None)
        if want is not None:
            compared += 1
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert compared >= 6


def test_loader_epoch_with_augmentation_is_reproducible():
    ds = _fixed(SegmentationDataset)(11)
    cfg = MaskRCNNConfig(**dict(LOADER, max_gt_instances=4))
    aug = augment.get_training_augmentation(extended=True, weather=True)
    epochs = [list(DataLoader(ds, cfg, seed=5, augment_fn=aug).epoch(num_workers=3)) for _ in range(2)]
    assert len(epochs[0]) == len(epochs[1]) == 4
    for a, b in zip(*epochs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    plain = list(DataLoader(ds, cfg, seed=5).epoch(num_workers=3))
    assert any((a["images"] != b["images"]).any() for a, b in zip(epochs[0], plain))
