"""Host-side training augmentation in numpy (counterpart of
``maskrcnn_tf2_tpu/data/augment.py``), without cv2.

The same transforms in the same order with the same defaults: flips,
rotation, Gaussian blur, multiplicative noise, channel shuffle, the optional
``weather`` set (snow / rain / fog / sun flare) and the optional ``extended``
set (shift-scale, perspective, CLAHE, gamma, sharpen, motion blur,
brightness-contrast, HSV shift), geometric transforms applied to the image
and, nearest, to its per-instance masks. The cv2 calls are
``data/imgproc.py``'s numpy versions, which return cv2's pixels.

Randomness: the JAX package draws from the global ``random`` and
``np.random``; here the returned ``augment(image, masks, py_rng, np_rng)``
draws from the two generators it is handed, the same draws in the same
order, so that ``random.seed(a); np.random.seed(b)`` there and
``random.Random(a), np.random.RandomState(b)`` here give the same transforms
and leave the generators in the same state.
"""

from __future__ import annotations

import random
from typing import Callable, Tuple

import numpy as np

from maskrcnn_tf2_tpu_torch.data import imgproc

Arrays = Tuple[np.ndarray, np.ndarray]


def _warp_masks(masks: np.ndarray, m: np.ndarray, wh, perspective: bool = False) -> np.ndarray:
    if not masks.shape[-1]:
        return masks
    warp = imgproc.warp_perspective if perspective else imgproc.warp_affine
    return warp(masks.astype(np.uint8), m, wh, nearest=True).astype(bool)


def _rotate(image: np.ndarray, masks: np.ndarray, angle: float) -> Arrays:
    h, w = image.shape[:2]
    m = imgproc.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
    return imgproc.warp_affine(image, m, (w, h)), _warp_masks(masks, m, (w, h))


def _to_u8(image: np.ndarray) -> np.ndarray:
    return np.clip(image, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# weather set
# ---------------------------------------------------------------------------


def _snow(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    """Brighten a random low-lightness band toward white."""
    hls = imgproc.rgb_to_hls(_to_u8(image.astype(np.float32))).astype(np.float32)
    thresh = py_rng.uniform(100, 150)
    boost = py_rng.uniform(1.5, 2.5)
    light = hls[..., 1]
    hls[..., 1] = np.where(light < thresh, np.minimum(light * boost, 255), light)
    return imgproc.hls_to_rgb(hls.astype(np.uint8))


def _rain(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    """Slanted bright streaks and a slight darkening."""
    h, w = image.shape[:2]
    img = image.astype(np.float32) * py_rng.uniform(0.7, 0.9)
    n_drops = int(h * w / 600)
    slant = py_rng.randint(-10, 10)
    length = py_rng.randint(5, 12)
    xs = np_rng.randint(0, w, n_drops)
    ys = np_rng.randint(0, h, n_drops)
    starts = np.stack([xs, ys], 1)
    overlay = imgproc.draw_lines(img.copy(), starts, starts + [slant, length], 200.0)
    return _to_u8(imgproc.box_blur3_f32(overlay))


def _fog(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    """Blend toward grey with a smooth random intensity field."""
    h, w = image.shape[:2]
    coef = py_rng.uniform(0.2, 0.45)
    field = imgproc.gaussian_blur_f32(np_rng.rand(max(h // 8, 1), max(w // 8, 1)).astype(np.float32), 3)
    field = imgproc.resize_linear_f32(field, h, w)[..., None] * coef + coef * 0.5
    img = image.astype(np.float32)
    return _to_u8(img * (1 - field) + 255.0 * field)


def _sun_flare(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    """A radial bright flare at a random point."""
    h, w = image.shape[:2]
    cx, cy = py_rng.randint(0, w - 1), py_rng.randint(0, h // 2)
    radius = py_rng.randint(min(h, w) // 6, min(h, w) // 3)
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    glow = np.exp(-d2 / (2.0 * (radius / 2.0) ** 2))[..., None]
    img = image.astype(np.float32)
    return _to_u8(img + glow * py_rng.uniform(120, 220))


# ---------------------------------------------------------------------------
# extended set
# ---------------------------------------------------------------------------


def _shift_scale(image: np.ndarray, masks: np.ndarray, py_rng: random.Random,
                 np_rng: np.random.RandomState) -> Arrays:
    """Scale by 1 +- 0.5 about the centre and shift by up to 10 %, zero border."""
    h, w = image.shape[:2]
    scale = 1.0 + py_rng.uniform(-0.5, 0.5)
    tx = py_rng.uniform(-0.1, 0.1) * w
    ty = py_rng.uniform(-0.1, 0.1) * h
    m = np.array([[scale, 0, tx + (1 - scale) * w / 2], [0, scale, ty + (1 - scale) * h / 2]], np.float32)
    return imgproc.warp_affine(image, m, (w, h)), _warp_masks(masks, m, (w, h))


def _perspective(image: np.ndarray, masks: np.ndarray, py_rng: random.Random,
                 np_rng: np.random.RandomState) -> Arrays:
    """Move each corner by up to 5 % of the side."""
    h, w = image.shape[:2]
    d = 0.05
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    dst = (src + np_rng.uniform(-d, d, (4, 2)) * [w, h]).astype(np.float32)
    m = imgproc.get_perspective_transform(src, dst)
    return imgproc.warp_perspective(image, m, (w, h)), _warp_masks(masks, m, (w, h), perspective=True)


def _clahe(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    lab = imgproc.rgb_to_lab(image)
    lab[..., 0] = imgproc.clahe(lab[..., 0], 2.0, (8, 8))
    return imgproc.lab_to_rgb(lab)


def _gamma(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    g = py_rng.uniform(0.7, 1.4)
    lut = (np.linspace(0, 1, 256) ** g * 255).astype(np.uint8)
    return lut[image]


def _sharpen(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    blur = imgproc.gaussian_blur_f32(image.astype(np.float32), 1.0)
    alpha = py_rng.uniform(0.3, 0.7)
    return _to_u8(image.astype(np.float32) * (1 + alpha) - blur * alpha)


def _motion_blur(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    k = 3
    kernel = np.zeros((k, k), np.float32)
    if py_rng.random() < 0.5:
        kernel[k // 2, :] = 1.0 / k
    else:
        kernel[:, k // 2] = 1.0 / k
    return imgproc.filter2d_u8(image, kernel)


def _brightness_contrast(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    alpha = 1.0 + py_rng.uniform(-0.2, 0.2)  # contrast
    beta = py_rng.uniform(-0.2, 0.2) * 255  # brightness
    return _to_u8(image.astype(np.float32) * alpha + beta)


def _hsv_shift(image: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> np.ndarray:
    hsv = imgproc.rgb_to_hsv(image).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + py_rng.randint(-10, 10)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + py_rng.randint(-20, 20), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] + py_rng.randint(-20, 20), 0, 255)
    return imgproc.hsv_to_rgb(hsv.astype(np.uint8))


WEATHER = (_snow, _rain, _fog, _sun_flare)
EXTENDED = (_shift_scale, _perspective, _clahe, _gamma, _sharpen, _motion_blur, _brightness_contrast, _hsv_shift)
GEOMETRIC = (_shift_scale, _perspective)  # these take and return the masks too


def get_training_augmentation(
    extended: bool = False,
    weather: bool = False,
    hflip_prob: float = 0.5,
    vflip_prob: float = 0.0,
    rotate_prob: float = 0.2,
    blur_prob: float = 0.2,
    noise_prob: float = 0.2,
    channel_shuffle_prob: float = 0.1,
    weather_prob: float = 0.3,
    extended_prob: float = 0.5,
) -> Callable[[np.ndarray, np.ndarray, random.Random, np.random.RandomState], Arrays]:
    """Returns ``augment(image [H, W, 3] uint8, masks [H, W, N] bool, py_rng,
    np_rng)``. ``weather`` and ``extended`` each add one transform drawn from
    their set per application."""

    def augment(image: np.ndarray, masks: np.ndarray, py_rng: random.Random, np_rng: np.random.RandomState) -> Arrays:
        if py_rng.random() < hflip_prob:
            image = image[:, ::-1]
            masks = masks[:, ::-1]
        if py_rng.random() < vflip_prob:
            image = image[::-1]
            masks = masks[::-1]
        if py_rng.random() < rotate_prob:
            image, masks = _rotate(image, masks, py_rng.uniform(10, 270))
        if py_rng.random() < blur_prob:
            image = imgproc.gaussian_blur_u8(image, py_rng.choice([3, 5]))
        if py_rng.random() < noise_prob:  # multiplicative noise in [0.9, 1.1)
            mult = np_rng.uniform(0.9, 1.1, size=image.shape).astype(np.float32)
            image = np.clip(image.astype(np.float32) * mult, 0, 255).astype(image.dtype)
        if extended and py_rng.random() < channel_shuffle_prob:
            image = image[:, :, np_rng.permutation(3)]
        if weather and py_rng.random() < weather_prob:
            image = py_rng.choice(WEATHER)(np.ascontiguousarray(image), py_rng, np_rng)
        if extended and py_rng.random() < extended_prob:
            op = py_rng.choice(EXTENDED)
            image = np.ascontiguousarray(image)
            if op in GEOMETRIC:
                image, masks = op(image, np.ascontiguousarray(masks), py_rng, np_rng)
            else:
                image = op(image, py_rng, np_rng)
        return np.ascontiguousarray(image), np.ascontiguousarray(masks)

    return augment
