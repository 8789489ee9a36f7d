"""The port's tensor box helpers (``ops/boxes.py``: ``norm_boxes``,
``denorm_boxes``, ``extract_bboxes_from_masks``) against the JAX package's
``ops/boxes.py``, on the CPU, in float32 on seeded inputs.

Tolerances: boxes from masks exact (integers); ``norm_boxes`` and
``denorm_boxes`` within one float32 ulp of JAX's (both divide and multiply
tensor by tensor, one rounding an op, so they are expected bit-equal; the
ulp allows for another library's division).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.ops import boxes as jax_boxes

from maskrcnn_tf2_tpu_torch.data import transforms
from maskrcnn_tf2_tpu_torch.ops import anchors, boxes

SHAPES = [(37, 53), (512, 512), (1024, 768)]


def _pixel_boxes(rs, shape, lead=(2, 50)):
    h, w = shape
    y = np.sort(rs.uniform(0, h, size=lead + (2,)), axis=-1)
    x = np.sort(rs.uniform(0, w, size=lead + (2,)), axis=-1)
    out = np.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], axis=-1)
    out[0, :3] = [[0, 0, h, w], [0, 0, 1, 1], [h - 1, w - 1, h, w]]  # whole image, corners
    return out.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_norm_boxes_matches_jax(shape):
    pix = _pixel_boxes(np.random.RandomState(shape[0]), shape).astype(np.float32)
    got = boxes.norm_boxes(torch.from_numpy(pix), shape)
    assert got.dtype == torch.float32 and got.shape == pix.shape
    want = np.asarray(jax_boxes.norm_boxes(jnp.asarray(pix), shape))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    np.testing.assert_array_max_ulp(got.numpy(), anchors.norm_boxes_np(pix, shape), maxulp=1)
    np.testing.assert_array_equal(got[0, 0].numpy(), [0, 0, 1, 1])


@pytest.mark.parametrize("shape", SHAPES)
def test_denorm_boxes_matches_jax(shape):
    rs = np.random.RandomState(shape[1])
    normed = np.sort(rs.uniform(-0.1, 1.1, size=(3, 40, 4)), axis=-1).astype(np.float32)
    got = boxes.denorm_boxes(torch.from_numpy(normed), shape)
    want = np.asarray(jax_boxes.denorm_boxes(jnp.asarray(normed), shape))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    pix = _pixel_boxes(rs, shape).astype(np.float32)
    back = boxes.denorm_boxes(boxes.norm_boxes(torch.from_numpy(pix), shape), shape)
    want_back = np.asarray(jax_boxes.denorm_boxes(jax_boxes.norm_boxes(jnp.asarray(pix), shape), shape))
    np.testing.assert_array_max_ulp(back.numpy(), want_back, maxulp=1)


@pytest.mark.parametrize("n,h,w,dtype", [(6, 37, 53, np.bool_), (4, 64, 64, np.uint8), (3, 1, 9, np.float32)])
def test_extract_bboxes_from_masks_matches_jax(n, h, w, dtype):
    rs = np.random.RandomState(n)
    masks = np.zeros((n, h, w), dtype)
    for i in range(1, n):  # mask 0 stays empty
        y1, y2 = np.sort(rs.randint(0, h + 1, size=2))
        x1, x2 = np.sort(rs.randint(0, w + 1, size=2))
        masks[i, y1:y2 + 1, x1:x2 + 1] = rs.rand(min(y2 + 1, h) - y1, min(x2 + 1, w) - x1) < 0.6
    got = boxes.extract_bboxes_from_masks(torch.from_numpy(masks))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_boxes.extract_bboxes_from_masks(jnp.asarray(masks))))
    np.testing.assert_array_equal(got.numpy(), transforms.extract_bboxes(np.moveaxis(masks, 0, -1) > 0))
    np.testing.assert_array_equal(got[0].numpy(), [0, 0, 0, 0])
