"""Inputs made from the seed repeat per seed, and every seed offers the same
work in another order."""

import numpy as np

from benchmark import images
from benchmark.loops import offline_stream
from benchmark.tests import tiny


def test_images_repeat_per_seed():
    a = images.image_pool(5, [(48, 64), (64, 48)], 2)
    b = images.image_pool(5, [(48, 64), (64, 48)], 2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (48, 64, 3) and a[2].shape == (64, 48, 3)
    assert not np.array_equal(a[0], images.image_pool(6, [(48, 64)], 1)[0])
    big = images.image_pool(2 ** 33 + 7, [(48, 64)], 1)
    assert np.array_equal(big[0], images.image_pool(2 ** 33 + 7, [(48, 64)], 1)[0])


def test_stream_order_repeats_and_keeps_its_work():
    """The stream cycles the same pool in an order drawn from the seed."""
    a = offline_stream.stream_order(2 ** 31 + 3, tiny.STREAM)
    b = offline_stream.stream_order(2 ** 31 + 3, tiny.STREAM)
    c = offline_stream.stream_order(17, tiny.STREAM)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(a[0].tolist()) == sorted(c[0].tolist()) == list(range(tiny.STREAM["pool"]))
    assert len(a[1]) == len(c[1]) == tiny.STREAM["sample_batches"]
    assert all(0 <= k < tiny.STREAM["sample_from"] for k in a[1])
