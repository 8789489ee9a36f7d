"""Serving images made from the seed.

``smooth_image`` is the port's ``profile_serving.py::_image`` (blocky colour
noise plus grain, so features are not flat).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def smooth_image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    x = rs.uniform(0, 255, (h // 16 + 1, w // 16 + 1, 3))
    x = np.repeat(np.repeat(x, 16, axis=0), 16, axis=1)[:h, :w]
    return np.clip(x + rs.normal(0, 10, x.shape), 0, 255).astype(np.uint8)


def image_pool(seed: int, sizes: List[Tuple[int, int]], per_size: int) -> List[np.ndarray]:
    """``per_size`` distinct images of each ``(h, w)``, in the order of ``sizes``."""
    rs = np.random.RandomState(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    return [smooth_image(rs, h, w) for h, w in sizes for _ in range(per_size)]

