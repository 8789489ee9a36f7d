"""Helpers shared by the PyTorch port's parity tests."""

from collections.abc import Mapping

import numpy as np


def randomize(tree, rs):
    """Flax init leaves biases 0 and batch norm at the identity; give every
    such leaf random values so the bridge's mapping of each is tested."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = randomize(v, rs)
            continue
        v = np.asarray(v, np.float32)
        if k in ("scale", "var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = rs.normal(0, 0.1, v.shape).astype(np.float32)
        out[k] = v
    return out


def random_boxes(rs, n, lo=0.02, hi=0.35):
    y1, x1 = rs.uniform(0, 0.7, (2, n))
    h, w = rs.uniform(lo, hi, (2, n))
    return np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)


def nms_case(name, rs):
    """(boxes [B, N, 4], scores [B, N], valid [B, N] | None, limit, thr, presorted)."""
    if name == "presorted_6000":
        boxes = np.stack([random_boxes(rs, 6000) for _ in range(2)])
        scores = -np.sort(-rs.uniform(size=(2, 6000)), axis=1).astype(np.float32)
        return boxes, scores, None, 1000, 0.7, True
    if name == "unsorted_class_offsets":
        boxes = np.stack([random_boxes(rs, 1000) for _ in range(2)])
        cls = rs.randint(0, 5, (2, 1000))
        boxes = boxes + 2.0 * cls[..., None].astype(np.float32)
        scores = rs.uniform(size=(2, 1000)).astype(np.float32)
        scores[:, ::7] = scores[:, 3:4]  # exact ties resolve by lowest index
        valid = (cls > 0) & (scores > 0.2)
        return boxes, scores, valid, 100, 0.3, False
    if name == "duplicate_chains":
        # staircases of 0.3-wide boxes stepping 0.07: each step overlaps the
        # next above 0.5 but not the one after, so the greedy order alternates
        # kept/suppressed along a chain; plus exact duplicates of each base
        base = rs.uniform(0, 0.6, (60, 2)).astype(np.float32)
        stairs = [[b[0] + 0.07 * k, b[1], b[0] + 0.07 * k + 0.3, b[1] + 0.3] for b in base for k in range(20)]
        dups = [[b[0], b[1], b[0] + 0.3, b[1] + 0.3] for b in base for _ in range(5)]
        boxes = np.asarray(stairs + dups, np.float32)[None]
        scores = rs.uniform(size=(1, boxes.shape[1])).astype(np.float32)
        valid = rs.uniform(size=scores.shape) > 0.1
        return boxes, scores, valid, 1000, 0.5, False
    if name == "all_invalid_row":
        boxes = np.stack([random_boxes(rs, 700) for _ in range(2)])
        scores = rs.uniform(size=(2, 700)).astype(np.float32)
        valid = np.ones((2, 700), bool)
        valid[1] = False
        return boxes, scores, valid, 100, 0.5, False
    if name == "fewer_than_limit":
        boxes = random_boxes(rs, 50)[None]
        scores = rs.uniform(size=(1, 50)).astype(np.float32)
        return boxes, scores, None, 100, 0.3, False
    if name == "chunk_chains":
        # three staircases of 200 steps interleaved row by row (presorted), so
        # each chain alternates kept/suppressed across many 64-row chunks
        base = rs.uniform(0, 0.6, (3, 2)).astype(np.float32)
        steps = np.arange(200, dtype=np.float32)
        y1 = (base[None, :, 0] + 0.07 * steps[:, None]).reshape(-1)
        x1 = np.tile(base[:, 1], 200)
        boxes = np.stack([y1, x1, y1 + 0.3, x1 + 0.3], -1).astype(np.float32)[None]
        scores = np.linspace(1, 0, boxes.shape[1], dtype=np.float32)[None]
        valid = rs.uniform(size=scores.shape) > 0.05
        return boxes, scores, valid, 1000, 0.5, True
    if name == "limit_mid_chunk":
        # N = 1000 (not a multiple of 64), the limit filled well inside the run
        boxes = np.stack([random_boxes(rs, 1000) for _ in range(2)])
        scores = -np.sort(-rs.uniform(size=(2, 1000)), axis=1).astype(np.float32)
        return boxes, scores, None, 77, 0.5, True
    if name == "single_box":
        boxes = random_boxes(rs, 1)[None]
        return boxes, np.ones((1, 1), np.float32), None, 5, 0.5, True
    raise KeyError(name)


def pyramid(rs, b, size, c):
    return [rs.normal(size=(b, size // s, size // s, c)).astype(np.float32) for s in (4, 8, 16, 32)]


def roi_boxes(rs, b, n):
    boxes = np.stack([random_boxes(rs, n, lo=0.005, hi=0.9) for _ in range(b)])
    boxes = np.clip(boxes, 0.0, 1.0)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]  # full image
    boxes[:, 1] = [0.3, 0.3, 0.3, 0.6]  # zero height
    boxes[:, 2] = 0.0  # padding row
    boxes[:, 3] = [0.0, 0.1, 1.0, 0.102]  # extreme aspect: tall and thin
    boxes[:, 4] = [0.5, 0.0, 0.5005, 1.0]  # extreme aspect: wide and flat
    boxes[:, 5] = [0.999, 0.999, 1.0, 1.0]  # tiny, at the far corner
    return boxes
