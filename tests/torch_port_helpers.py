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


def backward_case(name, seed=11):
    """``(dout [B, N, P, P, C] float32, boxes [B, N, 4], level_hw, image_shape,
    model options)`` for the ROIAlign backward. The options (``tile``, ``chunk``,
    ``round_rois``) size the CPU model of the kernel's algorithm; the kernel's
    own are 4x4 pixels, 256 boxes and 32 ROIs."""
    rs = np.random.RandomState(seed)

    def levels(size):
        return [(size // s, size // s) for s in (4, 8, 16, 32)]

    def case(boxes, p, c, level_hw, size, **options):
        boxes = np.ascontiguousarray(boxes, np.float32)
        dout = rs.normal(size=boxes.shape[:2] + (p, p, c)).astype(np.float32)
        return dout, boxes, level_hw, (size, size), options

    if name == "rois_7x7":
        return case(roi_boxes(rs, 2, 24), 7, 8, levels(128), 128)
    if name == "rois_14x14":
        return case(roi_boxes(rs, 2, 20), 14, 4, levels(128), 128)
    if name == "edge_boxes":
        # roi_boxes' first six (full image, zero height, padding, slivers, far
        # corner), boxes that reach out of the map, and a zero-width box
        boxes = roi_boxes(rs, 1, 10)
        boxes[0, 6] = [-0.2, -0.1, 0.3, 0.4]
        boxes[0, 7] = [0.8, 0.7, 1.3, 1.2]
        boxes[0, 8] = [-0.5, -0.5, 1.5, 1.5]
        boxes[0, 9] = [0.2, 0.4, 0.7, 0.4]
        return case(boxes, 7, 4, levels(128), 128)
    if name == "straddles_tiles":
        # pixels 2.5 .. 9.5 of the finest 64x64 map, both axes: tiles 0, 1 and 2
        lo, hi = 2.5 / 63, 9.5 / 63
        return case([[[lo, lo, hi, hi], [lo, 0.0, hi, 6.0 / 63]]], 14, 4, levels(256), 256)
    if name == "elongated":
        # 512x12 pixels: the finest level, 128 pixels one way and 3 the other
        return case([[[0.0, 0.5, 1.0, 0.5 + 12 / 512], [0.25, 0.0, 0.25 + 12 / 512, 1.0]]], 7, 2,
                    levels(512), 512)
    if name == "coarsest_2x2":
        return case(roi_boxes(rs, 2, 12), 7, 4, levels(64), 64)
    if name == "pool_1":
        return case(roi_boxes(rs, 2, 16), 1, 4, levels(128), 128)
    if name == "channels_36":
        return case(roi_boxes(rs, 1, 12), 7, 36, levels(128), 128)
    if name == "ragged_tiles":
        # 4x4 tiles over maps of 10, 5, 3 and 2 pixels a side
        return case(roi_boxes(rs, 2, 16), 7, 4, [(10, 10), (5, 5), (3, 3), (2, 2)], 40)
    if name == "odd_tile_shape":
        return case(roi_boxes(rs, 1, 16), 7, 4, levels(128), 128, tile=(3, 5))
    if name == "no_rois":
        return case(np.zeros((2, 0, 4)), 7, 4, levels(64), 64)
    if name == "chunks_and_rounds":
        # 40 overlapping ROIs through chunks of 16 boxes and rounds of 3 ROIs
        boxes = np.clip(random_boxes(rs, 40, lo=0.2, hi=0.5), 0.0, 1.0)[None]
        return case(boxes, 7, 4, levels(64), 64, chunk=16, round_rois=3)
    raise KeyError(name)


BACKWARD_CASES = ["rois_7x7", "rois_14x14", "edge_boxes", "straddles_tiles", "elongated", "coarsest_2x2",
                  "pool_1", "channels_36", "ragged_tiles", "odd_tile_shape", "no_rois", "chunks_and_rounds"]
