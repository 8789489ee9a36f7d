"""Filled shapes drawn into a numpy canvas, without cv2.

The JAX package draws masks and synthetic images with ``cv2.fillPoly``,
``cv2.circle(thickness=-1)`` and ``cv2.rectangle(thickness=-1)``; the card's
machine has no cv2. These functions follow OpenCV's own integer algorithms
(``imgproc/src/drawing.cpp``) so that they select the same pixels:

* ``fill_polygon``: the outline as 8-connected Bresenham lines from each
  vertex to the next, then even-odd scanlines between the edges' crossings,
  the edges kept in 16.16 fixed point and stepped by a truncated slope per
  row, each span from the ceiling of its left crossing to the floor of its
  right one (``CollectPolyEdges`` + ``FillEdgeCollection``). Inside the image
  this gives cv2's pixels; an edge with an end outside runs on its clipped
  line, which agrees with cv2 but for a few pixels along the border;
* ``fill_circle``: the midpoint circle's horizontal spans (``Circle``);
* ``fill_rectangle``: the closed box between two corners;
* ``outline_rectangle``: ``cv2.rectangle`` with a thickness, a band along
  each side and a filled disk on each corner (``PolyLine`` + ``ThickLine``).

Points are ``(x, y)`` integer pixel centres, as cv2 takes them; the canvas is
``[H, W]`` or ``[H, W, C]`` and is filled in place and returned.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

Color = Union[int, float, Sequence[float]]
_SHIFT = 16  # OpenCV's XY_SHIFT
_ONE = 1 << _SHIFT


def _hline(canvas: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    h, w = canvas.shape[:2]
    if 0 <= y < h and x1 < w and x2 >= 0 and x1 <= x2:
        canvas[y, max(x1, 0) : min(x2, w - 1) + 1] = color


def _clip_line(w: int, h: int, p0, p1):
    """OpenCV's ``clipLine`` of an integer segment to the ``w`` x ``h`` image:
    ``(inside, p0, p1)``, the ends moved onto the border along the segment
    (truncated as it truncates)."""
    (x1, y1), (x2, y2) = p0, p1
    right, bottom = w - 1, h - 1

    def code(x, y, with_y=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _inside(w: int, h: int, p) -> bool:
    return 0 <= p[0] < w and 0 <= p[1] < h


def _line(canvas: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color) -> None:
    """8-connected Bresenham between ``p0`` and ``p1``, both ends included, as
    OpenCV's ``LineIterator`` walks it: clipped to the image first, then left
    to right, with its error term (the walk's direction and tie rule decide
    which pixel a half step lands on)."""
    h, w = canvas.shape[:2]
    if not (_inside(w, h, p0) and _inside(w, h, p1)):
        inside, p0, p1 = _clip_line(w, h, p0, p1)
        if not inside:
            return
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        (x0, y0), (x1, y1) = (x1, y1), (x0, y0)
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x0, y0
    for _ in range(major + 1):
        canvas[y, x] = color
        if err < 0:  # step along both axes
            err += 2 * major - 2 * minor
            x, y = x + 1, y + sy
        else:
            err -= 2 * minor
            if steep:
                y += sy
            else:
                x += 1


def fill_polygon(canvas: np.ndarray, points, color: Color) -> np.ndarray:
    """``cv2.fillPoly(canvas, [points], color)`` for one ``[N, 2]`` integer
    ``(x, y)`` polygon."""
    pts = [tuple(p) for p in np.asarray(points, np.int64).reshape(-1, 2).tolist()]
    h, w = canvas.shape[:2]
    edges = []  # (y0, y1, x at y0 in 16.16 fixed point, slope per row)
    for p0, p1 in zip(pts[-1:] + pts[:-1], pts):  # edge i runs from vertex i-1 to vertex i
        _line(canvas, p0, p1, color)
        if p0[1] == p1[1]:
            continue
        # an edge with an end outside the image runs on the line through its
        # ends clipped to the image (where that leaves it a rise)
        c0, c1 = (p0[0] << _SHIFT, p0[1]), (p1[0] << _SHIFT, p1[1])
        if not (_inside(w, h, p0) and _inside(w, h, p1)):
            _, t0, t1 = _clip_line(w, h, p0, p1)
            if t0[1] != t1[1]:
                c0, c1 = (t0[0] << _SHIFT, t0[1]), (t1[0] << _SHIFT, t1[1])
        run, rise = c1[0] - c0[0], c1[1] - c0[1]
        slope = (abs(run) // abs(rise)) * (1 if (run >= 0) == (rise > 0) else -1)  # C truncation
        top, start = (p0, c0) if p0[1] < p1[1] else (p1, c1)
        edges.append((top[1], max(p0[1], p1[1]), start[0] + (top[1] - start[1]) * slope, slope))
    if len(edges) < 2:
        return canvas
    y0, y1, x0, slope = (np.asarray(v, np.int64) for v in zip(*edges))
    for y in range(max(int(y0.min()), 0), min(int(y1.max()), h)):
        active = (y0 <= y) & (y < y1)
        xs = np.sort(x0[active] + (y - y0[active]) * slope[active])
        for left, right in zip(xs[0::2].tolist(), xs[1::2].tolist()):
            _hline(canvas, y, (left + _ONE - 1) >> _SHIFT, right >> _SHIFT, color)
    return canvas


def fill_circle(canvas: np.ndarray, center, radius: int, color: Color) -> np.ndarray:
    """``cv2.circle(canvas, center, radius, color, -1)``: the midpoint circle's
    spans, rows ``cy ± dy`` over ``cx ± dx`` and rows ``cy ± dx`` over
    ``cx ± dy``."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            _hline(canvas, y, cx - half, cx + half, color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return canvas


def fill_rectangle(canvas: np.ndarray, pt1, pt2, color: Color) -> np.ndarray:
    """``cv2.rectangle(canvas, pt1, pt2, color, -1)``: every pixel between the
    two corners, both included."""
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    canvas[max(y1, 0) : max(y2 + 1, 0), max(x1, 0) : max(x2 + 1, 0)] = color
    return canvas


def outline_rectangle(canvas: np.ndarray, pt1, pt2, color: Color, thickness: int = 2) -> np.ndarray:
    """``cv2.rectangle(canvas, pt1, pt2, color, thickness)`` with 8-connected
    lines. OpenCV draws the closed polyline of the four corners: at a
    thickness of 1 as Bresenham lines; above it each side as a convex quad
    reaching ``(thickness + 1) // 2`` pixels to either side of the side
    (``ThickLine``), a box here since the sides are axis-aligned, and a
    filled circle of that radius on the side's end."""
    x1, y1, x2, y2 = int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness <= 1:
        for p0, p1 in zip(corners[-1:] + corners[:-1], corners):
            _line(canvas, p0, p1, color)
        return canvas
    half = (thickness + 1) // 2
    for (xa, ya), (xb, yb) in zip(corners[-1:] + corners[:-1], corners):
        if (xa, ya) != (xb, yb):  # a side of no length has no quad
            dy, dx = (half, 0) if ya == yb else (0, half)
            fill_rectangle(canvas, (min(xa, xb) - dx, min(ya, yb) - dy), (max(xa, xb) + dx, max(ya, yb) + dy), color)
        fill_circle(canvas, (xb, yb), half, color)
    return canvas
