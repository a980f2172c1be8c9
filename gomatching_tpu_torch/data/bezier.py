"""Bezier ground-truth derivation (the port's own copy of
``gomatching_tpu/data/bezier.py``).

Parity: gomatching/data/datasets/bezier_tools.py (quadrilateral -> rotated rect ->
linear "bezier" control points; 14-point polygon -> per-side cubic least-squares
fit) and the boundary/polyline sampling in vts.py:168-179.
"""

from __future__ import annotations

import cv2
import numpy as np


def bernstein_coeff(ts: np.ndarray) -> np.ndarray:
    """(len(ts), 4) cubic Bernstein basis."""
    t = np.asarray(ts, dtype=np.float64)[:, None]
    k = np.arange(4)[None, :]
    binom = np.array([1.0, 3.0, 3.0, 1.0])[None, :]
    return binom * t**k * (1 - t) ** (3 - k)


def order_quad(points: np.ndarray, image_h: int, image_w: int) -> list:
    """Sort a quad into [top-left, top-right, bottom-right, bottom-left] and clip
    into the image with a 1px margin (bezier_tools.get_tight_rect)."""
    ps = sorted(list(points), key=lambda p: p[0])
    left = sorted(ps[:2], key=lambda p: p[1])
    right = sorted(ps[2:], key=lambda p: p[1])
    p1, p4 = left[0], left[1]
    p2, p3 = right[0], right[1]
    out = []
    for px, py in (p1, p2, p3, p4):
        out.append(
            [min(max(px, 1), image_w - 1), min(max(py, 1), image_h - 1)]
        )
    return out


def quad_to_bezier(poly: np.ndarray, image_h: int, image_w: int) -> np.ndarray:
    """4-point polygon -> 8 control points (two linearly-subdivided long edges).

    Mirrors polygon2rbox + cpt_bezier_pts (+ the ccw flip in vts.py:159-161).
    """
    rect = cv2.minAreaRect(poly.astype(np.float32))
    corners = np.array(cv2.boxPoints(rect), dtype=int)
    quad = order_quad(corners, image_h, image_w)
    # ensure counter-clockwise orientation (shoelace)
    pts = np.array(quad, dtype=np.float64)
    area2 = np.sum(
        (pts[np.arange(4)][:, 0]) * (pts[(np.arange(4) + 1) % 4][:, 1])
        - (pts[(np.arange(4) + 1) % 4][:, 0]) * (pts[np.arange(4)][:, 1])
    )
    if area2 < 0:  # clockwise -> reverse
        quad = quad[::-1]
    pts = np.array(quad, dtype=np.float64)
    # two longest edges, each linearly subdivided into 4 points
    edges = [(pts[i], pts[(i + 1) % 4]) for i in range(4)]
    edges = sorted(edges, key=lambda e: -np.linalg.norm(e[1] - e[0]))[:2]
    ctrl = []
    for p1, p2 in edges:
        ctrl.append(p1)
        for i in range(1, 3):
            t = i / 3.0
            ctrl.append(np.floor((1 - t) * p1 + t * p2))
        ctrl.append(p2)
    return np.asarray(ctrl, dtype=np.float64)  # (8, 2)


def bezier_fit(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least-squares cubic bezier through ordered points with chord-length
    parameterization (bezier_tools.bezier_fit + endpoint pinning in train())."""
    dt = np.hypot(np.diff(x), np.diff(y))
    t = np.concatenate([[0], dt / dt.sum()]).cumsum()
    coeff = bernstein_coeff(t)
    ctrl = np.linalg.pinv(coeff) @ np.column_stack((x, y))
    # endpoints pinned to the data (reference Bezier.__init__/train)
    ctrl[0] = [x[0], y[0]]
    ctrl[3] = [x[-1], y[-1]]
    return ctrl


def poly14_to_bezier(poly: np.ndarray) -> np.ndarray:
    """14-point polygon (7 top + 7 bottom) -> 8 bezier control points."""
    mid = len(poly) // 2
    top, bottom = poly[:mid], poly[mid:]
    ct = bezier_fit(top[:, 0], top[:, 1])
    cb = bezier_fit(bottom[:, 0], bottom[:, 1])
    return np.vstack([ct, cb])


def bezier_to_gt(bezier8: np.ndarray, num_points: int = 25):
    """8 control points -> (beziers (4,2) centerline ctrl, boundary (2*npts, 2),
    polyline (npts, 2)). Parity: vts.py:168-179."""
    b = np.asarray(bezier8, np.float64).reshape(-1, 2)
    center = (b[:4] + b[4:][::-1]) / 2
    xy = b.reshape(2, 4, 2).transpose(0, 2, 1).reshape(4, 4)  # rows: top-x/y, bot-x/y
    u = np.linspace(0, 1, num_points)
    coeff = bernstein_coeff(u)  # (npts, 4)
    boundary4 = coeff @ xy.T  # (npts, 4): [top_x, top_y, bot_x, bot_y]
    boundary = np.hstack([boundary4[:, :2], boundary4[:, 2:][::-1]]).reshape(-1, 2)
    polyline = (boundary4[:, :2] + boundary4[:, 2:][::-1]) / 2
    return center, boundary, polyline
