"""Image-pretraining augmentations, host-side numpy/cv2 (the port's own copy of
``gomatching_tpu/data/image_augment.py``: one seed gives the same record).

Parity: the adet image mapper's chain (third_party/adet/data/dataset_mapper.py:
84-110) — RandomRotation(+-45 with boundary head) and instance-aware random
crop (augmentation.py:14-111: the crop window must contain the center of a
randomly chosen instance; with crop_instance=False it grows until no instance
is cut) — applied before the resize. All point arrays ride along so
ctrl/boundary/bezier targets stay consistent.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def rotate_image_and_points(img: np.ndarray, pts_list: List[np.ndarray], angle_deg: float):
    """Rotate around the image center, expanding the canvas so nothing is cut
    (d2 RandomRotation expand=True semantics). pts are (N, 2) absolute xy."""
    import cv2

    h, w = img.shape[:2]
    c = (w / 2.0, h / 2.0)
    M = cv2.getRotationMatrix2D(c, angle_deg, 1.0)
    cos, sin = abs(M[0, 0]), abs(M[0, 1])
    new_w = int(h * sin + w * cos)
    new_h = int(h * cos + w * sin)
    M[0, 2] += new_w / 2.0 - c[0]
    M[1, 2] += new_h / 2.0 - c[1]
    out = cv2.warpAffine(img, M, (new_w, new_h))
    new_pts = []
    for p in pts_list:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        new_pts.append(p @ M[:, :2].T + M[:, 2])
    return out, new_pts


def crop_with_instance(
    img: np.ndarray,
    boxes: np.ndarray,  # (N, 4) xyxy of the instances
    crop_frac: Tuple[float, float],
    rng: np.random.RandomState,
    crop_box: bool = True,
):
    """Pick a crop window of relative size ``crop_frac`` containing the center
    of one random instance (augmentation.py:14-60). Returns (x0, y0, cw, ch).
    With crop_box=False the window is expanded until no instance is cut
    (:44-60, adjust_crop)."""
    h, w = img.shape[:2]
    ch = min(int(h * crop_frac[0] + 0.5), h)
    cw = min(int(w * crop_frac[1] + 0.5), w)
    if len(boxes) == 0:
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return x0, y0, cw, ch
    b = boxes[rng.randint(len(boxes))]
    cy, cx = (b[1] + b[3]) * 0.5, (b[0] + b[2]) * 0.5
    min_y = max(int(np.floor(cy)) - ch, 0)
    min_x = max(int(np.floor(cx)) - cw, 0)
    max_y = min(max(h - ch, 0), int(np.ceil(cy)))
    max_x = min(max(w - cw, 0), int(np.ceil(cx)))
    y0 = rng.randint(min_y, max_y + 1)
    x0 = rng.randint(min_x, max_x + 1)

    if not crop_box:
        # grow the window so no instance straddles its edges (<=25 passes)
        x1, y1 = x0 + cw, y0 + ch
        for _ in range(25):
            modified = False
            for bb in boxes:
                if bb[0] < x0 < bb[2]:
                    x0 = int(bb[0])
                    modified = True
                if bb[0] < x1 < bb[2]:
                    x1 = int(np.ceil(bb[2]))
                    modified = True
                if bb[1] < y0 < bb[3]:
                    y0 = int(bb[1])
                    modified = True
                if bb[1] < y1 < bb[3]:
                    y1 = int(np.ceil(bb[3]))
                    modified = True
            if not modified:
                break
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w), min(y1, h)
        cw, ch = x1 - x0, y1 - y0
    return x0, y0, cw, ch


def augment_pretrain_record(
    img: np.ndarray,
    record: Dict,
    rng: np.random.RandomState,
    rotate: bool = True,
    crop_enabled: bool = True,
    crop_frac: Tuple[float, float] = (0.5, 0.5),
    crop_instance: bool = False,
    angle: float = 45.0,
):
    """Rotate + instance-aware crop one record in place-copy style.

    Returns (image, annotations) where each annotation's polyline/boundary/
    beziers have been transformed; instances whose center leaves the crop are
    dropped (filter_empty_instances semantics, dataset_mapper.py:51-76).
    """
    annos = [dict(a) for a in record.get("annotations", []) if "beziers" in a]
    keys = ("polyline", "boundary", "beziers")

    if rotate:
        deg = rng.uniform(-angle, angle)
        flat_pts = []
        for a in annos:
            for k in keys:
                flat_pts.append(np.asarray(a[k], np.float64).reshape(-1, 2))
        img, new_pts = rotate_image_and_points(img, flat_pts, deg)
        i = 0
        for a in annos:
            for k in keys:
                a[k] = new_pts[i].astype(np.float32)
                i += 1

    if crop_enabled and annos:
        boxes = np.asarray(
            [
                [
                    a["polyline"].reshape(-1, 2)[:, 0].min(),
                    a["polyline"].reshape(-1, 2)[:, 1].min(),
                    a["polyline"].reshape(-1, 2)[:, 0].max(),
                    a["polyline"].reshape(-1, 2)[:, 1].max(),
                ]
                for a in annos
            ],
            np.float64,
        )
        x0, y0, cw, ch = crop_with_instance(img, boxes, crop_frac, rng, crop_instance)
        img = img[y0 : y0 + ch, x0 : x0 + cw]
        kept = []
        for a in annos:
            pl = a["polyline"].reshape(-1, 2)
            cx, cy = pl[:, 0].mean() - x0, pl[:, 1].mean() - y0
            if not (0 <= cx < cw and 0 <= cy < ch):
                continue
            for k in keys:
                p = np.asarray(a[k], np.float64).reshape(-1, 2)
                p -= (x0, y0)
                a[k] = p.astype(np.float32)
            kept.append(a)
        annos = kept
    return img, annos
