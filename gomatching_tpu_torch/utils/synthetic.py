"""Synthetic clip GT for smoke runs and tests (port of ``gomatching_tpu/utils/synthetic.py``).

Shapes mirror the reference's per-frame GT lists (gom_lstmatcher.py:213-266): per frame
``gt_ctrl`` (n_gt, npts, 2) normalized control points, ``gt_boxes`` (n_gt, 4) xyxy in
[0, 1], ``gt_ids`` dense instance ids from 1.
"""

from __future__ import annotations

import numpy as np


def make_targets(T: int, npts: int, n_gt: int = 2) -> dict:
    """Deterministic synthetic GT of a T-frame clip (the JAX package's bits)."""
    rng = np.random.RandomState(0)
    gt_ctrl, gt_boxes, gt_ids = [], [], []
    for _ in range(T):
        ctrl = rng.rand(n_gt, npts, 2).astype(np.float32)
        boxes = np.sort(
            rng.rand(n_gt, 4).astype(np.float32).reshape(n_gt, 2, 2), axis=1
        ).reshape(n_gt, 4)[:, [0, 2, 1, 3]]
        # boxes large enough to overlap proposals sometimes
        boxes = np.stack([boxes[:, 0] * 0.3, boxes[:, 1] * 0.3,
                          0.4 + boxes[:, 2] * 0.5, 0.4 + boxes[:, 3] * 0.5], -1)
        gt_ctrl.append(ctrl)
        gt_boxes.append(boxes)
        gt_ids.append(np.arange(1, n_gt + 1))
    return {"gt_ctrl": gt_ctrl, "gt_boxes": gt_boxes, "gt_ids": gt_ids}
