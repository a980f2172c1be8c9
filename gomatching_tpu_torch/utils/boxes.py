"""Axis-aligned box math (port of gomatching_tpu/utils/boxes.py).

Replaces detectron2's ``pairwise_iou`` / ``nms`` calls of the reference tracker
(gomatching/modeling/meta_arch/gom_lstmatcher.py:321,:439-445): ``nms_mask`` runs on
the device over the fixed query-slot axis of a batch of frames, and
``pairwise_iou_np`` serves the host tracker.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes (..., A, 4) x (..., B, 4) -> (..., A, B); degenerate -> 0."""
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]).clamp(min=0) * (
        boxes_a[..., 3] - boxes_a[..., 1]).clamp(min=0)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]).clamp(min=0) * (
        boxes_b[..., 3] - boxes_b[..., 1]).clamp(min=0)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def pairwise_iou_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Numpy IoU for the host-side tracker loop."""
    area_a = np.clip(boxes_a[:, 2] - boxes_a[:, 0], 0, None) * np.clip(boxes_a[:, 3] - boxes_a[:, 1], 0, None)
    area_b = np.clip(boxes_b[:, 2] - boxes_b[:, 0], 0, None) * np.clip(boxes_b[:, 3] - boxes_b[:, 1], 0, None)
    lt = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    rb = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    return iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Class-agnostic greedy NMS as a keep mask over the slot axis, batched.

    boxes (B, N, 4), scores (B, N), valid (B, N) -> keep (B, N). torchvision
    semantics: visit boxes in descending score order (ties in slot order); a box is
    suppressed if it overlaps an already kept box with IoU > threshold. The greedy
    recurrence runs as N steps of batched tensor ops, all on the device.
    """
    B, N = scores.shape
    order = torch.sort(scores.masked_fill(~valid, float("-inf")), dim=1, descending=True,
                       stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    over = pairwise_iou(boxes_s, boxes_s) > iou_threshold  # (B, N, N)
    keep_s = torch.zeros_like(valid_s)
    for i in range(N):
        suppressed = (over[:, i, :i] & keep_s[:, :i]).any(dim=1)
        keep_s[:, i] = valid_s[:, i] & ~suppressed
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)
