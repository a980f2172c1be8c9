"""Training losses of the GoMatching tracker head (port of
``gomatching_tpu/engine/losses.py``).

Parity targets:
  - the rescore focal loss ``loss_res`` (lstmatcher.py:237-268) with the 4GM Hungarian
    matcher cost (matcher.py:158-198): focal class cost from re_pred_logits + L1
    control-point cost;
  - the association CE ``detr_asso_loss`` (lstmatcher.py:431-460) with NEG_UNMATCHED
    semantics, and the IoU-based GT construction ``_get_asso_gt``
    (lstmatcher.py:384-428).

Hungarian matching and the association targets are no-grad and tiny, so they run on
host numpy (``match_rescore``, ``build_asso_targets``); the differentiable losses are
torch functions of fixed-shape tensors that take the matches and targets as dense
arrays with masks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.hungarian import solve
from ..utils.boxes import pairwise_iou_np


# ---------------------------------------------------------------------------
# host-side matching (no-grad)
# ---------------------------------------------------------------------------


def match_rescore(
    re_logits: np.ndarray,  # (T, nq, npts, 1)
    pred_ctrl: np.ndarray,  # (T, nq, npts, 2) normalized
    gt_ctrl: list,  # per frame: (g_t, npts, 2) normalized
    class_weight: float = 1.0,
    coord_weight: float = 1.0,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """4GM Hungarian per frame -> list of (query_idx, gt_idx)."""
    T, nq = re_logits.shape[:2]
    out = []
    for t in range(T):
        g = len(gt_ctrl[t])
        if g == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
            continue
        prob = 1.0 / (1.0 + np.exp(-re_logits[t].reshape(nq, -1)))  # (nq, npts)
        neg = (1 - focal_alpha) * prob**focal_gamma * (-np.log(1 - prob + 1e-8))
        pos = focal_alpha * (1 - prob) ** focal_gamma * (-np.log(prob + 1e-8))
        cost_class = (pos - neg).mean(-1, keepdims=True)  # (nq, 1)
        a = pred_ctrl[t].reshape(nq, -1)
        b = np.asarray(gt_ctrl[t]).reshape(g, -1)
        cost_kpts = np.abs(a[:, None] - b[None, :]).sum(-1)  # (nq, g)
        C = class_weight * cost_class + coord_weight * cost_kpts
        out.append(solve(C))
    return out


def build_asso_targets(
    boxes: np.ndarray,  # (T, nq, 4) proposal boxes, normalized xyxy
    prop_valid: np.ndarray,  # (T, nq) bool
    gt_boxes: list,  # per frame (g_t, 4) normalized
    gt_ids: list,  # per frame (g_t,) instance ids (>0 tracked)
    max_tracks: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Association GT (lstmatcher.py:384-428) on the padded (T, nq) grid.

    Returns:
      asso_gt (K, T) int: per track the proposal slot in frame t (nq == background)
      match_cues (T, nq) int: track index k for matched proposal slots else -1
      track_valid (K,) bool
    """
    T, nq = prop_valid.shape
    inst_ids = (np.unique(np.concatenate([np.asarray(g) for g in gt_ids])) if gt_ids
                else np.zeros(0))
    inst_ids = inst_ids[inst_ids > 0][:max_tracks]
    K = len(inst_ids)
    asso_gt = np.full((max_tracks, T), nq, np.int64)
    match_cues = np.full((T, nq), -1, np.int64)
    track_valid = np.zeros(max_tracks, bool)
    track_valid[:K] = True
    for k, iid in enumerate(inst_ids):
        for t in range(T):
            sel = np.asarray(gt_ids[t]) == iid
            if not sel.any():
                continue
            gb = np.asarray(gt_boxes[t])[sel]  # (1, 4)
            pv = prop_valid[t]
            if not pv.any():
                continue
            ious = pairwise_iou_np(boxes[t][pv], gb)[:, 0]
            j = int(np.argmax(ious))
            if ious[j] > 0.0:
                slot = np.where(pv)[0][j]
                asso_gt[k, t] = slot
                match_cues[t, slot] = k
    return asso_gt, match_cues, track_valid


# ---------------------------------------------------------------------------
# differentiable losses
# ---------------------------------------------------------------------------


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits, elementwise (``optax.sigmoid_binary_cross_entropy``
    as the JAX package writes it)."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss (lstmatcher.py:26-57 numerics, no reduction)."""
    p = logits.sigmoid()
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def rescore_loss(re_logits: torch.Tensor, match_mask: torch.Tensor, num_inst: torch.Tensor,
                 alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """loss_res: focal on the rescoring logits (T, nq, npts, 1), the slots of
    ``match_mask`` (T, nq) positive (lstmatcher.py:248-268); divided by ``num_inst`` and
    scaled by nq like the reference."""
    nq = re_logits.shape[1]
    tgt = match_mask[:, :, None, None].expand(re_logits.shape).to(re_logits.dtype)
    loss = sigmoid_focal_loss(re_logits, tgt, alpha, gamma)
    return loss.mean(dim=(1, 2)).sum() / num_inst * nq


def asso_ce_loss(
    asso_logits: torch.Tensor,  # (M, T, nq) query rows vs per-frame slots
    row_valid: torch.Tensor,  # (M,) bool: real query rows
    col_valid: torch.Tensor,  # (T, nq) bool: real key slots
    asso_gt: torch.Tensor,  # (K, T) slot index per track (nq = background)
    match_cues: torch.Tensor,  # (M,) track index per row or -1
    track_valid: torch.Tensor,  # (K,) bool (not read, as in JAX: asso_gt is nq past K)
    neg_unmatched: bool = True,
) -> torch.Tensor:
    """detr_asso_loss (lstmatcher.py:431-460) on the padded grid.

    For each frame t: a softmax over that frame's slots and a zero background column;
    rows matched to track k target asso_gt[k, t]. With ``neg_unmatched`` (the shipped
    configs) unmatched rows target the background, otherwise only matched rows count.
    """
    M, T, nq = asso_logits.shape
    logits = asso_logits.masked_fill(~col_valid[None], -1e9)
    bg = asso_logits.new_zeros((M, T, 1))
    logp = F.log_softmax(torch.cat([logits, bg], -1), dim=-1)  # (M, T, nq + 1)
    matched = match_cues >= 0
    tgt = torch.where(matched[:, None], asso_gt[match_cues.clamp(min=0)],
                      torch.full((M, T), nq, dtype=asso_gt.dtype, device=asso_gt.device))
    row_mask = (matched & row_valid) if not neg_unmatched else row_valid
    nll = -logp.gather(-1, tgt[..., None])[..., 0]  # (M, T)
    nll = torch.where(row_mask[:, None], nll, torch.zeros_like(nll))
    num_objs = torch.where(row_mask[:, None], (tgt != nq).float(),
                           torch.zeros_like(nll)).sum()
    return nll.sum() / (num_objs + 1e-4)
