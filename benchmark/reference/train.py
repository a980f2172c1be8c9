"""Plain reference of one GoMatching tracker training step, float32.

The step as the reference trains the tracker head: the frozen spot (``ReferenceModel``)
on a uint8 RGB clip, normalized per frame; the host phase (score fusion, the two
proposal thresholds, boxes from the boundary points, the 4GM Hungarian for the
rescoring targets, the IoU association targets); the losses (the rescoring focal loss,
the long-term pass over every proposal of the clip and the short-term passes over each
adjacent pair, with ASSO_HEAD.DROPOUT); the backward into ``roi_heads``, the
full-model clip by the global norm, AdamW with decoupled decay and the warm-up cosine
schedule. Written out with numpy, scipy's assignment and plain torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from .model import ReferenceModel

BETAS = (0.9, 0.999)
EPS = 1e-8


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    x = images_u8.float()
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


@torch.no_grad()
def spot(model: ReferenceModel, images: torch.Tensor, ref_points=None, top: int = 0) -> Dict:
    """Normalized NHWC frames -> the spotter's raw outputs, a frame at a time; the
    decoder from ``ref_points`` (T, nq, npts, 2) when given, else from the model's own
    top-k. ``top``: also the reference points of the model's ``top`` best proposals."""
    outs = []
    for t in range(images.shape[0]):
        enc = model.encode(images[t:t + 1])
        pts = model.select(enc) if ref_points is None else ref_points[t:t + 1].float()
        out = model.decode_raw(enc, pts)
        out["ref_points"] = pts
        if top:
            out["top"] = model.select(enc, top)
        outs.append(out)
        del enc
    return {k: (None if outs[0][k] is None else torch.cat([o[k] for o in outs]))
            for k in outs[0]}


HOST_FIELDS = ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points")


def host_fields(out: Dict) -> Dict:
    """The spot fields the host phase reads, as f32 numpy."""
    return {k: (None if out[k] is None else out[k].float().cpu().numpy()) for k in HOST_FIELDS}


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def rescore_matches(re_logits, ctrl, gt_ctrl, alpha, gamma):
    """Per frame: the focal class cost of the rescoring logits plus the L1 cost of the
    control points, minimized by the Hungarian assignment -> matched query slots."""
    T, nq = re_logits.shape[:2]
    out = []
    for t in range(T):
        g = len(gt_ctrl[t])
        if g == 0:
            out.append(np.zeros(0, np.int64))
            continue
        prob = 1.0 / (1.0 + np.exp(-re_logits[t].reshape(nq, -1)))
        neg = (1 - alpha) * prob**gamma * (-np.log(1 - prob + 1e-8))
        pos = alpha * (1 - prob) ** gamma * (-np.log(prob + 1e-8))
        cost = (pos - neg).mean(-1, keepdims=True) + np.abs(
            ctrl[t].reshape(nq, 1, -1) - np.asarray(gt_ctrl[t]).reshape(1, g, -1)).sum(-1)
        out.append(linear_sum_assignment(cost)[0])
    return out


def asso_targets(boxes, prop_valid, gt_boxes, gt_ids, max_tracks):
    """Per GT track and frame the valid proposal of highest IoU with its box (nq: none),
    and per slot the track it is matched to (-1: none)."""
    T, nq = prop_valid.shape
    ids = np.unique(np.concatenate([np.asarray(g) for g in gt_ids]))
    ids = ids[ids > 0][:max_tracks]
    asso_gt = np.full((max_tracks, T), nq, np.int64)
    cues = np.full((T, nq), -1, np.int64)
    for k, iid in enumerate(ids):
        for t in range(T):
            sel = np.asarray(gt_ids[t]) == iid
            if not sel.any() or not prop_valid[t].any():
                continue
            ious = iou_np(boxes[t][prop_valid[t]], np.asarray(gt_boxes[t])[sel])[:, 0]
            j = int(np.argmax(ious))
            if ious[j] > 0.0:
                slot = np.where(prop_valid[t])[0][j]
                asso_gt[k, t] = slot
                cues[t, slot] = k
    return asso_gt, cues


def host_phase(host: Dict, targets: Dict, thresh: float, loss_cfg: Dict) -> Dict:
    """Score fusion, the two proposal thresholds, boxes from the boundary points, the
    rescoring Hungarian and the association targets of the clip and of each adjacent
    pair, from the spot's host fields (numpy)."""
    logits = np.asarray(host["pred_logits"], np.float32)
    T, nq = logits.shape[:2]
    fused = 1 / (1 + np.exp(-logits.mean(2)[..., 0]))
    re = None
    if host["re_pred_logits"] is not None:
        re = np.asarray(host["re_pred_logits"], np.float32)
        fused = np.maximum(fused, 1 / (1 + np.exp(-re.mean(2)[..., 0])))
    prop_valid = fused > thresh  # the detection and association thresholds, both at thresh
    pts = np.asarray(host["pred_bd_points"], np.float32).reshape(T, nq, -1, 2)
    boxes = np.stack([pts[..., 0].min(-1), pts[..., 1].min(-1), pts[..., 0].max(-1),
                      pts[..., 1].max(-1)], -1)
    res_mask = np.zeros((T, nq), np.float32)
    if re is not None:
        for t, qi in enumerate(rescore_matches(re, np.asarray(host["pred_ctrl_points"]),
                                               targets["gt_ctrl"], loss_cfg["focal_alpha"],
                                               loss_cfg["focal_gamma"])):
            res_mask[t, qi] = 1.0
    asso_gt, cues = asso_targets(boxes, prop_valid, targets["gt_boxes"], targets["gt_ids"], nq)
    pairs = np.zeros((max(T - 1, 1), nq, 2), np.int64)
    for t in range(T - 1):
        pairs[t] = asso_targets(boxes[t:t + 2], prop_valid[t:t + 2], targets["gt_boxes"][t:t + 2],
                                targets["gt_ids"][t:t + 2], nq)[0]
    return {"prop_valid": prop_valid, "res_match_mask": res_mask,
            "num_inst": np.float32(max(sum(len(g) for g in targets["gt_ctrl"]), 1)),
            "asso_gt": asso_gt, "match_cues": cues, "asso_gt_pairs": pairs}


def sigmoid_ce(x, y):
    return x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))


def focal(x, y, alpha, gamma):
    p = x.sigmoid()
    p_t = p * y + (1 - p) * (1 - y)
    return (alpha * y + (1 - alpha) * (1 - y)) * sigmoid_ce(x, y) * (1 - p_t) ** gamma


def asso_ce(logits, row_valid, col_valid, asso_gt, cues):
    """Per row and frame a softmax over the frame's valid slots and a zero background
    column; matched rows target their track's slot, the others the background
    (NEG_UNMATCHED)."""
    M, T, nq = logits.shape
    lg = logits.masked_fill(~col_valid[None], -1e9)
    logp = F.log_softmax(torch.cat([lg, lg.new_zeros(M, T, 1)], -1), -1)
    matched = cues >= 0
    tgt = torch.where(matched[:, None], asso_gt[cues.clamp(min=0)],
                      torch.full((M, T), nq, dtype=asso_gt.dtype, device=asso_gt.device))
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    nll = torch.where(row_valid[:, None], nll, torch.zeros_like(nll))
    n_obj = torch.where(row_valid[:, None], (tgt != nq).float(), torch.zeros_like(nll)).sum()
    return nll.sum() / (n_obj + 1e-4)


class Dropout:
    """Inverted dropout whose masks come from one generator, drawn in call order."""

    def __init__(self, rate: float, seed: int, device):
        self.keep = 1.0 - rate
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device
        self.drawn: List[tuple] = []  # the shapes drawn, in order

    def __call__(self, x):
        self.drawn.append(tuple(x.shape))
        mask = torch.rand(x.shape, generator=self.gen, device=x.device) < self.keep
        return x * mask / self.keep

    def skip(self, shapes: List[tuple], times: int) -> None:
        """Draw, and drop, ``times`` steps' masks of ``shapes``."""
        for _ in range(times):
            for shape in shapes:
                torch.rand(shape, generator=self.gen, device=self.device)


def losses(model: ReferenceModel, qf: torch.Tensor, batch: Dict, loss_cfg: Dict,
           drop: Optional[Dropout]) -> torch.Tensor:
    head = model.roi_heads
    dev = qf.device
    T, nq = qf.shape[:2]
    pv = torch.as_tensor(batch["prop_valid"], device=dev)
    total = qf.new_zeros(())
    if hasattr(head, "rescoring_head"):
        y = torch.as_tensor(batch["res_match_mask"], device=dev)[:, :, None, None].expand(
            T, nq, qf.shape[2], 1)
        fl = focal(head.rescoring_head(qf), y, loss_cfg["focal_alpha"], loss_cfg["focal_gamma"])
        total = total + fl.mean(dim=(1, 2)).sum() / float(batch["num_inst"]) * nq
    reid = head.asso_head(qf)
    long = model.associate(reid.reshape(1, T * nq, -1), pv.reshape(1, T * nq), False, drop)
    loss_long = asso_ce(long.reshape(T * nq, T, nq), pv.reshape(-1), pv,
                        torch.as_tensor(batch["asso_gt"], device=dev),
                        torch.as_tensor(batch["match_cues"], device=dev).reshape(-1))
    total = total + loss_cfg["asso_weight"] * loss_long
    short = qf.new_zeros(())
    for t in range(T - 1):
        lg = model.associate(reid[t:t + 2].reshape(1, 2 * nq, -1), pv[t:t + 2].reshape(1, 2 * nq),
                             True, drop)
        short = short + asso_ce(lg.reshape(2 * nq, 2, nq), pv[t:t + 2].reshape(-1), pv[t:t + 2],
                                torch.as_tensor(batch["asso_gt_pairs"][t], device=dev),
                                torch.as_tensor(batch["match_cues"][t:t + 2],
                                                device=dev).reshape(-1))
    return total + loss_cfg["asso_weight_local"] * short / max(T - 1, 1)


def lr_at(step: int, s: Dict) -> float:
    """Linear warm-up, then cosine, at optimizer step ``step`` (from 0)."""
    if step < s["warmup_iters"]:
        f = s["warmup_factor"]
        return s["base_lr"] * (f + (1 - f) * step / s["warmup_iters"])
    return s["base_lr"] * 0.5 * (1 + math.cos(math.pi * min(step / s["max_iter"], 1.0)))


def train_steps(model: ReferenceModel, clips: List, targets: List, m: Dict, tr: Dict,
                thresh: float, dropout_seed: int, follow: Optional[List[Dict]] = None,
                start: Optional[Dict] = None) -> Dict:
    """Train ``roi_heads`` for one step per clip. ``follow``: per step the reference points
    and the host batch of the run being judged; the spot's decoder then starts from those
    points and the losses take those decisions (top-k and host matching are discrete
    choices), else the model makes its own. ``start``: the state the steps start from,
    a run's at a later step: ``step`` (the optimizer steps before it), the head's
    ``params`` and AdamW's ``exp_avg`` and ``exp_avg_sq`` by name, and ``draws``, the
    dropout shapes of one step, which the dropout draws ``step`` times over first; None:
    the model's head, zero moments, step 0. Returns per step the reference points, the
    host fields, the batch and the loss, the first step's clipped gradient, each head
    parameter's change, by name, and the dropout shapes of the first step."""
    head = model.roi_heads
    named = [(f"roi_heads.{n}", p) for n, p in head.named_parameters()]
    params = [p for _, p in named]
    for p in model.parameters():
        p.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    m1 = [torch.zeros_like(p) for p in params]
    m2 = [torch.zeros_like(p) for p in params]
    k0 = 0
    if start is not None:
        k0 = int(start["step"])
        with torch.no_grad():
            for (n, p), a, b in zip(named, m1, m2):
                p.copy_(start["params"][n])
                a.copy_(start["exp_avg"][n])
                b.copy_(start["exp_avg_sq"][n])
    begin = [p.detach().clone() for p in params]
    s = tr["solver"]
    drop = Dropout(tr["asso_dropout"], dropout_seed, params[0].device) \
        if tr["asso_dropout"] > 0 else None
    if drop is not None and start is not None:
        drop.skip(start["draws"], k0)
    out = {"loss": [], "grad": None, "ref_points": [], "host": [], "batch": [], "top": [],
           "draws": []}
    for i, (clip, tgt) in enumerate(zip(clips, targets)):
        k = k0 + i
        x = normalize(clip, m["pixel_mean"], m["pixel_std"])
        raw = spot(model, x, None if follow is None else follow[i]["ref_points"],
                   top=2 * m["num_queries"])
        host = host_fields(raw)
        batch = (host_phase(host, tgt, thresh, tr["loss"]) if follow is None
                 else follow[i]["batch"])
        n_drawn = 0 if drop is None else len(drop.drawn)
        total = losses(model, raw["query_features"], batch, tr["loss"], drop)
        if i == 0 and drop is not None:
            out["draws"] = drop.drawn[n_drawn:]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = 1.0 if norm < s["clip"] else s["clip"] / norm
        grads = [g * scale for g in grads]
        if i == 0:
            out["grad"] = {n: g.clone() for (n, _), g in zip(named, grads)}
        lr = lr_at(k, s)
        with torch.no_grad():
            for p, g, a, b in zip(params, grads, m1, m2):
                p.mul_(1 - lr * s["weight_decay"])
                a.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                b.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (b.sqrt() / math.sqrt(1 - BETAS[1] ** (k + 1))).add_(EPS)
                p.addcdiv_(a, denom, value=-lr / (1 - BETAS[0] ** (k + 1)))
        out["loss"].append(float(total.detach()))
        out["ref_points"].append(raw["ref_points"])
        out["top"].append(raw["top"])
        out["host"].append(host)
        out["batch"].append(batch)
    out["change"] = {n: p.detach() - p0 for (n, p), p0 in zip(named, begin)}
    return out
