"""DeepSolo spotter pretraining criterion (port of
``gomatching_tpu/engine/spotter_losses.py``).

Parity targets, as the JAX package's:
  - losses: third_party/adet/modeling/model/losses.py:10-296 (focal point-class loss,
    CTC text loss with the '###'-ignore rule, ctrl-point / boundary L1, sampled-Bezier
    L1; aux-layer and encoder loss loops :272-295);
  - matchers: third_party/adet/modeling/model/matcher.py:11-156 (per-(query, gt) CTC
    cost matrix; Bezier matcher over the encoder token proposals).

Targets are fixed-shape padded tensors (B, G, ...) with a validity mask. The cost
matrices are computed on the device; the assignment is solved on the host by the
port's Hungarian (``ops/hungarian.py``). A match is ``gt_of_query`` (B, nq) with -1 for
unmatched, so everything downstream is gather + mask.

CTC: ``F.ctc_loss(reduction='none')`` on ``log_softmax`` inputs laid out (T, N, C)
(optax takes raw logits). JAX's feasibility mask, which stands in for the reference's
``zero_infinity=True``, is kept; ``zero_infinity`` is also set so that an infeasible
pair's backward is zero rather than NaN.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.spotter import bernstein_matrix
from ..ops import hungarian

UNK_INDEX = 36  # the reference hardcodes 36 for the '###' ignore rule
# (losses.py:185, matcher.py:67) regardless of VOC_SIZE


def _ctc_feasible(labels: torch.Tensor, lengths: torch.Tensor, T: int) -> torch.Tensor:
    """CTC alignment feasibility: T >= L + #adjacent-repeats (a repeat needs a blank
    between its frames). labels (..., N) with padding replaced by a valid index;
    lengths (...,) true label lengths."""
    N = labels.shape[-1]
    pos = torch.arange(1, N, device=labels.device)
    rep = (labels[..., 1:] == labels[..., :-1]) & (pos < lengths[..., None])
    return lengths + rep.sum(-1) <= T


def _ctc_nll(logits: torch.Tensor, labels: torch.Tensor, voc_size: int):
    """Per-row CTC negative log-likelihood of raw ``logits`` (N, T, K), blank last,
    against ``labels`` (N, Tl) padded with ``voc_size`` -> (nll (N,), lengths (N,),
    labels with the padding replaced by 0)."""
    N, T, _ = logits.shape
    lengths = (labels != voc_size).sum(-1)
    labels = torch.where(labels == voc_size, 0, labels).long()
    log_probs = F.log_softmax(logits.float(), -1).transpose(0, 1)  # (T, N, K)
    nll = F.ctc_loss(log_probs, labels, torch.full((N,), T, dtype=torch.long),
                     lengths.long(), blank=voc_size, reduction="none", zero_infinity=True)
    return nll, lengths, labels


# ---------------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------------
def solve_padded(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Host LSAP on a padded (B, nq, G) cost; returns gt_of_query (B, nq), -1 pad.
    Non-finite costs are clamped as the JAX package's in-graph ``assign`` does."""
    cost = np.nan_to_num(np.asarray(cost, np.float64), nan=1e9, posinf=1e9, neginf=-1e9)
    B, nq, _ = cost.shape
    out = np.full((B, nq), -1, np.int64)
    for b in range(B):
        g = int(n_valid[b])
        if g == 0:
            continue
        r, c = hungarian.solve(cost[b, :, :g])
        out[b, r] = c
    return out


def solve(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Detach, copy to the host, solve, and return the match on ``cost``'s device."""
    m = solve_padded(cost.detach().cpu().numpy(), n_valid.detach().cpu().numpy())
    return torch.from_numpy(m).to(cost.device)


# ---------------------------------------------------------------------------
# cost pieces
# ---------------------------------------------------------------------------
def focal_class_cost(prob: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """pos_cost - neg_cost of the focal matching cost (matcher.py:85-90)."""
    neg = (1 - alpha) * (prob**gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    return pos - neg


def ctc_cost_matrix(text_logits: torch.Tensor, texts: torch.Tensor, voc_size: int) -> torch.Tensor:
    """(nq, G) CTC cost of raw ``text_logits`` (nq, T, K) against ``texts`` (G, Tl)
    padded with ``voc_size``, averaged by target length, with the '###' rule and
    infeasible pairs zeroed: one batched CTC over all nq x G pairs."""
    nq, T, K = text_logits.shape
    G, Tl = texts.shape
    logits = text_logits[:, None].expand(nq, G, T, K).reshape(nq * G, T, K)
    labels = texts[None].expand(nq, G, Tl).reshape(nq * G, Tl)
    loss = _ctc_nll(logits, labels, voc_size)[0].view(nq, G)
    lengths = (texts != voc_size).sum(-1)
    ignore = (lengths == 1) & (texts[:, 0] == UNK_INDEX)  # '###' instances
    feasible = _ctc_feasible(torch.where(texts == voc_size, 0, texts), lengths, T)
    loss = torch.where((ignore | (lengths == 0) | ~feasible)[None, :],
                       torch.zeros_like(loss), loss)
    return loss / lengths.clamp(min=1)[None, :]


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------
def match_ctrl_points_cost(outputs: Dict, targets: Dict, voc_size: int, class_weight: float,
                           coord_weight: float, text_weight: float, alpha: float = 0.25,
                           gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder Hungarian cost (CtrlPointHungarianMatcher, matcher.py:11-97) ->
    padded (B, nq, G) cost + (B,) valid-gt counts."""
    prob = outputs["pred_logits"].float().sigmoid()  # (B, nq, npts, 1)
    cost_class = focal_class_cost(prob, alpha, gamma)[..., 0].mean(-1)  # (B, nq)
    out_pts = outputs["pred_ctrl_points"].float()  # (B, nq, npts, 2)
    tgt_pts = targets["ctrl_points"].float()  # (B, G, npts, 2)
    B, nq = out_pts.shape[:2]
    G = tgt_pts.shape[1]
    cost_kpts = (out_pts.reshape(B, nq, 1, -1) - tgt_pts.reshape(B, 1, G, -1)).abs().sum(-1)
    text_logits = outputs["pred_text_logits"].float()
    cost_text = torch.stack([ctc_cost_matrix(text_logits[b], targets["texts"][b], voc_size)
                             for b in range(B)])
    C = class_weight * cost_class[..., None] + coord_weight * cost_kpts + text_weight * cost_text
    valid = targets["valid"]
    C = torch.where(valid[:, None, :], C, torch.full_like(C, 1e9))
    return C, valid.sum(1)


def match_beziers_cost(outputs: Dict, targets: Dict, num_sample_points: int,
                       class_weight: float, coord_weight: float, alpha: float = 0.25,
                       gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-proposal Hungarian cost (BezierHungarianMatcher, matcher.py:100-156);
    outputs enc_logits (B, S, 1), enc_beziers (B, S, 8) sigmoided -> padded
    (B, S, G) cost + (B,) valid-gt counts."""
    prob = outputs["enc_logits"].float().sigmoid()[..., 0]  # (B, S)
    cost_class = focal_class_cost(prob, alpha, gamma)  # labels are all class 0
    out_bez = outputs["enc_beziers"].float()
    B, S, _ = out_bez.shape
    G = targets["beziers"].shape[1]
    bern = torch.from_numpy(bernstein_matrix(num_sample_points)).to(out_bez.device)
    out_s = torch.einsum("pk,bskc->bspc", bern, out_bez.reshape(B, S, 4, 2))
    tgt_s = torch.einsum("pk,bgkc->bgpc", bern, targets["beziers"].float())
    cost_coord = (out_s.reshape(B, S, 1, -1) - tgt_s.reshape(B, 1, G, -1)).abs().sum(-1)
    C = class_weight * cost_class[..., None] + coord_weight * cost_coord
    valid = targets["valid"]
    C = torch.where(valid[:, None, :], C, torch.full_like(C, 1e9))
    return C, valid.sum(1)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _sigmoid_focal(inputs, target01, alpha, gamma):
    prob = inputs.sigmoid()
    ce = F.binary_cross_entropy_with_logits(inputs, target01, reduction="none")
    p_t = prob * target01 + (1 - prob) * (1 - target01)
    loss = ce * ((1 - p_t) ** gamma)
    alpha_t = alpha * target01 + (1 - alpha) * (1 - target01)
    return alpha_t * loss


def loss_labels(logits, gt_of_query, num_inst, alpha=0.25, gamma=2.0):
    """Focal class loss (losses.py:87-118): matched queries' points positive.
    logits (B, nq, npts, 1), or (B, S, 1) for the encoder variant."""
    matched = (gt_of_query >= 0).float()
    target = matched.view(matched.shape + (1,) * (logits.ndim - 2)).expand(logits.shape)
    loss = _sigmoid_focal(logits.float(), target, alpha, gamma)
    # mean over (nq[, npts]), sum over batch, x nq (losses.py:36-38, :117)
    dims = (1, 2) if logits.ndim == 4 else (1,)
    return loss.mean(dims).sum() / num_inst * logits.shape[1]


def _gather_gt(tgt: torch.Tensor, gt_of_query: torch.Tensor) -> torch.Tensor:
    """tgt (B, G, ...) gathered to (B, nq, ...) through gt_of_query (B, nq); row 0
    where the match is -1."""
    rows = torch.arange(tgt.shape[0], device=tgt.device)[:, None]
    return tgt[rows, gt_of_query.clamp(min=0)]


def loss_ctrl_points(pred, tgt, gt_of_query, num_inst):
    """Matched L1, summed, / num_inst (losses.py:202-211)."""
    g = _gather_gt(tgt.float(), gt_of_query)
    mask = (gt_of_query >= 0).view(gt_of_query.shape + (1,) * (pred.ndim - 2))
    return ((pred.float() - g).abs() * mask).sum() / num_inst


def loss_texts(text_logits, texts, gt_of_query, voc_size):
    """CTC over matched pairs, mean over matched instances (losses.py:152-191)."""
    B, nq, T, K = text_logits.shape
    flat_texts = _gather_gt(texts, gt_of_query).reshape(B * nq, -1)
    nll, lengths, labels = _ctc_nll(text_logits.reshape(B * nq, T, K), flat_texts, voc_size)
    matched = (gt_of_query >= 0).reshape(B * nq)
    ignore = (lengths == 1) & (flat_texts[:, 0] == UNK_INDEX)
    keep = matched & ~ignore & (lengths > 0) & _ctc_feasible(labels, lengths, T)
    # ignored pairs count in the denominator but add zero (losses.py:190-191)
    n = matched.sum().clamp(min=1)
    return torch.where(keep, nll, torch.zeros_like(nll)).sum() / n


def loss_beziers(enc_beziers, tgt_beziers, gt_of_token, num_inst, num_sample_points):
    """L1 on curve-sampled points of matched encoder proposals (losses.py:120-136)."""
    B, S, _ = enc_beziers.shape
    bern = torch.from_numpy(bernstein_matrix(num_sample_points)).to(enc_beziers.device)
    g = _gather_gt(tgt_beziers.float(), gt_of_token)  # (B, S, 4, 2)
    pred_s = torch.einsum("pk,bskc->bspc", bern, enc_beziers.float().reshape(B, S, 4, 2))
    tgt_s = torch.einsum("pk,bskc->bspc", bern, g)
    mask = (gt_of_token >= 0)[..., None, None]
    return ((pred_s - tgt_s).abs() * mask).sum() / num_inst


# ---------------------------------------------------------------------------
# criterion
# ---------------------------------------------------------------------------
class SpotterCriterion:
    """Full pretraining criterion: decoder losses on the final and aux layers, encoder
    losses on the two-stage proposals (losses.py:250-297)."""

    def __init__(self, cfg):
        t = cfg.MODEL.TRANSFORMER
        lw = t.LOSS
        self.voc_size = t.VOC_SIZE
        self.alpha = lw.FOCAL_ALPHA
        self.gamma = lw.FOCAL_GAMMA
        self.num_sample_points = lw.BEZIER_SAMPLE_POINTS
        self.boundary = t.BOUNDARY_HEAD
        self.aux = lw.AUX_LOSS
        self.weights = {
            "loss_ce": lw.POINT_CLASS_WEIGHT,
            "loss_texts": lw.POINT_TEXT_WEIGHT,
            "loss_ctrl_points": lw.POINT_COORD_WEIGHT,
            "loss_bd_points": lw.BOUNDARY_WEIGHT,
            "loss_bezier_enc": lw.BEZIER_COORD_WEIGHT,
            "loss_ce_enc": lw.BEZIER_CLASS_WEIGHT,
        }

    def _dec_cost(self, out, targets):
        w = self.weights
        return match_ctrl_points_cost(out, targets, self.voc_size, w["loss_ce"],
                                      w["loss_ctrl_points"], w["loss_texts"], self.alpha,
                                      self.gamma)

    def _enc_cost(self, outputs, targets):
        w = self.weights
        return match_beziers_cost(outputs, targets, self.num_sample_points, w["loss_ce_enc"],
                                  w["loss_bezier_enc"], self.alpha, self.gamma)

    @torch.no_grad()
    def costs(self, outputs: Dict, targets: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Every Hungarian cost matrix of one step, keyed like the matches ``__call__``
        accepts: 'dec', 'aux_<i>', 'enc'. Computed without a graph."""
        cs = {"dec": self._dec_cost(outputs, targets)}
        if self.aux:
            for i, aux in enumerate(outputs.get("aux_outputs", ())):
                cs[f"aux_{i}"] = self._dec_cost(aux, targets)
        if "enc_logits" in outputs:
            cs["enc"] = self._enc_cost(outputs, targets)
        return cs

    def _dec_losses(self, out, targets, num_inst, suffix, gt_of_q):
        if gt_of_q is None:
            with torch.no_grad():
                gt_of_q = solve(*self._dec_cost(out, targets))
        w = self.weights
        d = {
            f"loss_ce{suffix}": w["loss_ce"]
            * loss_labels(out["pred_logits"], gt_of_q, num_inst, self.alpha, self.gamma),
            f"loss_texts{suffix}": w["loss_texts"]
            * loss_texts(out["pred_text_logits"], targets["texts"], gt_of_q, self.voc_size),
            f"loss_ctrl_points{suffix}": w["loss_ctrl_points"]
            * loss_ctrl_points(out["pred_ctrl_points"], targets["ctrl_points"], gt_of_q, num_inst),
        }
        if self.boundary and out.get("pred_bd_points") is not None:
            d[f"loss_bd_points{suffix}"] = w["loss_bd_points"] * loss_ctrl_points(
                out["pred_bd_points"], targets["bd_points"], gt_of_q, num_inst)
        return d

    def __call__(self, outputs: Dict, targets: Dict, num_inst: Optional[torch.Tensor] = None,
                 matches: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """targets: valid (B, G), ctrl_points (B, G, npts, 2), texts (B, G, T),
        beziers (B, G, 4, 2), bd_points (B, G, npts, 4). ``matches``: pre-solved
        assignments keyed like ``costs``; a missing one is solved here."""
        if num_inst is None:
            num_inst = targets["valid"].sum().float()
        num_inst = torch.as_tensor(num_inst, dtype=torch.float32).clamp(min=1.0)
        m = matches or {}
        losses = self._dec_losses(outputs, targets, num_inst, "", m.get("dec"))
        if self.aux:
            for i, aux in enumerate(outputs.get("aux_outputs", ())):
                losses.update(self._dec_losses(aux, targets, num_inst, f"_{i}",
                                               m.get(f"aux_{i}")))
        if "enc_logits" in outputs:
            gt_of_tok = m.get("enc")
            if gt_of_tok is None:
                with torch.no_grad():
                    gt_of_tok = solve(*self._enc_cost(outputs, targets))
            losses["loss_ce_enc"] = self.weights["loss_ce_enc"] * loss_labels(
                outputs["enc_logits"], gt_of_tok, num_inst, self.alpha, self.gamma)
            losses["loss_bezier_enc"] = self.weights["loss_bezier_enc"] * loss_beziers(
                outputs["enc_beziers"], targets["beziers"], gt_of_tok, num_inst,
                self.num_sample_points)
        return losses
