"""MOT metrics: MOTA / MOTP / IDF1 / MT-PT-ML, CLEAR-MOT event accumulation (the
port's copy of gomatching_tpu/evaluation/mot_metrics.py, on the port's own Hungarian).

A clean-room implementation of the MOTChallenge scoring used by the reference's
offline protocols (tools/Evaluation_Protocol_*/motmetrics — vendored upstream
py-motmetrics). Semantics:

  - per frame, previous gt->hyp correspondences are kept while still within the
    match threshold; remaining pairs are solved by Hungarian on the distance
    matrix; a gt matching a different hyp than its last correspondence counts an
    ID switch;
  - MOTA = 1 - (FN + FP + IDSW) / num_gt;  MOTP here reported as average overlap
    of matches (the ICDAR video protocols report 1 - avg distance, i.e. IoU);
  - IDF1 per Ristani et al.: trajectory-level bipartite assignment maximizing
    per-frame matchable overlap counts.

Distances are 1 - polygon IoU (convex quadrilaterals, Sutherland-Hodgman clip).
"""

from __future__ import annotations

import re

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.hungarian import solve


# ---------------------------------------------------------------------------
# convex polygon IoU
# ---------------------------------------------------------------------------


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _clip_poly(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip polygon by the half-plane left of edge a->b."""
    out = []
    n = len(subject)
    for i in range(n):
        cur, nxt = subject[i], subject[(i + 1) % n]
        side_cur = (b[0] - a[0]) * (cur[1] - a[1]) - (b[1] - a[1]) * (cur[0] - a[0])
        side_nxt = (b[0] - a[0]) * (nxt[1] - a[1]) - (b[1] - a[1]) * (nxt[0] - a[0])
        if side_cur >= 0:
            out.append(cur)
        if (side_cur >= 0) != (side_nxt >= 0):
            t = side_cur / (side_cur - side_nxt)
            out.append(cur + t * (nxt - cur))
    return np.asarray(out) if out else np.zeros((0, 2))


def _ccw(p: np.ndarray) -> np.ndarray:
    x, y = p[:, 0], p[:, 1]
    if float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) < 0:
        return p[::-1]
    return p


def _is_convex(p: np.ndarray) -> bool:
    d = np.roll(p, -1, 0) - p
    cross = d[:, 0] * np.roll(d, -1, 0)[:, 1] - d[:, 1] * np.roll(d, -1, 0)[:, 0]
    return bool(np.all(cross >= -1e-9) or np.all(cross <= 1e-9))


def _raster_iou(p1: np.ndarray, p2: np.ndarray) -> float:
    """Pixel-mask IoU on a local grid — the reference's ArTVideo/BOVText
    protocols compare rasterized masks (eval_trk.py:92-98); exact for concave
    polygons up to rasterization resolution."""
    import cv2

    x0 = min(p1[:, 0].min(), p2[:, 0].min())
    y0 = min(p1[:, 1].min(), p2[:, 1].min())
    x1 = max(p1[:, 0].max(), p2[:, 0].max())
    y1 = max(p1[:, 1].max(), p2[:, 1].max())
    w, h = x1 - x0, y1 - y0
    if w <= 0 or h <= 0:
        return 0.0
    scale = 512.0 / max(w, h)
    W = max(int(w * scale) + 2, 2)
    H = max(int(h * scale) + 2, 2)
    m1 = np.zeros((H, W), np.uint8)
    m2 = np.zeros((H, W), np.uint8)
    q1 = np.round((p1 - (x0, y0)) * scale).astype(np.int32)
    q2 = np.round((p2 - (x0, y0)) * scale).astype(np.int32)
    cv2.fillPoly(m1, [q1.reshape(-1, 1, 2)], 1)
    cv2.fillPoly(m2, [q2.reshape(-1, 1, 2)], 1)
    inter = int(np.sum(m1 & m2))
    union = int(np.sum(m1 | m2))
    return inter / union if union else 0.0


def polygon_iou(p1: np.ndarray, p2: np.ndarray) -> float:
    """IoU of two simple polygons ((n, 2) arrays).

    Convex pairs go through exact Sutherland-Hodgman clipping; any concave
    operand (ArTVideo curved text, BOVText free-form polygons) falls back to
    rasterized mask IoU — Sutherland-Hodgman requires a convex clip polygon and
    silently returns wrong areas otherwise."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    a1, a2 = _poly_area(p1), _poly_area(p2)
    if a1 <= 0 or a2 <= 0:
        return 0.0
    if not (_is_convex(p1) and _is_convex(p2)):
        return _raster_iou(p1, p2)
    clip = _ccw(p2)
    inter = _ccw(p1)
    for i in range(len(clip)):
        inter = _clip_poly(inter, clip[i], clip[(i + 1) % len(clip)])
        if len(inter) == 0:
            return 0.0
    ai = _poly_area(inter)
    return ai / (a1 + a2 - ai)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of (n, 2) points (CCW)."""
    pts = np.asarray(pts, np.float64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    P = [tuple(pts[i]) for i in order]
    uniq = []
    for q in P:
        if not uniq or uniq[-1] != q:
            uniq.append(q)
    if len(uniq) <= 2:
        return np.asarray(uniq, np.float64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in uniq:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(uniq):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def intersection_over_det(det_poly: np.ndarray, gt_poly: np.ndarray) -> float:
    """intersection(hull(det), hull(gt)) / area(hull(det)) — the official
    DSText/ICDAR15 don't-care overlap test (overlapping_fn,
    Track_video_2_0.py:411-422)."""
    pd = convex_hull(np.asarray(det_poly, np.float64).reshape(-1, 2))
    pg = convex_hull(np.asarray(gt_poly, np.float64).reshape(-1, 2))
    if len(pd) < 3 or len(pg) < 3:
        return 0.0
    ad = _poly_area(pd)
    if ad <= 0 or _poly_area(pg) <= 0:
        return 0.0
    inter = _ccw(pd)
    clip = _ccw(pg)
    for i in range(len(clip)):
        inter = _clip_poly(inter, clip[i], clip[(i + 1) % len(clip)])
        if len(inter) == 0:
            return 0.0
    return _poly_area(inter) / ad


def quad_iou_matrix(gt_quads: np.ndarray, hyp_quads: np.ndarray) -> np.ndarray:
    """(G, 8) x (H, 8) -> (G, H) IoU matrix."""
    G, H = len(gt_quads), len(hyp_quads)
    out = np.zeros((G, H))
    for i in range(G):
        for j in range(H):
            out[i, j] = polygon_iou(
                gt_quads[i].reshape(4, 2), hyp_quads[j].reshape(4, 2)
            )
    return out


def poly_iou_matrix(gt_polys, hyp_polys) -> np.ndarray:
    """General-polygon IoU matrix: lists of flat (2n,) arrays with possibly
    different vertex counts per polygon (BOVText / ArTVideo protocols use
    arbitrary polygons, not quads)."""
    G, H = len(gt_polys), len(hyp_polys)
    out = np.zeros((G, H))
    for i in range(G):
        gi = np.asarray(gt_polys[i], np.float64).reshape(-1, 2)
        for j in range(H):
            out[i, j] = polygon_iou(gi, np.asarray(hyp_polys[j], np.float64).reshape(-1, 2))
    return out


def levenshtein(a: str, b: str) -> int:
    """Edit distance (BOVText transcription-similarity cost,
    Evaluation_Protocol_BOV_Text Task2 evaluation.py)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def text_similarity(a: str, b: str) -> float:
    """1 - normalized edit distance in [0, 1]."""
    if not a and not b:
        return 1.0
    return 1.0 - levenshtein(a, b) / max(len(a), len(b), 1)


_BOV_KEEP = re.compile(u"[^\u4e00-\u9fa5\u0030-\u0039\u0041-\u005a\u0061-\u007a]")


def bovtext_similarity(a: str, b: str) -> float:
    """The official BOVText cal_similarity (Task2 evaluation.py:67-74):
    strings keep only [chinese | digits | ascii letters] lowercased; empty vs
    empty scores 1.0; edit distance exactly 1 scores 0.95; else 1 - lev/maxlen.
    """
    a = _BOV_KEEP.sub("", a).lower()
    b = _BOV_KEEP.sub("", b).lower()
    if a == "" and b == "":
        return 1.0
    d = levenshtein(a, b)
    if d == 1:
        return 0.95
    return 1.0 - d / max(len(a), len(b))


def evaluate_detection(
    frames,
    iou_threshold: float = 0.5,
):
    """Frame-level detection protocol (DSText det, script.py:54-368 semantics):
    one-to-one IoU>=thr greedy matching per frame, GT '###' regions are
    don't-care (they and any prediction covered by them are excluded).

    ``frames``: iterable of (gt_polys, gt_texts, pred_polys) per frame, where
    polys are lists of flat coordinate arrays.
    Returns {precision, recall, hmean, matched, num_gt, num_det}.
    """
    matched = num_gt = num_det = 0
    for gt_polys, gt_texts, pred_polys in frames:
        care = [i for i, t in enumerate(gt_texts) if t != "###"]
        dontcare = [i for i, t in enumerate(gt_texts) if t == "###"]
        keep_pred = list(range(len(pred_polys)))
        if dontcare and pred_polys:
            # a prediction mostly inside a don't-care region is excluded
            for j in list(keep_pred):
                pj = np.asarray(pred_polys[j], np.float64).reshape(-1, 2)
                aj = _poly_area(_ccw(pj))
                for i in dontcare:
                    gi = np.asarray(gt_polys[i], np.float64).reshape(-1, 2)
                    iou = polygon_iou(gi, pj)
                    # area-precision vs the ignore region
                    inter = iou * (_poly_area(_ccw(gi)) + aj) / (1 + iou) if iou > 0 else 0.0
                    if aj > 0 and inter / aj > 0.5:
                        keep_pred.remove(j)
                        break
        num_gt += len(care)
        num_det += len(keep_pred)
        if care and keep_pred:
            iou = poly_iou_matrix(
                [gt_polys[i] for i in care], [pred_polys[j] for j in keep_pred]
            )
            # first-come greedy in (gt, det) index order with STRICT IoU >
            # threshold — the official protocol's matching (script.py:246-255),
            # not Hungarian (which would inflate matches on ambiguous overlaps)
            used = np.zeros(len(keep_pred), bool)
            for gi in range(len(care)):
                for dj in range(len(keep_pred)):
                    if not used[dj] and iou[gi, dj] > iou_threshold:
                        used[dj] = True
                        matched += 1
                        break
    precision = matched / num_det if num_det else (1.0 if num_gt == 0 else 0.0)
    recall = matched / num_gt if num_gt else 1.0
    hmean = (
        2 * precision * recall / (precision + recall) if precision + recall else 0.0
    )
    return {
        "precision": precision,
        "recall": recall,
        "hmean": hmean,
        "matched": matched,
        "num_gt": num_gt,
        "num_det": num_det,
    }


# ---------------------------------------------------------------------------
# CLEAR-MOT accumulator
# ---------------------------------------------------------------------------


@dataclass
class MOTAccumulator:
    iou_threshold: float = 0.5
    # 1.0 = exact transcription match in e2e mode; <1.0 = similarity threshold
    text_sim_threshold: float = 1.0
    # e2e transcription rule: 'sim' (plain normalized-edit-distance similarity
    # >= text_sim_threshold; == exact match at threshold 1.0), 'bovtext'
    # (bovtext_similarity >= threshold), 'icdar' (track-level equality after
    # the official normalization: det.upper() == strip-to-[chinese|alnum](gt
    # .upper()), E2E_video_2_0.py:364-368)
    text_rule: str = "sim"
    # official ICDAR/DSText validity is STRICTLY iou > threshold
    # (Track_video_2_0.py:275 'if distance>0.5'); the other protocols use >=
    strict_threshold: bool = False
    # The ArTVideo protocol feeds motmetrics dist = IoU (eval_trk.py:101-118),
    # so its Hungarian MINIMIZES IoU among above-threshold pairs; the other
    # protocols feed 1 - IoU (Track_video_2_0.py:275) and maximize. Protocol
    # fidelity beats sanity here - set True for ArTVideo scoring.
    match_lowest_iou: bool = False
    num_gt: int = 0
    num_hyp: int = 0
    num_matches: int = 0
    num_switches: int = 0
    num_fp: int = 0
    num_misses: int = 0
    total_overlap: float = 0.0
    last_match: Dict = field(default_factory=dict)  # gt_id -> hyp_id
    gt_frames: Dict = field(default_factory=dict)  # gt_id -> frame count
    hyp_frames: Dict = field(default_factory=dict)
    pair_overlap: Dict = field(default_factory=dict)  # (gt_id, hyp_id) -> matchable count
    gt_matched_frames: Dict = field(default_factory=dict)  # gt_id -> matched count

    def update(
        self,
        gt_ids: List,
        gt_quads: np.ndarray,
        hyp_ids: List,
        hyp_quads: np.ndarray,
        texts: Optional[Tuple[List[str], List[str]]] = None,
        iou_matrix: Optional[np.ndarray] = None,
    ):
        """``iou_matrix``: optional precomputed (G, H) overlap matrix (e.g. the
        ArTVideo rasterized mask IoU, eval_trk.py:92-99) — the polygon IoU and
        text gating are skipped; the caller zeroes invalid pairs itself."""
        G, H = len(gt_ids), len(hyp_ids)
        self.num_gt += G
        self.num_hyp += H
        for g in gt_ids:
            self.gt_frames[g] = self.gt_frames.get(g, 0) + 1
        for h in hyp_ids:
            self.hyp_frames[h] = self.hyp_frames.get(h, 0) + 1

        # polygons may have per-instance vertex counts (ArTVideo curved text);
        # quads are just the 4-vertex special case
        if iou_matrix is not None:
            iou = np.asarray(iou_matrix, np.float64).reshape(G, H)
            texts = None
        else:
            iou = poly_iou_matrix(gt_quads, hyp_quads) if G and H else np.zeros((G, H))
        if texts is not None and G and H:
            # E2E spotting: transcription must also match. Exact match for the
            # ICDAR protocols; the BOVText protocol accepts normalized-edit-
            # distance similarity >= text_sim_threshold instead.
            g_txt, h_txt = texts
            if self.text_rule == "icdar":
                norm_g = [_BOV_KEEP.sub("", t.upper()).upper() for t in g_txt]
                mism = np.asarray(
                    [[h_txt[j].upper() != norm_g[i] for j in range(H)] for i in range(G)]
                )
            elif self.text_sim_threshold < 1.0:
                sim = bovtext_similarity if self.text_rule == "bovtext" else text_similarity
                mism = np.asarray(
                    [
                        [
                            sim(g_txt[i], h_txt[j]) < self.text_sim_threshold
                            for j in range(H)
                        ]
                        for i in range(G)
                    ]
                )
            else:
                mism = np.asarray(
                    [[g_txt[i] != h_txt[j] for j in range(H)] for i in range(G)]
                )
            iou = np.where(mism, 0.0, iou)
        valid = (
            iou > self.iou_threshold if self.strict_threshold else iou >= self.iou_threshold
        )

        # id-level matchable counts for IDF1
        for i in range(G):
            for j in range(H):
                if valid[i, j]:
                    key = (gt_ids[i], hyp_ids[j])
                    self.pair_overlap[key] = self.pair_overlap.get(key, 0) + 1

        matched_g, matched_h = set(), set()
        matches = {}
        # 1. keep previous correspondences that remain valid (each hypothesis
        # may be claimed by at most ONE gt — two gts sharing a last_match would
        # otherwise double-count one hyp and drive FP negative)
        for i, g in enumerate(gt_ids):
            h_prev = self.last_match.get(g)
            if h_prev is not None and h_prev in hyp_ids:
                j = hyp_ids.index(h_prev)
                if j not in matched_h and valid[i, j]:
                    matches[g] = (h_prev, iou[i, j])
                    matched_g.add(i)
                    matched_h.add(j)
        # 2. Hungarian on the rest (maximize IoU)
        free_g = [i for i in range(G) if i not in matched_g]
        free_h = [j for j in range(H) if j not in matched_h]
        if free_g and free_h:
            sub = iou[np.ix_(free_g, free_h)]
            matchable = (
                sub > self.iou_threshold if self.strict_threshold
                else sub >= self.iou_threshold
            )
            cost = np.where(matchable, sub if self.match_lowest_iou else 1.0 - sub, 1e6)
            ri, ci = solve(cost)
            for r, c in zip(ri, ci):
                if matchable[r, c]:
                    g, h = gt_ids[free_g[r]], hyp_ids[free_h[c]]
                    matches[g] = (h, sub[r, c])
                    matched_g.add(free_g[r])
                    matched_h.add(free_h[c])

        for g, (h, ov) in matches.items():
            prev = self.last_match.get(g)
            if prev is not None and prev != h:
                self.num_switches += 1
            self.last_match[g] = h
            self.num_matches += 1
            self.total_overlap += ov
            self.gt_matched_frames[g] = self.gt_matched_frames.get(g, 0) + 1
        self.num_misses += G - len(matches)
        self.num_fp += H - len(matches)

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        mota = (
            1.0 - (self.num_misses + self.num_fp + self.num_switches) / self.num_gt
            if self.num_gt
            else 0.0
        )
        motp = self.total_overlap / self.num_matches if self.num_matches else 0.0

        # IDF1 via trajectory-level LAP
        gt_ids = sorted(self.gt_frames)
        hyp_ids = sorted(self.hyp_frames)
        Gn, Hn = len(gt_ids), len(hyp_ids)
        idtp = 0
        if Gn and Hn:
            overlap = np.zeros((Gn, Hn))
            for (g, h), c in self.pair_overlap.items():
                overlap[gt_ids.index(g), hyp_ids.index(h)] = c
            ri, ci = solve(-overlap)
            idtp = int(sum(overlap[r, c] for r, c in zip(ri, ci)))
        sum_gt = sum(self.gt_frames.values())
        sum_hyp = sum(self.hyp_frames.values())
        idf1 = 2 * idtp / (sum_gt + sum_hyp) if (sum_gt + sum_hyp) else 0.0

        mt = pt = ml = 0
        for g, total in self.gt_frames.items():
            ratio = self.gt_matched_frames.get(g, 0) / total
            if ratio >= 0.8:
                mt += 1
            elif ratio <= 0.2:
                ml += 1
            else:
                pt += 1

        return {
            "MOTA": mota,
            "MOTP": motp,
            "IDF1": idf1,
            "IDP": idtp / sum_hyp if sum_hyp else 0.0,
            "IDR": idtp / sum_gt if sum_gt else 0.0,
            "IDSW": self.num_switches,
            "FP": self.num_fp,
            "FN": self.num_misses,
            "MT": mt,
            "PT": pt,
            "ML": ml,
            "precision": self.num_matches / self.num_hyp if self.num_hyp else 0.0,
            "recall": self.num_matches / self.num_gt if self.num_gt else 0.0,
            "num_gt": self.num_gt,
        }
