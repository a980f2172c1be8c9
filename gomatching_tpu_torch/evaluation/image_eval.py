"""Image text-spotting evaluation (pretraining side; the port's copy of
gomatching_tpu/evaluation/image_eval.py).

Parity: the official RRC-style scorer the reference's TextEvaluator calls
(third_party/adet/evaluation/text_eval_script.py, WORD_SPOTTING=True by
default) — micro-averaged end-to-end word spotting plus its detection-only
companion metric, with the word-spotting dictionary rules and the greedy
one-to-one matching order reproduced exactly:

- GT '###' is don't-care; under word spotting a GT word additionally becomes
  don't-care when it fails ``include_in_dictionary`` (inner spaces after
  special-char removal, length < 3, characters outside the latin/greek
  ranges — text_eval_script.py:321-371), otherwise its transcription is
  normalized by ``include_in_dictionary_transcription``.
- A detection is don't-care when intersection/det-area > 0.5 against any
  don't-care GT (text_eval_script.py:343-351).
- Matching is GREEDY in (gt, det) nested-loop order — first unmatched pair
  with IoU > 0.5 wins (text_eval_script.py:378-397) — not an optimal
  assignment; a correct match additionally needs uppercased-exact
  transcription equality (levenshtein == 0, :387-391).
- The companion DETECTION_ONLY metric of this fork ignores NOTHING: its
  don't-care lists are never populated (the '###' handling is commented out
  at text_eval_script.py:296-297 "hhb"), so every GT including '###' counts.
- Global metrics are micro-averaged over summed counts (:456-458), unlike
  the video protocols' per-video macro averages.

Lexicon correction is the reference's PRE-scoring step (TextEvaluator's
find_match_word, text_evaluation_all.py:249-264): an OCR word is replaced by
the nearest lexicon entry by UPPERCASED plain edit distance, accepted when
the distance is < 1.5, before the submission reaches the scorer.

Cross-validated verbatim against the official script in
tests/test_image_eval_vs_official.py (the same evidence standard as the four
video protocols).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .mot_metrics import intersection_over_det, levenshtein, poly_iou_matrix

# text_eval_script.py:38 (transcription_match's special set, includes \')
SPECIAL_CHARACTERS = "!?.:,*\"()·[]/'"
# text_eval_script.py:332,:356 (dictionary rules use a set WITHOUT the
# trailing backslash-quote ordering quirk: leading apostrophe, no '?')
_DICT_SPECIALS = "'!?.:,*\"()·[]/"
_NOT_ALLOWED = "×÷·"
_CHAR_RANGES = (
    (ord("a"), ord("z")),
    (ord("A"), ord("Z")),
    (ord("À"), ord("ƿ")),
    (ord("Ǆ"), ord("ɿ")),
    (ord("Ά"), ord("Ͽ")),
    (ord("-"), ord("-")),
)


def _strip_terminations(transcription: str) -> str:
    """Shared prefix of the two dictionary helpers: drop a trailing 's/'S,
    strip hyphens at the ends, blank out special characters, strip
    (text_eval_script.py:324-337,:361-371)."""
    if transcription[-2:] in ("'s", "'S"):
        transcription = transcription[:-2]
    transcription = transcription.strip("-")
    for ch in _DICT_SPECIALS:
        transcription = transcription.replace(ch, " ")
    return transcription.strip()


def include_in_dictionary(transcription: str, min_length: int = 3) -> bool:
    """Word-spotting care rule for a GT transcription
    (text_eval_script.py:321-353)."""
    t = _strip_terminations(transcription)
    if len(t) != len(t.replace(" ", "")):
        return False
    if len(t) < min_length:
        return False
    for ch in t:
        if ch in _NOT_ALLOWED:
            return False
        code = ord(ch)
        if not any(lo <= code <= hi for lo, hi in _CHAR_RANGES):
            return False
    return True


def include_in_dictionary_transcription(transcription: str) -> str:
    """Normalization applied to a care GT word before matching
    (text_eval_script.py:355-371)."""
    return _strip_terminations(transcription)


def transcription_match(
    trans_gt: str,
    trans_det: str,
    special_characters: str = SPECIAL_CHARACTERS,
    only_remove_first_last_character_gt: bool = True,
) -> bool:
    """Non-word-spotting transcription test (text_eval_script.py:146-179):
    GT special characters are forgiven at the first/last position only."""
    if only_remove_first_last_character_gt:
        if trans_gt == trans_det:
            return True
        if trans_gt and trans_gt[0] in special_characters:
            if trans_gt[1:] == trans_det:
                return True
        if trans_gt and trans_gt[-1] in special_characters:
            if trans_gt[:-1] == trans_det:
                return True
        if (
            len(trans_gt) >= 2
            and trans_gt[0] in special_characters
            and trans_gt[-1] in special_characters
            and trans_gt[1:-1] == trans_det
        ):
            return True
        return False
    while trans_gt and trans_gt[0] in special_characters:
        trans_gt = trans_gt[1:]
    while trans_det and trans_det[0] in special_characters:
        trans_det = trans_det[1:]
    while trans_gt and trans_gt[-1] in special_characters:
        trans_gt = trans_gt[:-1]
    while trans_det and trans_det[-1] in special_characters:
        trans_det = trans_det[:-1]
    return trans_gt == trans_det


def lexicon_correct(word: str, lexicon: Sequence[str], max_dist: float = 1.5) -> str:
    """Replace ``word`` by its nearest lexicon entry (uppercased plain edit
    distance) when the minimum distance is < ``max_dist`` — the reference's
    find_match_word + its `match_dist < 1.5` acceptance
    (text_evaluation_all.py:249-264, :331-333)."""
    if not lexicon:
        return word
    best, best_d = word, len(word) + 100
    wu = word.upper()
    for cand in lexicon:
        d = levenshtein(wu, cand.upper())
        if d < best_d:
            best, best_d = cand, d
    if best_d < max_dist:
        return best
    return word


def _greedy_match(iou, gt_care, det_care, thr):
    """The official nested-loop greedy pairing (text_eval_script.py:378-385):
    scan gt-major, take the first unmatched det with IoU > thr."""
    gt_used = np.zeros(iou.shape[0], bool)
    det_used = np.zeros(iou.shape[1], bool)
    pairs = []
    for g in range(iou.shape[0]):
        for d in range(iou.shape[1]):
            if gt_used[g] or det_used[d] or not gt_care[g] or not det_care[d]:
                continue
            if iou[g, d] > thr:
                gt_used[g] = det_used[d] = True
                pairs.append((g, d))
                break
    return pairs


def evaluate_image_spotting(
    per_image,  # iterable of (gt_polys, gt_texts, pred_polys, pred_texts)
    iou_threshold: float = 0.5,
    area_precision_threshold: float = 0.5,
    word_spotting: bool = True,
    lexicon: Optional[Sequence[str]] = None,
    min_length_care_word: int = 3,
) -> Dict[str, float]:
    """Score image text spotting with the official scorer's semantics.

    Returns the micro-averaged E2E_RESULTS (``e2e_*``) and
    DETECTION_ONLY_RESULTS (``det_*``) triples of
    text_eval_script.py:456-466. ``lexicon`` applies the TextEvaluator's
    pre-scoring correction to every predicted word.
    """
    matched = det_only_matched = 0
    num_gt = num_det = det_only_gt = det_only_det = 0
    for gt_polys, gt_texts, pred_polys, pred_texts in per_image:
        gt_care = np.ones(len(gt_polys), bool)
        gt_norm = list(gt_texts)
        for i, t in enumerate(gt_texts):
            if t == "###":
                gt_care[i] = False
            elif word_spotting:
                if not include_in_dictionary(t, min_length_care_word):
                    gt_care[i] = False
                else:
                    gt_norm[i] = include_in_dictionary_transcription(t)
        texts = [
            lexicon_correct(t, lexicon) if lexicon else t for t in pred_texts
        ]
        det_care = np.ones(len(pred_polys), bool)
        dc_idx = np.flatnonzero(~gt_care)
        for j, dp in enumerate(pred_polys):
            for i in dc_idx:
                if intersection_over_det(np.asarray(dp, np.float64),
                                         np.asarray(gt_polys[i], np.float64)
                                         ) > area_precision_threshold:
                    det_care[j] = False
                    break
        iou = (
            poly_iou_matrix(gt_polys, pred_polys)
            if len(gt_polys) and len(pred_polys)
            else np.zeros((len(gt_polys), len(pred_polys)))
        )
        for g, d in _greedy_match(iou, gt_care, det_care, iou_threshold):
            if word_spotting:
                ok = gt_norm[g].upper() == texts[d].upper()
            else:
                ok = transcription_match(gt_norm[g].upper(), texts[d].upper())
            matched += int(ok)
        # detection-only companion: this fork populates NO don't-care lists
        # (text_eval_script.py:296-297 commented out), so '###' counts too
        all_care = np.ones(max(len(gt_polys), len(pred_polys)), bool)
        det_only_matched += len(
            _greedy_match(iou, all_care[: len(gt_polys)],
                          all_care[: len(pred_polys)], iou_threshold)
        )
        num_gt += int(gt_care.sum())
        num_det += int(det_care.sum())
        det_only_gt += len(gt_polys)
        det_only_det += len(pred_polys)

    def _prh(m, ng, nd):
        r = 0.0 if ng == 0 else m / ng
        p = 0.0 if nd == 0 else m / nd
        h = 0.0 if p + r == 0 else 2 * p * r / (p + r)
        return p, r, h

    p, r, h = _prh(matched, num_gt, num_det)
    dp_, dr, dh = _prh(det_only_matched, det_only_gt, det_only_det)
    return {
        "det_precision": dp_,
        "det_recall": dr,
        "det_hmean": dh,
        "e2e_precision": p,
        "e2e_recall": r,
        "e2e_hmean": h,
    }
