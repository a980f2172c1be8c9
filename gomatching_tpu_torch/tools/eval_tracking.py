"""Offline tracking / end-to-end spotting evaluation on ICDAR-style XML results (the
port's copy of the repository's tools/eval_tracking.py, on the port's own evaluation
modules; same flags, routes and printed summary).

Native replacement for the reference protocol scripts
(tools/Evaluation_Protocol_{DSText,ArtVideo,...}/): scores res_*.xml predictions
against GT XML with CLEAR-MOT metrics (MOTA/MOTP/IDF1/IDSW/MT/PT/ML). With
--e2e, a hypothesis additionally must match the GT transcription
(case-insensitive) to count, mirroring the E2E spotting protocol
(E2E_video_2_0.py). GT boxes with transcription '###' (ignore regions) are
removed along with hypotheses that overlap them, per the RRC convention.

Usage:
  python -m gomatching_tpu_torch.tools.eval_tracking --gt <gt_xml_dir> --res <pred_xml_dir> \
      [--e2e] [--det] [--curve] [--bovtext] [--iou 0.5] [--text-sim 1.0]
"""

from __future__ import annotations

import argparse
import os
import xml.etree.cElementTree as ET

import numpy as np

from ..evaluation.mot_metrics import (
    MOTAccumulator,
    evaluate_detection,
    intersection_over_det,
    poly_iou_matrix,
)


def parse_xml(path, only_curve: bool = False, int_coords: bool = False):
    """-> {frame_id: (ids, [flat polygon arrays], transcriptions)}.

    Polygons keep their native vertex count (quads for ICDAR15/DSText,
    arbitrary for ArTVideo curved text). With ``only_curve``, straight GT
    instances (attribute Type/text_type == 'Straight', or plain quads when the
    attribute is absent) become ignore regions, mirroring the ArTVideo --curve
    protocol (eval_trk.py:170-175)."""
    root = ET.parse(path).getroot()
    frames = {}
    for fr in root:
        ids, polys, txts = [], [], []
        for obj in fr:
            if int_coords:  # official parse: max(0, int(x)) (Track_video_2_0.py:183-184)
                pts = [(max(0, int(float(p.attrib["x"]))), max(0, int(float(p.attrib["y"]))))
                       for p in obj]
            else:
                pts = [(float(p.attrib["x"]), float(p.attrib["y"])) for p in obj]
            if len(pts) < 3:
                continue
            ids.append(int(obj.attrib["ID"]))
            polys.append(np.asarray(pts, np.float64).reshape(-1))
            txt = obj.attrib.get("Transcription", "")
            if only_curve:
                ttype = obj.attrib.get("Type", obj.attrib.get("text_type", ""))
                straight = ttype == "Straight" if ttype else len(pts) == 4
                if straight:
                    txt = "###"  # treated as an ignore region downstream
            txts.append(txt)
        frames[int(fr.attrib["ID"])] = (ids, polys, txts)
    return frames


def parse_artvideo_json(path, only_curve: bool = False):
    """ArTVideo GT json ({'frame': [...], 'annotations': [{frame_id, obj_id,
    point, text_type, transcription?}]}) -> same frames dict as parse_xml.

    Matching uses polygon IoU on 'point' (the reference decodes RLE masks,
    eval_trk.py:92-118; for text polygons the two coincide up to rasterization).
    With ``only_curve``, Straight instances become ignore regions
    (eval_trk.py:170-175)."""
    import json as _json

    with open(path, encoding="utf-8") as f:
        data = _json.load(f)
    frames = {}
    for ann in data.get("annotations", []):
        fid = int(ann["frame_id"])
        ids, polys, txts = frames.setdefault(fid, ([], [], []))
        pts = np.asarray(ann["point"], np.float64).reshape(-1)
        if pts.size < 6:
            continue
        ids.append(int(ann["obj_id"]))
        polys.append(pts)
        txt = ann.get("transcription", "")
        if only_curve and ann.get("text_type", "") == "Straight":
            txt = "###"
        txts.append(txt)
    # frames with no annotations still count (misses are per-GT, so empty ok)
    for i in range(1, len(data.get("frame", [])) + 1):
        frames.setdefault(i, ([], [], []))
    return frames


def parse_artvideo_json_full(path):
    """ArTVideo GT json -> ((img_h, img_w), n_frames, {frame_id: [ann dicts]}).

    Keeps everything the official scorers touch (eval_trk.py:132-155 /
    eval_e2e.py:135-155): int32-cast points, the decoded RLE mask (or a
    cv2-rasterized fallback when 'segmentation' is absent), obj id, text_type
    and transcription."""
    import json as _json

    import cv2

    from ..evaluation.rle import decode as rle_decode

    with open(path, encoding="utf-8") as f:
        data = _json.load(f)
    img_h = data["frame"][0]["height"]
    img_w = data["frame"][0]["width"]
    n_frames = len(data["frame"])
    frames = {}
    for ann in data.get("annotations", []):
        fid = int(ann["frame_id"])
        pts = np.array(ann["point"], dtype=np.float32).astype(np.int32).reshape(-1)
        if "segmentation" in ann:
            mask = rle_decode(ann["segmentation"])
        else:
            mask = np.zeros((img_h, img_w), np.uint8)
            cv2.fillPoly(mask, [pts.reshape(-1, 2)], 1)
        frames.setdefault(fid, []).append(
            {
                "points": pts,
                "mask": mask,
                "ID": int(ann["obj_id"]),
                "text_type": ann.get("text_type", ""),
                "transcription": ann.get("Transcription", ann.get("transcription", "")),
            }
        )
    return (img_h, img_w), n_frames, frames


def _artvideo_mask_iou(m1, m2):
    """Official rasterized mask IoU (eval_trk.py:92-99)."""
    import cv2

    inter = int(cv2.bitwise_and(m1, m2).sum())
    if inter < 1:
        return 0.0
    return inter / int(cv2.bitwise_or(m1, m2).sum())


def _artvideo_similarity(a: str, b: str) -> float:
    """cal_similarity (eval_trk.py:66-72) == the BOVText rule: delegate to the
    library's ``bovtext_similarity`` (same clean charset, empty==empty -> 1,
    edit distance 1 -> 0.95, else 1 - dist/maxlen) instead of carrying a
    drift-prone second copy."""
    from ..evaluation.mot_metrics import bovtext_similarity

    return bovtext_similarity(a, b)


def evaluate_video_artvideo(gt_path, res_frames, iou_threshold=0.5, e2e=False,
                            only_curve=False):
    """One video under the OFFICIAL ArTVideo protocol (eval_trk.py /
    eval_e2e.py): rasterized mask IoU, dist=IoU fed to the (minimizing)
    accumulator, ignore regions = Straight text under --curve (tracking) plus
    '###'/'#1' transcriptions (e2e), prediction pre-filter by mask overlap
    with ignores, and the cal_similarity>=0.9 transcription gate (e2e).

    ``res_frames``: {frame_id: (ids, [flat polygons], transcriptions)} — our
    writer's XML parse; polygons are rasterized exactly like the official
    points branch (eval_trk.py:236-239)."""
    import cv2

    (img_h, img_w), n_frames, gt_frames = parse_artvideo_json_full(gt_path)
    acc = MOTAccumulator(iou_threshold=iou_threshold, match_lowest_iou=True)
    for frame_id in range(1, n_frames + 1):
        gts, ignored = [], []
        for gt in gt_frames.get(frame_id, []):
            if e2e:
                ign = gt["transcription"] in ("###", "#1") or (
                    only_curve and gt["text_type"] == "Straight"
                )
            else:
                ign = only_curve and gt["text_type"] == "Straight"
            (ignored if ign else gts).append(gt)

        h_ids, h_masks, h_txts = [], [], []
        ids, polys, txts = res_frames.get(frame_id, ([], [], []))
        for hid, poly, txt in zip(ids, polys, txts):
            pts = np.array(poly, dtype=np.float32).astype(np.int32).reshape(-1, 2)
            mask = np.zeros((img_h, img_w), np.uint8)
            cv2.fillPoly(mask, [pts], 1)
            if any(_artvideo_mask_iou(mask, ig["mask"]) > iou_threshold for ig in ignored):
                continue
            h_ids.append(hid)
            h_masks.append(mask)
            h_txts.append(txt)

        G, H = len(gts), len(h_ids)
        iou = np.zeros((G, H))
        for i, gt in enumerate(gts):
            for j in range(H):
                v = _artvideo_mask_iou(gt["mask"], h_masks[j])
                if v < iou_threshold:
                    v = 0.0  # official NaN == unmatchable
                elif e2e and _artvideo_similarity(
                    gt["transcription"], h_txts[j]
                ) < 0.9:
                    v = 0.0
                iou[i, j] = v
        acc.update([g["ID"] for g in gts], None, list(h_ids), None, iou_matrix=iou)
    return acc


def parse_track_texts(path):
    """'"ID","Transcription"' lines (the official per-track txt format,
    E2E_video_2_0.py:205-219 / our writer.write_track_transcriptions)."""
    import re as _re

    out = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = _re.match(r'^"([0-9]+)","(.*)"$', line)
            if m:
                out[int(m.group(1))] = m.group(2)
    return out


def evaluate_video_icdar(gt_frames, res_frames, iou_threshold=0.5, e2e=False,
                         gt_track_texts=None, det_track_texts=None):
    """One video under the OFFICIAL ICDAR15-video / DSText protocol
    (Track_video_2_0.py:133-330, E2E_video_2_0.py:180-380):

      - coordinates int-cast and clamped >= 0 (caller's parse does this);
      - GT whose per-frame Transcription contains '#' — or, in e2e mode, whose
        track id is absent from the GT track-transcription txt — is don't-care;
      - detections with intersection/det_area > 0.5 against any don't-care
        region are removed (overlapping_fn);
      - a (gt, det) pair is matchable iff IoU > threshold STRICTLY and (e2e)
        the det TRACK transcription .upper() equals the GT track transcription
        normalized to [chinese|alnum].upper();
      - a video with zero surviving detections scores all-zero metrics.

    Returns the per-video metrics dict (+ 'MOTAN').
    """
    n_det = 0
    acc = MOTAccumulator(iou_threshold=iou_threshold, strict_threshold=True,
                         text_rule="icdar" if e2e else "sim")
    gt_track_texts = gt_track_texts or {}
    det_track_texts = det_track_texts or {}
    pending = []
    for frame in sorted(gt_frames):
        g_ids, g_polys, g_txts = gt_frames[frame]
        h_ids, h_polys, h_txts = res_frames.get(frame, ([], [], []))
        dc = []
        keep_g = []
        for i, (gid, t) in enumerate(zip(g_ids, g_txts)):
            if "#" in t or (e2e and gid not in gt_track_texts):
                dc.append(g_polys[i])
            else:
                keep_g.append(i)
        keep_h = []
        for j in range(len(h_ids)):
            if any(intersection_over_det(h_polys[j], d) > 0.5 for d in dc):
                continue
            keep_h.append(j)
        n_det += len(keep_h)
        texts = None
        if e2e:
            texts = (
                [gt_track_texts.get(g_ids[i], "") for i in keep_g],
                [det_track_texts.get(h_ids[j], "") for j in keep_h],
            )
        pending.append((
            [g_ids[i] for i in keep_g], [g_polys[i] for i in keep_g],
            [h_ids[j] for j in keep_h], [h_polys[j] for j in keep_h], texts,
        ))
    # same key set as the normal MOTAccumulator.metrics() path + MOTAN, so
    # aggregation over videos never KeyErrors on the zero-detection branch
    zeros = {"MOTA": 0.0, "MOTP": 0.0, "IDF1": 0.0, "IDP": 0.0, "IDR": 0.0,
             "IDSW": 0, "FP": 0, "FN": 0, "MT": 0, "PT": 0, "ML": 0,
             "precision": 0.0, "recall": 0.0, "num_gt": 0, "MOTAN": 0.0}
    if n_det == 0:  # 'Motmetrics fails if no detection...' — official zero row
        return zeros
    for g_ids, g_polys, h_ids, h_polys, texts in pending:
        acc.update(g_ids, g_polys, h_ids, h_polys, texts=texts)
    m = acc.metrics()
    pr, ob = acc.num_hyp, acc.num_gt
    m["MOTAN"] = (
        0.0 if pr == 0 or ob == 0
        else 0.5 * (m["FP"] + m["IDSW"]) / pr + 0.5 * m["FN"] / ob
    )
    return m


def parse_bovtext_json(path):
    """BOVText per-video json: {frame_id: [{points(8), ID, transcription}]}
    (Task1/tracking_utils/io.py read_text_results). Returns the same frame->
    (ids, polys, texts) dict shape as parse_xml."""
    import json as _json

    with open(path, encoding="utf-8") as f:
        data = _json.load(f)
    frames = {}
    for fid, objs in data.items():
        ids, polys, txts = [], [], []
        for o in objs:
            ids.append(int(o["ID"]))
            polys.append(np.asarray(o["points"], np.float64).reshape(4, 2))
            # Task2 GT carries the track-level text as ID_transcription
            # (Task2 evaluation.py:192-197); predictions use 'transcription'
            txts.append(str(o.get("ID_transcription", o.get("transcription", ""))))
        frames[int(fid)] = (ids, polys, txts)
    return frames


def evaluate_video(gt_frames, res_frames, iou_threshold=0.5, e2e=False, text_sim=1.0,
                   match_lowest_iou=False, text_rule="sim"):
    acc = MOTAccumulator(iou_threshold=iou_threshold, text_sim_threshold=text_sim,
                         match_lowest_iou=match_lowest_iou, text_rule=text_rule)
    for frame in sorted(gt_frames):
        g_ids, g_polys, g_txts = gt_frames[frame]
        h_ids, h_polys, h_txts = res_frames.get(frame, ([], [], []))

        # drop ignore regions + hypotheses overlapping them
        keep_g = [i for i, t in enumerate(g_txts) if t != "###" and t.lower() != "#1"]
        ign_g = [i for i in range(len(g_ids)) if i not in keep_g]
        if ign_g and len(h_ids):
            iou_ign = poly_iou_matrix([g_polys[i] for i in ign_g], h_polys)
            keep_h = [j for j in range(len(h_ids)) if iou_ign[:, j].max(initial=0.0) < iou_threshold]
        else:
            keep_h = list(range(len(h_ids)))

        g_ids2 = [g_ids[i] for i in keep_g]
        g_quads2 = [g_polys[i] for i in keep_g]
        h_ids2 = [h_ids[j] for j in keep_h]
        h_quads2 = [h_polys[j] for j in keep_h]

        texts = None
        if e2e:
            texts = (
                [g_txts[i].lower() for i in keep_g],
                [h_txts[j].lower() for j in keep_h],
            )
        acc.update(g_ids2, g_quads2, h_ids2, h_quads2, texts=texts)
    return acc


def _merge_into(totals, acc, video):
    """Merge one video's accumulator into the cross-video totals (per-video id
    namespaces are kept distinct by scoping keys with the video name)."""
    for f in (
        "num_gt", "num_hyp", "num_matches", "num_switches", "num_fp", "num_misses"
    ):
        setattr(totals, f, getattr(totals, f) + getattr(acc, f))
    totals.total_overlap += acc.total_overlap
    for d_name in ("gt_frames", "hyp_frames", "pair_overlap", "gt_matched_frames"):
        dst = getattr(totals, d_name)
        for k, v in getattr(acc, d_name).items():
            kk = (video, k) if not isinstance(k, tuple) else (video, k[0], k[1])
            dst[kk] = v


def _fix_pair_keys(totals):
    # rebuild pair_overlap into the ((video,gt),(video,hyp)) tuple-key form
    fixed = {}
    for k, v in totals.pair_overlap.items():
        fixed[((k[0], k[1]), (k[0], k[2]))] = v
    totals.pair_overlap = fixed


def _print_summary(per_video, totals):
    _fix_pair_keys(totals)
    m = totals.metrics()
    print(f"{'video':<28} {'MOTA':>7} {'MOTP':>7} {'IDF1':>7} {'IDSW':>5} {'FP':>6} {'FN':>6}")
    for v, mm in per_video.items():
        print(
            f"{v:<28} {mm['MOTA'] * 100:>6.2f}% {mm['MOTP'] * 100:>6.2f}% "
            f"{mm['IDF1'] * 100:>6.2f}% {mm['IDSW']:>5} {mm['FP']:>6} {mm['FN']:>6}"
        )
    print("-" * 70)
    print(
        f"{'OVERALL':<28} {m['MOTA'] * 100:>6.2f}% {m['MOTP'] * 100:>6.2f}% "
        f"{m['IDF1'] * 100:>6.2f}% {m['IDSW']:>5} {m['FP']:>6} {m['FN']:>6}"
    )
    return m


def bovtext_main(args):
    """BOVText Task1 (tracking) / Task2 (--e2e spotting) scoring
    (Evaluation_Protocol_BOV_Text/*/evaluation.py parity: per-video
    accumulators, dist = IoU with 0.5 threshold, ignore filtering, OVERALL =
    merged accumulators)."""
    totals = MOTAccumulator(iou_threshold=args.iou)
    per_video = {}
    gt_files = []
    for cls in sorted(os.listdir(args.gt)):
        cls_dir = os.path.join(args.gt, cls)
        if os.path.isdir(cls_dir):
            for v in sorted(os.listdir(cls_dir)):
                if v.endswith(".json"):
                    gt_files.append((v[:-5], os.path.join(cls_dir, v)))
        elif cls.endswith(".json"):
            gt_files.append((cls[:-5], os.path.join(args.gt, cls)))
    for video, gt_path in gt_files:
        gt_frames = parse_bovtext_json(gt_path)
        res_path = os.path.join(args.res, f"{video}.json")
        res_frames = parse_bovtext_json(res_path) if os.path.exists(res_path) else {}
        acc = evaluate_video(
            gt_frames, res_frames, args.iou, args.e2e,
            text_sim=0.9 if args.e2e else 1.0,
            match_lowest_iou=True, text_rule="bovtext",
        )
        per_video[video] = acc.metrics()
        _merge_into(totals, acc, video)
    return _print_summary(per_video, totals)


def main(argv=None):
    """Score, print the summary, and return the overall metrics: the merged
    accumulator's (BOVText, ArTVideo), the macro averages and summed counts (ICDAR15 /
    DSText XML), or precision / recall / hmean (``--det``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt", required=True, help="directory of GT xml (one per video)")
    ap.add_argument("--res", required=True, help="directory of res_*.xml predictions")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--e2e", action="store_true", help="require transcription match")
    ap.add_argument(
        "--text-sim",
        type=float,
        default=1.0,
        help="e2e transcription similarity threshold (1.0 = exact; BOVText uses ~0.8)",
    )
    ap.add_argument(
        "--det",
        action="store_true",
        help="frame-level detection protocol (precision/recall/hmean), ignoring ids",
    )
    ap.add_argument(
        "--curve",
        action="store_true",
        help="ArTVideo curved-text-only protocol: straight GT becomes don't-care",
    )
    ap.add_argument(
        "--bovtext",
        action="store_true",
        help="BOVText protocol: GT tree <gt>/<Cls*>/<video>.json, results "
        "<res>/<video>.json, dist=IoU matching, '###'/'#1' ignore regions, "
        "and (with --e2e) the official cal_similarity>=0.9 transcription gate",
    )
    args = ap.parse_args(argv)
    if args.bovtext:
        return bovtext_main(args)

    totals = MOTAccumulator(iou_threshold=args.iou)
    per_video = {}
    det_frames = []
    icdar_mode = False  # any XML-GT video routes through the ICDAR protocol
    for name in sorted(os.listdir(args.gt)):
        if not name.endswith((".xml", ".json")):
            continue
        video = (
            name.replace(".xml", "").replace(".json", "")
            .replace("gt_", "").replace("GT_", "")
        )
        res_candidates = [
            os.path.join(args.res, f"res_{video}.xml"),
            os.path.join(args.res, name),
        ]
        res_path = next((p for p in res_candidates if os.path.exists(p)), None)
        artvideo = name.endswith(".json")
        if artvideo:  # ArTVideo-style GT
            gt_frames = parse_artvideo_json(os.path.join(args.gt, name), args.curve)
        else:
            gt_frames = parse_xml(os.path.join(args.gt, name), only_curve=args.curve,
                                  int_coords=True)
        res_frames = parse_xml(res_path, int_coords=not artvideo) if res_path else {}
        if args.det:
            for frame in sorted(gt_frames):
                g_ids, g_polys, g_txts = gt_frames[frame]
                _, h_polys, _ = res_frames.get(frame, ([], [], []))
                det_frames.append((g_polys, g_txts, h_polys))
            continue
        if artvideo:
            # ArTVideo's official scorer rasterizes masks and feeds dist = IoU
            # to motmetrics, which then MINIMIZES IoU among valid pairs
            # (eval_trk.py:92-118); cross-validated verbatim in
            # tests/test_artvideo_protocol.py
            acc = evaluate_video_artvideo(
                os.path.join(args.gt, name), res_frames, args.iou, args.e2e,
                only_curve=args.curve,
            )
            per_video[video] = acc.metrics()
            _merge_into(totals, acc, video)
        else:
            # ICDAR15-video / DSText official protocol (Track_video_2_0.py /
            # E2E_video_2_0.py): per-video accumulators, strict IoU > 0.5,
            # '#' + missing-track-text don't-cares, intersection/det-area
            # ignore filtering, track-level transcriptions, macro-averaged
            # MOTA/MOTP/IDF1 over videos
            gt_txt = parse_track_texts(
                os.path.join(args.gt, name).replace(".xml", ".txt")
            ) if args.e2e else None
            det_txt = parse_track_texts(
                res_path.replace(".xml", ".txt")
            ) if (args.e2e and res_path) else None
            per_video[video] = evaluate_video_icdar(
                gt_frames, res_frames, args.iou, args.e2e, gt_txt, det_txt
            )
            icdar_mode = True

    if args.det:
        d = evaluate_detection(det_frames, args.iou)
        print(
            f"precision {d['precision'] * 100:.2f}%  recall {d['recall'] * 100:.2f}%  "
            f"hmean {d['hmean'] * 100:.2f}%  ({d['matched']}/{d['num_det']} det, "
            f"{d['num_gt']} gt)"
        )
        return d

    if icdar_mode:
        # ICDAR/DSText path: the official OVERALL is the MEAN of per-video
        # MOTA/MOTP/IDF1 (Track_video_2_0.py:340-351), counts summed
        n = len(per_video)
        print(f"{'video':<28} {'MOTA':>7} {'MOTP':>7} {'IDF1':>7} {'IDSW':>5} {'FP':>6} {'FN':>6}")
        for v, m in per_video.items():
            print(
                f"{v:<28} {m['MOTA'] * 100:>6.2f}% {m['MOTP'] * 100:>6.2f}% "
                f"{m['IDF1'] * 100:>6.2f}% {m['IDSW']:>5} {m['FP']:>6} {m['FN']:>6}"
            )
        print("-" * 70)
        mota = sum(m["MOTA"] for m in per_video.values()) / n
        motp = sum(m["MOTP"] for m in per_video.values()) / n
        idf1 = sum(m["IDF1"] for m in per_video.values()) / n
        sw = sum(m["IDSW"] for m in per_video.values())
        fp = sum(m["FP"] for m in per_video.values())
        fn = sum(m["FN"] for m in per_video.values())
        print(
            f"{'OVERALL (macro)':<28} {mota * 100:>6.2f}% {motp * 100:>6.2f}% "
            f"{idf1 * 100:>6.2f}% {sw:>5} {fp:>6} {fn:>6}"
        )
        return {"MOTA": mota, "MOTP": motp, "IDF1": idf1, "IDSW": sw, "FP": fp, "FN": fn}
    return _print_summary(per_video, totals)


if __name__ == "__main__":
    main()
