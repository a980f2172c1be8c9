"""BOVText SampleRecovery: sampled-frame annotations -> per-frame annotations (the
port's copy of the repository's tools/bovtext_sample_recovery.py).

Faithful reimplementation of the reference preprocessing pipeline
(tools/Evaluation_Protocol_BOV_Text/Task2_VideoTextSpotting/utils/
SampleRecovery/SampleRecoveryPart6.py) that turns BOVText's sampled GT (one
annotated frame every ~10) into per-frame GT:

  1. cluster sampled annotations into text tracks by convex-quad IoU +
     transcription edit-similarity with the reference's class-conditional
     thresholds and its 5 < frame-gap < 15 linking window (:217-295);
  2. smooth each track: point-order revision via the max-|area| vertex
     permutation + CCW correction (:23-107), pairwise shorter-transcription
     propagation (:418-443);
  3. recover per-frame annotations: linear midframe interpolation between
     consecutive sampled entries (:494-664, including the reference's
     uniform-gap insertion indexing), and start/end extension by tracking the
     grayscale crop with the extrapolated box while the mean L2 distance stays
     under 50, at most 7 frames each way (:666-840);
  4. emit one ':'-separated txt per frame (x1:y1:...:y4:content:class, track id
     = cluster id) exactly like Cluster2Frames/write_4points (:871-904,:170-177).

Algorithmic quirks of the reference are preserved on purpose: the repository's
tools/bovtext_sample_recovery.py is cross-validated by running SampleRecoveryPart6
verbatim, and this copy (on the port's own evaluation modules) writes its files byte for
byte.

Usage:
  python -m gomatching_tpu_torch.tools.bovtext_sample_recovery --sample-anno <dir> \
      --frames <dir> --out <dir>
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Dict, List

import numpy as np

from ..evaluation.mot_metrics import _ccw, _clip_poly, _poly_area, convex_hull, levenshtein

BACKGROUND = "背景文字"  # '背景文字'


# ---------------------------------------------------------------------------
# geometry (reference: Polygon2 convex hulls, :191-216; SortPoint :18-107)
# ---------------------------------------------------------------------------
def _quad_iou(b1, b2) -> float:
    """calculate_iou: convex hulls of the (reordered) quads."""

    def hullify(b):
        pts = np.asarray(
            [[b[0], b[1]], [b[6], b[7]], [b[4], b[5]], [b[2], b[3]]], np.float64
        )
        return convex_hull(pts)

    p1, p2 = hullify(b1), hullify(b2)
    if len(p1) < 3 or len(p2) < 3:
        return 0.0
    a1, a2 = _poly_area(p1), _poly_area(p2)
    if a1 < 0.01 or a2 < 0.01:
        return 0.0
    inter = _ccw(p1)
    clip = _ccw(p2)
    for i in range(len(clip)):
        inter = _clip_poly(inter, clip[i], clip[(i + 1) % len(clip)])
        if len(inter) == 0:
            return 0.0
    ai = _poly_area(inter)
    return ai / (a1 + a2 - ai)


def _signed_area(poly) -> float:
    """SortPoint.polygon_area (:63-76): positive for clockwise order."""
    e = 0.0
    for i in range(4):
        j = (i + 1) % 4
        e += (poly[j][0] - poly[i][0]) * (poly[j][1] + poly[i][1])
    return e / 2.0


def revise_point_seq_by_area(poly: np.ndarray) -> np.ndarray:
    """Pick the vertex permutation with the largest |area|, then start from the
    min-(x+y) corner (:23-61)."""
    poly = np.asarray(poly)
    perms = [
        poly,
        poly[(0, 1, 3, 2), :],
        poly[(0, 2, 3, 1), :],
        poly[(0, 2, 1, 3), :],
        poly[(0, 3, 1, 2), :],
        poly[(0, 3, 2, 1), :],
    ]
    areas = [abs(_signed_area(p)) for p in perms]
    box = perms[int(np.argmax(areas))]
    start = int(np.argmin([x + y for x, y in box]))
    return box[(start, (start + 1) % 4, (start + 2) % 4, (start + 3) % 4), :]


def check_and_validate_poly(poly: np.ndarray):
    """Drop degenerate quads; flip counter-clockwise ones (:78-107)."""
    area = _signed_area(poly)
    if abs(area) < 1:
        return []
    if area > 0:
        poly = poly[(0, 3, 2, 1), :]
    return poly


# ---------------------------------------------------------------------------
# io (:155-189)
# ---------------------------------------------------------------------------
def load_4points(path) -> List[List]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            data = line.strip("\n").split(":")
            if len(data) != 10 or data[8] == "#1":
                continue
            out.append(data)
    return out


def write_4points(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(":".join(str(e) for e in row) + "\n")


# ---------------------------------------------------------------------------
# clustering (:217-338)
# ---------------------------------------------------------------------------
def _try_link(frame_id, obj_id, clusters, data, t_iou=0.2, t_sim=0.3) -> bool:
    if len(clusters) == 1:  # only 'cluster_num' yet
        return False
    new_data = copy.deepcopy(data) + [obj_id, frame_id]
    cur_box = data[:8]
    cur_content = data[8]
    cur_cls = data[9]
    max_iou = max_sim = max_iou_sim = max_sim_iou = 0.0
    key_by_iou = key_by_sim = 0
    for key, c in clusters.items():
        if key == "cluster_num":
            continue
        center = c["cluster_center"]
        if not 5 < (frame_id - int(c["end_frame_id"])) < 15:
            continue
        iou = _quad_iou([float(x) for x in center[:8]], [float(x) for x in cur_box])
        d = levenshtein(str(center[8]), str(cur_content))
        sim = 1.0 - (d * 2) / (len(str(center[8])) + len(str(cur_content)))
        if iou > max_iou:
            max_iou, max_sim_iou, key_by_iou = iou, sim, key
        if sim > max_sim:
            max_sim, max_iou_sim, key_by_sim = sim, iou, key

    if cur_cls == BACKGROUND:
        if max_iou > t_iou:
            key = key_by_iou
        elif max_sim > t_sim and max_iou_sim > 0.005:
            key = key_by_sim
        else:
            return False
    else:
        if max_iou > 0.5 and max_sim_iou > 0.5:
            key = key_by_iou
        elif max_sim > 0.98 and max_iou_sim > 0.005:
            key = key_by_sim
        else:
            return False
    clusters[key]["cluster_center"] = new_data
    clusters[key]["end_frame_id"] = frame_id
    clusters[key]["element_list"].append(new_data)
    return True


def _new_cluster(frame_id, obj_id, clusters, data):
    new_data = copy.deepcopy(data) + [obj_id, frame_id]
    cid = clusters["cluster_num"] + 1
    clusters[cid] = {
        "cluster_center": new_data,
        "start_frame_id": frame_id,
        "end_frame_id": frame_id,
        "element_list": [new_data],
    }
    clusters["cluster_num"] = cid


# ---------------------------------------------------------------------------
# smoothing (:366-492)
# ---------------------------------------------------------------------------
def _revise_points(rows):
    out = []
    for row in rows:
        x = row[:8]
        content = row[8]
        if content in ("#1", "#nuII"):
            continue
        poly = np.asarray(
            [[x[0], x[1]], [x[2], x[3]], [x[4], x[5]], [x[6], x[7]]], np.float64
        ).astype(np.int64)
        poly = revise_point_seq_by_area(poly)
        poly = check_and_validate_poly(poly)
        if len(poly) == 0:
            continue
        coords = [str(int(v)) for p in poly for v in p]
        out.append(coords + row[8:])
    return out


def _revise_content(rows):
    if len(rows) <= 1:
        return rows
    for i in range(len(rows) - 1):
        # shorter transcription wins, propagated pairwise (:425-429)
        if len(rows[i][8]) < len(rows[i + 1][8]):
            rows[i + 1][8] = rows[i][8]
        else:
            rows[i][8] = rows[i + 1][8]
    return rows


# ---------------------------------------------------------------------------
# per-frame recovery (:494-840)
# ---------------------------------------------------------------------------
def _insert_pair(d1, d2):
    a = [int(float(e)) for e in (d1[:8] + [d1[10], d1[11]])]
    b = [int(float(e)) for e in (d2[:8] + [d2[10], d2[11]])]
    num = abs(b[9] - a[9])
    steps = [(b[i] - a[i]) / num for i in range(8)]
    rows = []
    for idx in range(1, num):
        coords = [round(a[i] + steps[i] * idx) for i in range(8)]
        row = [str(c) for c in coords] + [str(d1[8]), str(d1[9]), a[8], a[9] + idx]
        rows.append(row)
    return rows, num


def _complement_medium(rows):
    if len(rows) < 1:
        return rows
    out = copy.deepcopy(rows)
    for idx in range(len(rows) - 1):
        ins, num = _insert_pair(rows[idx], rows[idx + 1])
        for jdx in range(num - 1):
            # the reference's uniform-gap insertion indexing (:659-662),
            # preserved verbatim (slightly misplaces rows for non-uniform gaps)
            out.insert(num * idx + (jdx + 1), ins[jdx])
    return out


def _extract_crop(box, gray):
    x = [int(e) for e in box]
    # the reference reuses x3 for the 4th x (:568-571); preserved
    min_x, max_x = min(x[0], x[2], x[4], x[4]), max(x[0], x[2], x[4], x[4])
    min_y, max_y = min(x[1], x[3], x[5], x[7]), max(x[1], x[3], x[5], x[7])
    return gray[min_y:max_y, min_x:max_x]


def _l2(img1, img2) -> float:
    import cv2

    h, w = img1.shape[:2]
    if h < 8 or w < 8:
        return 100.0
    img2 = cv2.resize(img2, (w, h))
    return float(np.sum(np.square(img1 - img2)) / (h * w))


def _offset(d1, d2):
    a = [int(float(e)) for e in d1[:8]] + [int(d1[11])]
    b = [int(float(e)) for e in d2[:8]] + [int(d2[11])]
    num = abs(b[8] - a[8])
    return [(b[i] - a[i]) / num for i in range(8)]


def _shift_box(box, offset, sign):
    return [max(int(e) + sign * s, 1) for e, s in zip(box, offset)]


def _complement_start_end(rows, frame_paths: Dict[int, str], tl2=50):
    import cv2

    if len(rows) < 1:
        return rows
    out = copy.deepcopy(rows)
    num_frame = len(frame_paths)
    single = len(rows) == 1
    off_start = None if single else _offset(rows[0], rows[1])
    off_end = None if single else _offset(rows[-2], rows[-1])

    for direction, anchor, off in ((-1, rows[0], off_start), (1, rows[-1], off_end)):
        content, cls, obj_id = anchor[8], anchor[9], anchor[10]
        frame_id = int(anchor[11])
        box = [int(float(e)) for e in anchor[:8]]
        frame = cv2.imread(frame_paths[frame_id])
        crop = _extract_crop(box, cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        comp = 0
        while comp < 7:
            if (direction < 0 and frame_id == 1) or (
                direction > 0 and frame_id == num_frame
            ):
                break
            nxt = frame_id + direction
            nframe = cv2.imread(frame_paths[nxt])
            nbox = box if single else _shift_box(box, off, direction)
            ncrop = _extract_crop(nbox, cv2.cvtColor(nframe, cv2.COLOR_BGR2GRAY))
            try:
                d = _l2(crop, ncrop)
            except Exception:
                d = 0
            if d >= tl2:
                break
            frame_id, box, crop = nxt, nbox, ncrop
            row = [int(e) for e in box] + [content, cls, obj_id, nxt]
            if direction < 0:
                out.insert(0, row)
            else:
                out.append(row)
            comp += 1
    return out


# ---------------------------------------------------------------------------
def recover_video(sample_anno_dir: str, frames_dir: str, out_dir: str) -> Dict[int, List]:
    """Full pipeline for one video; writes per-frame txts under out_dir and
    returns {frame_id: [rows]} (RecoveryVideoAnnotations + Cluster2Frames)."""
    # frame id = the LAST underscore token (real BOVText video names contain
    # underscores); process in numeric frame order — the official script
    # inherits filesystem order, which on the authors' machines was creation
    # (= frame) order, and its cluster linking depends on it
    def _fid(path):
        return int(os.path.splitext(os.path.basename(path))[0].split("_")[-1])

    txts = sorted(
        (
            os.path.join(sample_anno_dir, f)
            for f in os.listdir(sample_anno_dir)
            if f.endswith(".txt")
        ),
        key=_fid,
    )
    clusters: Dict = {"cluster_num": 0}
    for path in txts:
        frame_id = _fid(path)
        for obj_id, data in enumerate(load_4points(path)):
            if not _try_link(frame_id, obj_id, clusters, data):
                _new_cluster(frame_id, obj_id, clusters, data)

    frame_files = sorted(
        f for f in os.listdir(frames_dir) if f.endswith(".jpg")
    )
    frame_paths = {
        int(os.path.splitext(f)[0].split("_")[-1]): os.path.join(frames_dir, f)
        for f in frame_files
    }

    for cid, c in clusters.items():
        if cid == "cluster_num":
            continue
        rows = _revise_points(c["element_list"])
        rows = _revise_content(rows)
        rows = _complement_medium(rows)
        rows = _complement_start_end(rows, frame_paths)
        c["element_list"] = rows

    frames_gt: Dict[int, List] = {i: [] for i in range(1, len(frame_files) + 1)}
    for cid, c in clusters.items():
        if cid == "cluster_num":
            continue
        for row in c["element_list"]:
            row[-2] = cid
            frames_gt[row[-1]].append(row)

    video = os.path.basename(os.path.normpath(frames_dir))
    os.makedirs(out_dir, exist_ok=True)
    for frame_idx, rows in frames_gt.items():
        write_4points(
            os.path.join(out_dir, f"{video}_{frame_idx:06d}.txt"), rows
        )
    return frames_gt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sample-anno", required=True,
                    help="dir of sampled GT txts (<video>_<frameid>.txt)")
    ap.add_argument("--frames", required=True,
                    help="dir of video frames (<video>_NNNNNN.jpg)")
    ap.add_argument("--out", required=True, help="output dir for per-frame GT txts")
    args = ap.parse_args()
    frames_gt = recover_video(args.sample_anno, args.frames, args.out)
    n = sum(len(v) for v in frames_gt.values())
    print(f"wrote {len(frames_gt)} frame files, {n} annotations -> {args.out}")


if __name__ == "__main__":
    main()
