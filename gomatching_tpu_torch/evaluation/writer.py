"""Result serialization: ICDAR-style per-video XML + JSON + per-track transcription.

Byte-format parity with the reference emitters so the offline evaluation protocols
(tools/Evaluation_Protocol_*) consume our outputs unchanged:
  - ``Generate_Json_annotation`` (eval.py:68-110): minidom XML with <Frames><frame
    ID><object ID Transcription><Point x y>*4, and a JSON mirror.
  - per-frame line construction from minAreaRect of the boundary polygon
    (eval.py:346-363).
  - ``getid_text`` (eval.py:182-210): per-track majority-vote transcription .txt.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List
from xml.dom.minidom import Document

import cv2
import numpy as np


def boundary_to_polygon(bd: np.ndarray) -> np.ndarray:
    """(npts, 4) top/bottom boundary points -> closed (2*npts, 2) polygon
    (text_track_visualizer.py:81-84: top points then reversed bottom points)."""
    top, bottom = np.hsplit(bd, 2)
    return np.vstack([top, bottom[::-1]])


def frame_lines(polys, track_ids, texts) -> List[list]:
    """Quadrilateral lines [x1..y4, id, text, seg] per instance via minAreaRect;
    degenerate (<5 px) boxes dropped (eval.py:353-363)."""
    lines = []
    for poly, tid, text in zip(polys, track_ids, texts):
        rect = cv2.minAreaRect(poly.astype(np.float32))
        box = np.array(cv2.boxPoints(rect)).reshape(8)
        coords = [int(v) for v in box]
        xs, ys = coords[0::2], coords[1::2]
        if max(ys) - min(ys) < 5 or max(xs) - min(xs) < 5:
            continue
        seg = [poly.astype(int).tolist()]
        lines.append(coords + [int(tid), text, seg])
    return lines


def write_video_results(annotation: Dict[str, List[list]], json_path: str, xml_path: str):
    """Emit the per-video XML + JSON pair."""
    tracks_json = {}
    doc = Document()
    root = doc.createElement("Frames")
    for frame in annotation.keys():
        doc.appendChild(root)
        fr = doc.createElement("frame")
        fr.setAttribute("ID", str(frame))
        root.appendChild(fr)
        tracks_json[frame] = []
        for line in annotation[frame]:
            if len(line) == 11:
                tracks_json[frame].append(
                    {
                        "points": line[:8],
                        "ID": line[8],
                        "transcription": line[9],
                        "segmentation": line[10],
                    }
                )
            else:
                tracks_json[frame].append(
                    {"points": line[:8], "ID": line[8], "transcription": line[9]}
                )
            obj = doc.createElement("object")
            obj.setAttribute("ID", str(line[8]))
            obj.setAttribute("Transcription", str(line[9]))
            fr.appendChild(obj)
            for i in range(4):
                pt = doc.createElement("Point")
                obj.appendChild(pt)
                pt.setAttribute("x", str(int(line[i * 2])))
                pt.setAttribute("y", str(int(line[i * 2 + 1])))
    with open(json_path, "w", encoding="utf-8") as fp:
        fp.write(json.dumps(tracks_json, ensure_ascii=False, indent=4))
    with open(xml_path, "w") as f:
        f.write(doc.toprettyxml(indent="  "))


def write_track_transcriptions(xml_dir: str):
    """Majority-vote transcription per track id -> res_*.txt next to each XML."""
    import xml.etree.cElementTree as ET

    for name in sorted(os.listdir(xml_dir)):
        if not name.endswith(".xml"):
            continue
        tree = ET.parse(os.path.join(xml_dir, name))
        id_trans: Dict[str, list] = {}
        for frame in tree.getroot():
            for obj in frame:
                tid = obj.attrib["ID"]
                id_trans.setdefault(tid, []).append(obj.attrib["Transcription"])
        ordered = OrderedDict(
            (str(k), id_trans[str(k)]) for k in sorted(int(i) for i in id_trans)
        )
        lines = []
        for tid, txts in ordered.items():
            best = max(txts, key=txts.count)
            lines.append(f'"{tid}","{best}"\n')
        with open(os.path.join(xml_dir, name.replace("xml", "txt")), "w") as f:
            f.writelines(lines)
