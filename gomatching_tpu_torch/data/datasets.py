"""Text-spotting dataset loading, COCO-style JSON with video/instance ids (the port's
own copy of ``gomatching_tpu/data/datasets.py``).

Parity: ``load_video_json`` + ``register_vts_instances``
(gomatching/data/datasets/vts.py:24-233), without the pycocotools dependency (the
JSON is parsed directly). Per annotation we derive:
  - ``texts``: int[25] encoding of the transcription over the 36-char table
    (unknown=36, pad=37; '###'/nonalphanumeric -> [36, pad...]),
  - ``beziers`` (4, 2) centerline control points, ``boundary`` (50, 2),
    ``polyline`` (25, 2) from ``bezier_pts`` or a 4/14-point ``poly``.
Instance ids are remapped to dense 1..K (0 = untracked). ``group_by_video`` groups the
frame records into the videos the clip loader samples.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .bezier import bezier_to_gt, poly14_to_bezier, quad_to_bezier

CTLABELS = {c: i for i, c in enumerate("abcdefghijklmnopqrstuvwxyz0123456789")}

# image-pretraining dataset registrations (adet/data/builtin.py:18-52); the
# *_96voc / Chinese splits ship JSONs with pre-encoded 'rec' arrays, so the
# charset choice lives in the JSON, not the loader (text.py:204-211)
PRETRAIN_SPLITS = {
    "syntext1": ("syntext1/train_images", "syntext1/annotations/train_37voc.json"),
    "syntext2": ("syntext2/train_images", "syntext2/annotations/train_37voc.json"),
    "mlt": ("mlt2017/train_images", "mlt2017/train_37voc.json"),
    "totaltext_train": ("totaltext/train_images", "totaltext/train_37voc.json"),
    "ic13_train": ("ic13/train_images", "ic13/train_37voc.json"),
    "ic15_train": ("ic15/train_images", "ic15/train_37voc.json"),
    "textocr1": ("textocr/train_images", "textocr/train_37voc_1.json"),
    "textocr2": ("textocr/train_images", "textocr/train_37voc_2.json"),
    "syntext1_96voc": ("syntext1/train_images", "syntext1/annotations/train_96voc.json"),
    "syntext2_96voc": ("syntext2/train_images", "syntext2/annotations/train_96voc.json"),
    "mlt_96voc": ("mlt2017/train_images", "mlt2017/train_96voc.json"),
    "totaltext_train_96voc": ("totaltext/train_images", "totaltext/train_96voc.json"),
    "ic13_train_96voc": ("ic13/train_images", "ic13/train_96voc.json"),
    "ic15_train_96voc": ("ic15/train_images", "ic15/train_96voc.json"),
    "ctw1500_train_96voc": ("ctw1500/train_images", "ctw1500/train_96voc.json"),
    "chnsyn_train": ("chnsyntext/syn_130k_images", "chnsyntext/chn_syntext.json"),
    "rects_train": ("ReCTS/ReCTS_train_images", "ReCTS/rects_train.json"),
    "rects_val": ("ReCTS/ReCTS_val_images", "ReCTS/rects_val.json"),
    "lsvt_train": ("LSVT/rename_lsvtimg_train", "LSVT/lsvt_train.json"),
    "art_train": ("ArT/rename_artimg_train", "ArT/art_train.json"),
    "totaltext_test": ("totaltext/test_images", "totaltext/test.json"),
    "ic15_test": ("ic15/test_images", "ic15/test.json"),
    "ctw1500_test": ("ctw1500/test_images", "ctw1500/test.json"),
    "inversetext_test": ("inversetext/test_images", "inversetext/test.json"),
    "rects_test": ("ReCTS/ReCTS_test_images", "ReCTS/rects_test.json"),
}

# name -> (image_root, json_file) relative to the datasets/ dir (vts.py:216-226)
PREDEFINED_SPLITS = {
    "icdar15_train": ("ICDAR15/frame/", "ICDAR15/train.json"),
    "dstext_train": ("DSText/frame/", "DSText/train.json"),
    "artvideo_train": ("ArTVideo/Train/frame/", "ArTVideo/Train/train.json"),
    "bov_train": ("BOVText/frame/", "BOVText/train.json"),
}

_CUSTOM_DATASETS: Dict[str, tuple] = {}


def register_dataset(name: str, image_root: str, json_file: str):
    _CUSTOM_DATASETS[name] = (image_root, json_file)


def resolve_dataset(name: str, datasets_root: str = "datasets"):
    if name in _CUSTOM_DATASETS:
        return _CUSTOM_DATASETS[name]
    if "::" in name:  # ad-hoc "<image_root>::<json_file>" dataset spec
        image_root, json_file = name.split("::", 1)
        return image_root, json_file
    table = PREDEFINED_SPLITS if name in PREDEFINED_SPLITS else PRETRAIN_SPLITS
    image_root, json_file = table[name]
    return os.path.join(datasets_root, image_root), os.path.join(datasets_root, json_file)


def encode_text(transcription, text_category=None, max_len: int = 25, voc_size: int = 37):
    """Transcription string -> int[max_len] (pad = voc_size, unknown = voc_size-1).

    voc 37 lowercases over the 36-char table (vts.py:131-147, the reference's
    only string-encoding path); other voc sizes use the matching table from
    utils.ctc.load_char_table, case-sensitive (the reference ships those
    datasets with pre-encoded 'rec' arrays instead — see load_video_json)."""
    text = np.full([max_len], voc_size, dtype=np.int32)
    if voc_size == 37:
        table = CTLABELS
        transform = str.lower
    else:
        from ..utils.ctc import load_char_table

        chars = load_char_table(voc_size)
        table = {c: i for i, c in enumerate(chars)}
        transform = lambda s: s
    if transcription:
        s = transform(transcription)
        if s == "###" or text_category == "nonalphanumeric":
            text[0] = voc_size - 1
        else:
            for i, ch in enumerate(s):
                if i >= max_len:
                    break
                text[i] = table.get(ch, voc_size - 1)
    else:
        text[0] = voc_size - 1
    return text


def load_video_json(json_file: str, image_root: str, num_points: int = 25,
                    voc_size: int = 37) -> List[Dict]:
    """Parse the COCO-style video json into per-frame records.

    Image-pretraining JSONs (PRETRAIN_SPLITS) carry pre-encoded 'rec' arrays;
    those are used verbatim, and instances whose rec is entirely the unknown
    class are dropped, mirroring adet load_text_json (text.py:204-211).
    Video JSONs carry 'transcription' strings instead (vts.py:131-147).
    """
    with open(json_file) as f:
        coco = json.load(f)

    # dense instance-id remap (vts.py:51-61)
    inst_ids = sorted({a["instance_id"] for a in coco["annotations"] if a.get("instance_id", 0) > 0})
    inst_map = {x: i + 1 for i, x in enumerate(inst_ids)}
    inst_map[0] = 0
    inst_map[-1] = 0

    anns_by_image: Dict[int, list] = {}
    for a in coco["annotations"]:
        anns_by_image.setdefault(a["image_id"], []).append(a)

    records = []
    for img in sorted(coco["images"], key=lambda x: x["id"]):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "video_id": img.get("video_id", -1),
        }
        objs = []
        for anno in anns_by_image.get(img["id"], []):
            # truthiness gate like the reference's `if text:` (text.py:204-211):
            # an empty rec list falls through to encode_text and keeps the
            # instance as a no-text object instead of being dropped
            if "rec" in anno and anno["rec"] is not None and len(np.atleast_1d(anno["rec"])):
                rec = np.asarray(anno["rec"], np.int32)
                if np.sum(rec != voc_size) == 0:  # entirely padding: no text
                    continue
                # normalize to the model's 25-point budget so every instance in
                # a dataset shares one text length (mixed-length recs would
                # break padded target building)
                texts = np.full((25,), voc_size, np.int32)
                n = min(len(rec), 25)
                texts[:n] = rec[:n]
            else:
                texts = encode_text(
                    anno.get("transcription"), anno.get("text_category"), voc_size=voc_size
                )
            obj = {
                "bbox": anno.get("bbox"),
                "category_id": 0,
                "instance_id": inst_map.get(anno.get("instance_id", 0), 0),
                "texts": texts,
            }
            bez = None
            if "bezier_pts" in anno:
                bez = np.asarray(anno["bezier_pts"], np.float64).reshape(-1, 2)
            elif "poly" in anno:
                poly = np.asarray(anno["poly"], np.float64).reshape(-1, 2)
                if len(poly) == 4:
                    bez = quad_to_bezier(poly, record["height"], record["width"])
                elif len(poly) == 14:
                    bez = poly14_to_bezier(poly)
                else:
                    raise ValueError(f"unsupported polygon size {len(poly)}")
            if bez is not None:
                center, boundary, polyline = bezier_to_gt(bez, num_points)
                obj["beziers"] = center.astype(np.float32)
                obj["boundary"] = boundary.astype(np.float32)
                obj["polyline"] = polyline.astype(np.float32)
            objs.append(obj)
        record["annotations"] = objs
        records.append(record)
    return records


def group_by_video(records: List[Dict]) -> Dict[int, List[Dict]]:
    """Group frame records by video_id; still images (video_id == -1) become singleton
    pseudo-videos under negative keys (vts_dataset_dataloader.py:96-136)."""
    videos: Dict[int, List[Dict]] = {}
    next_pseudo = -1
    for r in records:
        vid = r["video_id"]
        if vid == -1:
            videos[next_pseudo] = [r]
            next_pseudo -= 1
        else:
            videos.setdefault(vid, []).append(r)
    for v in videos.values():
        v.sort(key=lambda r: r["image_id"])
    return videos
