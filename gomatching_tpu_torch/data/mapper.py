"""Training clip sampler and per-clip augmentation (port of
``gomatching_tpu/data/mapper.py``).

Parity: ``GoMDatasetMapper`` (gomatching/data/vts_dataset_mapper.py:94-259):
  - up to TRAIN_LEN frames: a random window start, a random-stride subset within
    SAMPLE_RANGE * train_len (:203-208);
  - DYNAMIC_SCALE: when the random crop downsizes the video, the clip grows up to
    2 * train_len frames (:165-177);
  - GEN_IMAGE_MOTION: a clip synthesized from a still image by interpolating two
    random resize-crop draws (:181-202);
  - the SAME transform is replayed on every frame of a clip;
  - annotations (bbox, beziers, polyline, boundary) get the coordinate transform
    (custom_dataset_mapper.py:41-96); boxes clamp unless NOT_CLAMP_BOX.
The random draws are the JAX mapper's: the same ``np.random.RandomState`` calls in the
same order, so one seed gives the same clips. Output per frame: a float32 HWC image in
INPUT.FORMAT order, and dense GT arrays for the trainer.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional

import cv2
import numpy as np

from .transforms import ResizeCropTransform, sample_resize_crop


@dataclass
class ClipSample:
    images: List[np.ndarray]  # float32 HWC, post-transform
    image_hw: tuple  # (h, w) of the transformed frames
    gt_boxes: List[np.ndarray]  # per frame (g, 4) xyxy in pixels
    gt_ids: List[np.ndarray]
    gt_texts: List[np.ndarray]
    gt_ctrl: List[np.ndarray]  # (g, npts, 2) polyline points in pixels
    gt_boundary: List[np.ndarray]  # (g, 2 * npts, 2)
    gt_beziers: List[np.ndarray]  # (g, 4, 2)


class ClipMapper:
    def __init__(self, train_size: int = 1280, scale_range=(0.1, 2.0), train_len: int = 6,
                 sample_range: float = 2.0, dynamic_scale: bool = True,
                 gen_image_motion: bool = True, not_clamp_box: bool = True,
                 input_format: str = "RGB", train_h: int = -1, train_w: int = -1,
                 num_points: int = 25, seed: Optional[int] = None):
        self.num_points = num_points
        self.train_size = train_size
        self.scale_range = tuple(scale_range)
        self.train_len = train_len
        self.sample_range = sample_range
        self.dynamic_scale = dynamic_scale
        self.gen_image_motion = gen_image_motion
        self.not_clamp_box = not_clamp_box
        self.input_format = input_format
        self.train_h = train_h
        self.train_w = train_w
        self.rng = np.random.RandomState(seed)

    def _read(self, path: str) -> np.ndarray:
        img = cv2.imread(path)  # BGR
        if img is None:
            raise FileNotFoundError(f"cannot read training frame {path!r}")
        if self.input_format == "RGB":
            img = img[:, :, ::-1]
        return np.ascontiguousarray(img)

    def _transform_annos(self, annos: List[Dict], tfm: ResizeCropTransform, image_hw):
        h, w = image_hw
        boxes, ids, texts, ctrl, boundary, beziers = [], [], [], [], [], []
        for a in annos:
            if "polyline" not in a:
                continue
            x, y, bw, bh = a["bbox"]
            box = tfm.apply_box(np.asarray([[x, y, x + bw, y + bh]], np.float64))[0]
            if not self.not_clamp_box:
                box = np.clip(box, [0, 0, 0, 0], [w, h, w, h])
            # drop boxes that the crop emptied (filter_empty_instances)
            if box[2] <= box[0] or box[3] <= box[1]:
                continue
            boxes.append(box)
            ids.append(a.get("instance_id", 0))
            texts.append(a["texts"])
            ctrl.append(tfm.apply_coords(np.asarray(a["polyline"], np.float64)))
            boundary.append(tfm.apply_coords(np.asarray(a["boundary"], np.float64)))
            beziers.append(tfm.apply_coords(np.asarray(a["beziers"], np.float64)))

        def stack(lst, shape):
            return np.asarray(lst, np.float32) if lst else np.zeros((0,) + shape, np.float32)

        return (
            stack(boxes, (4,)),
            np.asarray(ids, np.int64) if ids else np.zeros((0,), np.int64),
            np.asarray(texts, np.int32) if texts else np.zeros((0, 25), np.int32),
            stack(ctrl, (self.num_points, 2)),
            stack(boundary, (2 * self.num_points, 2)),
            stack(beziers, (4, 2)),
        )

    def _motion_transforms(self, hw, num_frames: int) -> List[ResizeCropTransform]:
        """GEN_IMAGE_MOTION: two draws at scale (0.8, 1.2), interpolated frame by frame."""
        rng = self.rng
        t_st = sample_resize_crop(hw, self.train_size, (0.8, 1.2), rng)
        t_ed = sample_resize_crop(hw, self.train_size, (0.8, 1.2), rng)
        out = []
        for x in range(num_frames):
            t = copy.deepcopy(t_st)
            t.offset_x += (t_ed.offset_x - t_st.offset_x) * x // (num_frames - 1)
            t.offset_y += (t_ed.offset_y - t_st.offset_y) * x // (num_frames - 1)
            t.img_scale += (t_ed.img_scale - t_st.img_scale) * x / (num_frames - 1)
            t.scaled_h = int(hw[0] * t.img_scale)
            t.scaled_w = int(hw[1] * t.img_scale)
            out.append(t)
        return out

    def __call__(self, video_frames: List[Dict]) -> ClipSample:
        """``video_frames``: one video's frame records (``datasets.load_video_json``)."""
        rng = self.rng
        n_total = len(video_frames)
        num_frames = min(n_total, self.train_len)
        st = rng.randint(n_total - num_frames + 1)
        if self.gen_image_motion and n_total == 1:
            rec = video_frames[0]
            transforms = self._motion_transforms((rec["height"], rec["width"]), self.train_len)
            frames = [rec] * self.train_len
        else:
            rec = video_frames[st]
            shared = sample_resize_crop((rec["height"], rec["width"]), self.train_size,
                                        self.scale_range, rng, self.train_h, self.train_w)
            if self.dynamic_scale:
                auged = max(shared.scaled_w, shared.scaled_h)
                target = max(shared.target_h, shared.target_w)
                max_frames = int(num_frames * (target / auged) ** 2)
                if max_frames > self.train_len:
                    num_frames = rng.randint(max_frames - self.train_len + 1) + self.train_len
                    num_frames = min(self.train_len * 2, num_frames, n_total)
            if self.sample_range > 1.0:
                ed = min(st + int(self.sample_range * num_frames), n_total)
                num_frames = min(num_frames, ed - st)
                inds = sorted(rng.choice(range(st, ed), size=num_frames, replace=False))
                frames = [video_frames[i] for i in inds]
            else:
                frames = video_frames[st:st + num_frames]
            transforms = [shared] * len(frames)

        images, g_boxes, g_ids, g_texts, g_ctrl, g_bd, g_bz = [], [], [], [], [], [], []
        out_hw = None
        for rec, tfm in zip(frames, transforms):
            img = tfm.apply_image(self._read(rec["file_name"])).astype(np.float32)
            out_hw = img.shape[:2]
            images.append(img)
            bx, ids, tx, ct, bd, bz = self._transform_annos(rec["annotations"], tfm, out_hw)
            g_boxes.append(bx)
            g_ids.append(ids)
            g_texts.append(tx)
            g_ctrl.append(ct)
            g_bd.append(bd)
            g_bz.append(bz)
        return ClipSample(images, out_hw, g_boxes, g_ids, g_texts, g_ctrl, g_bd, g_bz)
