"""Video inference engine (port of gomatching_tpu/engine/predictor.py, the
``VideoPredictor`` core).

Replaces ``GoMBatchPredictor`` (gomatching/text_track_visualizer.py:295-335) and the
driver loop of the reference ``eval.py``:

  - frames go to the device as uint8 in batches of ``TPU.SPOT_BATCH``; resize,
    normalize, backbone, spotter, rescoring, fusion, threshold, NMS and reid run
    there, and each batch's per-slot outputs come back in ONE packed (B, nq, K) f32
    copy (``unpack_spot`` inverts the packing);
  - the host extracts dense per-frame instances and the sequential tracker runs
    the association transformer back on the device with bucket-padded tokens.

Stage wall-clock is tracked in the reference's ``time_cost`` buckets
(eval.py:303-304).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.preprocess import compute_test_size, device_preprocess
from ..models.gomatching import build_model
from ..tracking.tracker import FrameDetections, Tracker
from ..utils.ctc import ctc_decode, load_char_table
from ..weights import init_weights_, load_weights
from .checkpoint import load_checkpoint


class VideoPredictor:
    """End-to-end per-video spotting + tracking.

    ``device``: None runs on the current CUDA device and raises when there is none;
    pass ``"cpu"`` to run on the CPU. ``state_dict``: reference-keyed weights; by
    default ``MODEL.WEIGHTS`` is loaded (a torch checkpoint in the reference's
    layout), and when it is '' the model gets seeded random weights (``SEED``, or 0
    when it is negative).
    """

    def __init__(self, cfg, state_dict=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_model(cfg)
        if state_dict is None:
            state_dict = self._checkpoint(cfg)
        if state_dict is None:
            gen = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
            init_weights_(model, gen)
        else:
            load_weights(model, state_dict)
        self.model = model.to(self.device).eval()
        self.spot_batch = int(cfg.TPU.SPOT_BATCH)
        self.score_thresh = float(cfg.MODEL.TRANSFORMER.INFERENCE_TH_TEST)
        self.char_table = load_char_table(
            cfg.MODEL.TRANSFORMER.VOC_SIZE, cfg.MODEL.TRANSFORMER.CUSTOM_DICT
        )
        self.voc_size = cfg.MODEL.TRANSFORMER.VOC_SIZE
        v = cfg.VIDEO_TEST
        self.tracker = Tracker(
            self.associate,
            test_len=cfg.INPUT.VIDEO.TEST_LEN,
            overlap_thresh=v.OVERLAP_THRESH,
            min_track_len=v.MIN_TRACK_LEN,
            max_center_dist=v.MAX_CENTER_DIST,
            decay_time=v.DECAY_TIME,
            with_iou=v.WITH_IOU,
            not_mult_thresh=v.NOT_MULT_THRESH,
        )
        self._orig_hw = None

    @staticmethod
    def _checkpoint(cfg):
        """``MODEL.WEIGHTS`` as a state_dict; None (seeded random weights) only when
        it is ''. A missing file, or one that is not a torch checkpoint (such as the
        JAX package's ``.npz`` params, which the port does not load yet), raises."""
        path = cfg.MODEL.WEIGHTS
        if not path:
            return None
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"MODEL.WEIGHTS {path!r} does not exist; pass MODEL.WEIGHTS '' to run on "
                "seeded random weights"
            )
        return load_checkpoint(path, "MODEL.WEIGHTS")

    @torch.no_grad()
    def associate(self, tokens: np.ndarray, valid: np.ndarray, short_term: bool) -> np.ndarray:
        """The tracker's ``associate_fn``: (B, N, F) tokens + (B, N) validity ->
        (B, N, N) affinity logits, computed on the device."""
        t = torch.from_numpy(np.ascontiguousarray(tokens, np.float32)).to(self.device)
        m = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(self.device)
        return self.model.associate(t, m, short_term).cpu().numpy()

    @torch.no_grad()
    def spot_batch_packed(self, frames_u8: np.ndarray, target_hw) -> np.ndarray:
        """uint8 BGR frames (B, H, W, 3) -> packed (B, nq, K) f32 detections."""
        cfg = self.cfg
        raw = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        imgs = device_preprocess(raw, target_hw, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                 cfg.INPUT.FORMAT)
        out = self.model.spot_and_detect(imgs, self.score_thresh)
        B, nq = out["scores"].shape
        packed = torch.cat(
            [
                out["scores"][..., None],
                out["valid"][..., None].float(),
                out["boxes"],
                out["ctrl_points"].reshape(B, nq, -1),
                out["recs"].float(),  # ids < 2^24: exact
                out["bd"].reshape(B, nq, -1),
                out["reid"],
            ],
            -1,
        )
        return packed.cpu().numpy()

    def unpack_spot(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """Inverse of the packing: (B, nq, K) f32 -> output dict."""
        npts = self.cfg.MODEL.TRANSFORMER.NUM_POINTS
        B, nq, _ = flat.shape
        i = 0

        def take(n):
            nonlocal i
            part = flat[..., i : i + n]
            i += n
            return part

        out = {
            "scores": take(1)[..., 0],
            "valid": take(1)[..., 0] > 0.5,
            "boxes": take(4),
            "ctrl_points": take(2 * npts),
            "recs": take(npts).astype(np.int32),
            "bd": take(4 * npts).reshape(B, nq, npts, 4),
        }
        out["reid"] = flat[..., i:]
        return out

    # ------------------------------------------------------------------
    def spot_frames(self, frames: List[np.ndarray],
                    time_cost: Optional[Dict] = None) -> List[FrameDetections]:
        """BGR frames (one resolution) -> list of FrameDetections (untracked)."""
        tc = time_cost if time_cost is not None else {}
        orig_hw = frames[0].shape[:2]
        in_hw = compute_test_size(
            orig_hw[0], orig_hw[1], self.cfg.INPUT.MIN_SIZE_TEST, self.cfg.INPUT.MAX_SIZE_TEST
        )
        dets: List[FrameDetections] = []
        for s in range(0, len(frames), self.spot_batch):
            t0 = time.time()
            batch = np.stack([np.ascontiguousarray(f) for f in frames[s : s + self.spot_batch]])
            tc["pre_process"] = tc.get("pre_process", 0) + time.time() - t0
            t0 = time.time()
            outs = self.unpack_spot(self.spot_batch_packed(batch, in_hw))
            tc["detector"] = tc.get("detector", 0) + time.time() - t0
            for i in range(len(batch)):
                valid = outs["valid"][i]
                dets.append(
                    FrameDetections(
                        boxes=outs["boxes"][i][valid],
                        scores=outs["scores"][i][valid],
                        ctrl_points=outs["ctrl_points"][i][valid],
                        recs=outs["recs"][i][valid],
                        bd=outs["bd"][i][valid],
                        reid=outs["reid"][i][valid],
                        image_hw=in_hw,
                    )
                )
        self._orig_hw = orig_hw
        return dets

    def process_video(self, frames, time_cost: Optional[Dict] = None, window: int = 100):
        """Full pipeline for one video -> list of tracked FrameDetections scaled to
        the original resolution.

        ``frames`` may be any iterable of BGR arrays (a lazy decoder keeps host
        memory bounded). Frames are processed in <= ``window``-frame
        spot-then-track phases (the reference's 100-frame batching, eval.py:329);
        the tracker frees reid memory outside its TEST_LEN window, so peak memory
        is O(window), not O(video).
        """
        tc = time_cost if time_cost is not None else {}
        self.tracker.reset()

        def flush(buf):
            dets = self.spot_frames(buf, tc)
            t0 = time.time()
            # one batched matcher call covers every adjacent pair's short-term
            # pass, including the pair spanning the previous window
            prevs = ([self.tracker.frames[-1]] if self.tracker.frames else []) + dets[:-1]
            cache = self.tracker.precompute_short_asso(
                list(zip(prevs, dets[len(dets) - len(prevs):]))
            )
            self.tracker.time_cost["short_match"] += time.time() - t0
            t0 = time.time()
            self.tracker.precompute_long_asso(dets, cache)
            self.tracker.time_cost["long_match"] += time.time() - t0
            t0 = time.time()
            for det in dets:
                self.tracker.step(det, short_asso_cache=cache)
            tc["tracker"] = tc.get("tracker", 0) + time.time() - t0

        buf: List[np.ndarray] = []
        for frame in frames:
            buf.append(frame)
            if len(buf) >= window:
                flush(buf)
                buf = []
        if buf:
            flush(buf)

        for k, v in self.tracker.time_cost.items():
            tc[k] = tc.get(k, 0) + v

        t0 = time.time()
        tracked = self.tracker.remove_short_tracks()
        if self._orig_hw is not None:
            orig_h, orig_w = self._orig_hw
            for f in tracked:
                sy = orig_h / f.image_hw[0]
                sx = orig_w / f.image_hw[1]
                f.ctrl_points = f.ctrl_points.copy()
                f.ctrl_points[:, 0::2] *= sx
                f.ctrl_points[:, 1::2] *= sy
                f.bd = f.bd.copy()
                f.bd[..., 0::2] *= sx
                f.bd[..., 1::2] *= sy
        tc["post_process"] = tc.get("post_process", 0) + time.time() - t0
        return tracked

    def decode_text(self, rec) -> str:
        return ctc_decode(rec, self.voc_size, self.char_table)
