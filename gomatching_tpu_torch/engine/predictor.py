"""Video inference engine (port of gomatching_tpu/engine/predictor.py, the
``VideoPredictor`` core).

Replaces ``GoMBatchPredictor`` (gomatching/text_track_visualizer.py:295-335) and the
driver loop of the reference ``eval.py``:

  - frames go to the device as uint8 in batches of ``TPU.SPOT_BATCH`` (BGR, or planar
    I420 under ``TPU.UPLOAD_FORMAT`` yuv420 when both sides are even, decoded there);
    resize, normalize, backbone, spotter, rescoring, fusion, threshold, NMS and reid run
    there, and each batch's per-slot outputs come back in ONE packed (B, nq, K) f32
    copy (``unpack_spot`` inverts the packing);
  - ``MODEL.PRECISION`` bfloat16 runs the frozen spotter in bf16 (its deformable
    sampling on B1's and B2's bf16 kernels) and, unless ``TPU.ASSOC_PRECISION`` says
    otherwise ('' follows ``MODEL.PRECISION``), the association matchers too, with their
    tokens cast to bf16 and their logits back to f32; reid and rescore stay f32
    (JAX predictor.py:113-114, :143-153, :171-176);
  - the host extracts dense per-frame instances and the sequential tracker runs
    the association transformer back on the device with bucket-padded tokens.

Stage wall-clock is tracked in the reference's ``time_cost`` buckets
(eval.py:303-304), by the port's spans (``utils/profiling.py``), which also name each
part of a spot call and of the tracker's work in a profiler's trace.

With a ``torch.distributed`` group (JAX's mesh predictor, predictor.py:104-122,
:296-351), each spot batch's frames are split evenly over the ranks, a short last batch
padded to a multiple of the ranks (the padding's outputs dropped); each rank spots its
share and the packed rows are gathered to every rank on the host (over gloo), where every
rank runs the same host tracker on the same detections. ``TPU.SPOT_BATCH`` must be a
multiple of the ranks, as JAX's sharding requires.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.preprocess import compute_test_size, decode_i420, device_preprocess, encode_i420
from ..models.gomatching import PRECISIONS, build_model, compute_dtype
from ..tracking.tracker import FrameDetections, Tracker
from ..utils.ctc import ctc_decode, load_char_table
from ..utils.profiling import span
from ..weights import init_weights_, load_weights, params_from_jax
from .checkpoint import load_checkpoint, load_jax_params


def model_weights(cfg):
    """``MODEL.WEIGHTS`` as a state_dict; None (seeded random weights) only when it is
    ''. A path ending in ``.npz`` is read as the JAX package's params (the format every
    shipped config names) and mapped to the port's keys; any other path as a torch
    checkpoint. A missing file, or one that holds neither, raises."""
    path = cfg.MODEL.WEIGHTS
    if not path:
        return None
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"MODEL.WEIGHTS {path!r} does not exist; pass MODEL.WEIGHTS '' to run on "
            "seeded random weights"
        )
    if not path.endswith(".npz"):
        return load_checkpoint(path, "MODEL.WEIGHTS")
    tree = load_jax_params(path, "MODEL.WEIGHTS")
    try:
        return params_from_jax(tree, cfg)
    except KeyError as e:
        raise ValueError(f"MODEL.WEIGHTS {path!r} lacks the JAX param {e} that this "
                         "config's model needs") from e


class VideoPredictor:
    """End-to-end per-video spotting + tracking.

    ``device``: None runs on the current CUDA device and raises when there is none;
    pass ``"cpu"`` to run on the CPU. ``state_dict``: reference-keyed weights; by
    default ``MODEL.WEIGHTS`` is loaded (the JAX package's ``.npz`` params, or a torch
    checkpoint in the reference's layout), and when it is '' the model gets seeded
    random weights (``SEED``, or 0 when it is negative). ``group``: a process group
    whose ranks share each spot batch (only rank 0 should write results).
    """

    def __init__(self, cfg, state_dict=None, device=None, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.host_group = None
        if group is not None:
            from ..parallel.mesh import host_group, rank_and_world

            self.rank, self.world = rank_and_world(group)
            if int(cfg.TPU.SPOT_BATCH) % self.world:
                raise ValueError(f"TPU.SPOT_BATCH {cfg.TPU.SPOT_BATCH} is not a multiple of "
                                 f"the {self.world} ranks")
            self.host_group = host_group(group)
        model = build_model(cfg)
        if state_dict is None:
            state_dict = model_weights(cfg)
        if state_dict is None:
            gen = torch.Generator().manual_seed(max(int(cfg.SEED), 0))
            init_weights_(model, gen)
        else:
            load_weights(model, state_dict)
        self.model = model.to(self.device).eval()
        # weights load f32 and are cast after loading (JAX predictor.py:113-114)
        self.model.cast_frozen_(compute_dtype(cfg))
        # the bf16 matcher is gated off for the pos-emb matcher, whose f32 embeddings
        # would promote its products back to f32 anyway (JAX predictor.py:143-153)
        use_pos = not cfg.MODEL.ASSO_HEAD.NO_POS_EMB
        assoc = cfg.TPU.ASSOC_PRECISION or cfg.MODEL.PRECISION
        if assoc not in PRECISIONS:
            raise ValueError(f"TPU.ASSOC_PRECISION={cfg.TPU.ASSOC_PRECISION!r}: expected '' or "
                             f"one of {sorted(PRECISIONS)}")
        self.assoc_dtype = (torch.bfloat16 if assoc == "bfloat16" and not use_pos
                            else torch.float32)
        self.model.cast_matcher_(self.assoc_dtype)
        self.upload_format = cfg.TPU.UPLOAD_FORMAT
        self.spot_batch = int(cfg.TPU.SPOT_BATCH)
        self.score_thresh = float(cfg.MODEL.TRANSFORMER.INFERENCE_TH_TEST)
        self.char_table = load_char_table(
            cfg.MODEL.TRANSFORMER.VOC_SIZE, cfg.MODEL.TRANSFORMER.CUSTOM_DICT
        )
        self.voc_size = cfg.MODEL.TRANSFORMER.VOC_SIZE
        v = cfg.VIDEO_TEST
        # NO_POS_EMB False: the tracker passes each token's normalized box and frame
        # time to ``associate`` (JAX predictor.py:142, :202-253)
        self.tracker = Tracker(
            self.associate,
            test_len=cfg.INPUT.VIDEO.TEST_LEN,
            overlap_thresh=v.OVERLAP_THRESH,
            min_track_len=v.MIN_TRACK_LEN,
            max_center_dist=v.MAX_CENTER_DIST,
            decay_time=v.DECAY_TIME,
            with_iou=v.WITH_IOU,
            not_mult_thresh=v.NOT_MULT_THRESH,
            use_pos_emb=use_pos,
        )
        self._orig_hw = None

    @torch.no_grad()
    def associate(self, tokens: np.ndarray, valid: np.ndarray, short_term: bool,
                  boxes: Optional[np.ndarray] = None,
                  times: Optional[np.ndarray] = None) -> np.ndarray:
        """The tracker's ``associate_fn``: (B, N, F) tokens + (B, N) validity (+ the
        (B, N, 4) normalized boxes and (B, N) times of the pos-emb matcher) ->
        (B, N, N) affinity logits, computed on the device."""
        def dev(a, dtype):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a, dtype)).to(self.device)

        with span("assoc"):
            toks = dev(tokens, np.float32).to(self.assoc_dtype)
            out = self.model.associate(toks, dev(valid, bool), short_term,
                                       dev(boxes, np.float32), dev(times, np.float32))
            return out.float().cpu().numpy()

    def encode_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """uint8 BGR frames -> what goes to the device: planar I420 (B, H*3//2, W) under
        ``TPU.UPLOAD_FORMAT`` yuv420 when H and W are even, else the frames as they are
        (JAX predictor.py:426-437)."""
        h, w = frames_u8.shape[1:3]
        if self.upload_format == "yuv420" and h % 2 == 0 and w % 2 == 0:
            return encode_i420(frames_u8)
        return frames_u8

    @torch.no_grad()
    def spot_batch_packed(self, frames_u8: np.ndarray, target_hw) -> np.ndarray:
        """uint8 BGR frames (B, H, W, 3) -> packed (B, nq, K) f32 detections."""
        cfg = self.cfg
        with span("spot.encode"):
            wire = np.ascontiguousarray(self.encode_frames(frames_u8))
        with span("spot.upload"):
            raw = torch.from_numpy(wire).to(self.device)
        with span("spot.model"):
            if raw.ndim == 3:  # I420: decoded to BGR in [0, 255] on the device
                raw = decode_i420(raw)
            imgs = device_preprocess(raw, target_hw, cfg.MODEL.PIXEL_MEAN,
                                     cfg.MODEL.PIXEL_STD, cfg.INPUT.FORMAT)
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
        with span("spot.readback"):
            return packed.cpu().numpy()

    def spot_batch_sharded(self, frames_u8: np.ndarray, target_hw) -> np.ndarray:
        """``spot_batch_packed`` over the group: the batch padded with zero frames to a
        multiple of the ranks, each rank's contiguous share spotted there, every rank's
        packed rows gathered on the host; the padding's rows dropped."""
        from ..parallel.mesh import gather_objects

        n = len(frames_u8)
        pad = (-n) % self.world
        if pad:
            frames_u8 = np.concatenate([frames_u8, np.zeros((pad,) + frames_u8.shape[1:],
                                                            frames_u8.dtype)])
        share = len(frames_u8) // self.world
        mine = self.spot_batch_packed(frames_u8[self.rank * share:(self.rank + 1) * share],
                                      target_hw)
        return np.concatenate(gather_objects(mine, self.host_group))[:n]

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
            with span("stack", tc, "pre_process"):
                batch = np.stack([np.ascontiguousarray(f)
                                  for f in frames[s : s + self.spot_batch]])
            with span("spot.call", tc, "detector"):
                outs = self.unpack_spot(self.spot_batch_packed(batch, in_hw)
                                        if self.group is None
                                        else self.spot_batch_sharded(batch, in_hw))
            with span("spot.unpack"):
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
            trk = self.tracker
            with span("track"):
                with span("track.short", trk.time_cost, "short_match"):
                    # one batched matcher call covers every adjacent pair's short-term
                    # pass, including the pair spanning the previous window
                    prevs = ([trk.frames[-1]] if trk.frames else []) + dets[:-1]
                    cache = trk.precompute_short_asso(
                        list(zip(prevs, dets[len(dets) - len(prevs):]))
                    )
                with span("track.long", trk.time_cost, "long_match"):
                    trk.precompute_long_asso(dets, cache)
                for det in dets:
                    with span("track.step", tc, "tracker"):
                        trk.step(det, short_asso_cache=cache)

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

        with span("post", tc, "post_process"):
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
        return tracked

    def decode_text(self, rec) -> str:
        return ctc_decode(rec, self.voc_size, self.char_table)
