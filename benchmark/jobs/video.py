"""Video inference: ``VideoPredictor.process_video`` over seeded videos, one after
another (a closed loop: the next frame is pulled when the program asks for it).

Set-up: the configuration, seeded weights on the device, the predictor, the detection
threshold (the one that leaves ``kept_per_frame`` detections a frame after NMS, on the
reference's outputs for the first frames of ``threshold_videos`` videos) and one warm-up
video that runs every spot batch size and a whole window. The window then feeds whole
videos, lazily, until ``seconds`` have passed; the last video's frames stop there, so it
is flushed and returns. ``frames_per_s`` is every frame returned with tracked results over the whole
window, from the first frame pulled to the last video's return.

What the timed path produced is kept for the comparison (``check_video``): each spot
call's packed outputs and the reference points its proposal stage chose, and each
association call's inputs and logits. After the window a seeded sample of them is
judged against the plain reference.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check_video, counts, frames, tracing
from ..reference import trunks
from ..reference.train import iou_np
from ..weights import make_state_dict

MISSING = 1e9  # the reading of an answer the program did not give
SPAN_NAMES = ("frames", "spot_batch", "encoder_sampler", "associate", "tracker")


def port_cfg(config: Dict, extra_opts=()):
    from gomatching_tpu_torch.config import setup_eval_cfg

    port = config["port"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return setup_eval_cfg(os.path.join(root, port["config_file"]),
                          list(port["opts"]) + list(extra_opts))


def check_cfg(cfg, m: Dict) -> None:
    """The port's resolved configuration is the one the configuration file states; the
    trunk's keys are its file's ``port_fields``."""
    t, a = cfg.MODEL.TRANSFORMER, cfg.MODEL.ASSO_HEAD
    got = {
        **trunks.of(m).port_fields(cfg), "hidden_dim": t.HIDDEN_DIM,
        "nheads": t.NHEADS, "enc_layers": t.ENC_LAYERS, "dec_layers": t.DEC_LAYERS,
        "dim_feedforward": t.DIM_FEEDFORWARD, "num_feature_levels": t.NUM_FEATURE_LEVELS,
        "enc_n_points": t.ENC_N_POINTS, "dec_n_points": t.DEC_N_POINTS,
        "num_queries": t.NUM_QUERIES, "num_points": t.NUM_POINTS, "voc_size": t.VOC_SIZE,
        "temperature": float(t.TEMPERATURE), "asso_fc_dim": a.FC_DIM, "asso_num_fc": a.NUM_FC,
        "asso_num_heads": a.NUM_HEADS, "asso_encoder_layers": a.NUM_ENCODER_LAYERS,
        "asso_decoder_layers": a.NUM_DECODER_LAYERS,
        "matcher": {"LSTMatcher": "lst", "SHA_FFN_CRSATTN": "shared"}[cfg.MODEL.ROI_HEADS.NAME],
        "with_rescore": bool(cfg.MODEL.ROI_HEADS.WITH_RESR), "precision": cfg.MODEL.PRECISION,
        "assoc_precision": cfg.TPU.ASSOC_PRECISION or cfg.MODEL.PRECISION,
        "upload_format": cfg.TPU.UPLOAD_FORMAT, "min_size_test": cfg.INPUT.MIN_SIZE_TEST,
        "max_size_test": cfg.INPUT.MAX_SIZE_TEST, "pixel_mean": list(cfg.MODEL.PIXEL_MEAN),
        "pixel_std": list(cfg.MODEL.PIXEL_STD), "spot_batch": cfg.TPU.SPOT_BATCH,
        "sampling_impl": cfg.TPU.SAMPLING_IMPL, "input_format": cfg.INPUT.FORMAT,
        "boundary_head": bool(t.BOUNDARY_HEAD), "no_pos_emb": bool(a.NO_POS_EMB),
        "num_weight_layers": a.NUM_WEIGHT_LAYERS, "nms_thresh": cfg.VIDEO_TEST.NMS_THRESH,
    }
    want = dict(m, backbone=trunks.name_of(m))
    bad = {k: (v, want.get(k)) for k, v in got.items() if want.get(k) != v}
    if bad:
        raise ValueError(f"the port's configuration differs from the benchmark's: {bad}")


class Recorder:
    """Keeps what the timed path produced; installed as instance wrappers."""

    def __init__(self, predictor):
        self.spot: List[Dict] = []
        self.assoc: List[Dict] = []
        self._armed = False
        self._points = None
        self.t_start = 0.0
        spotter = predictor.model.detection_transformer
        select, spot, assoc = (spotter.select_proposals, predictor.spot_batch_packed,
                               predictor.tracker.associate_fn)

        def select_rec(enc_class, enc_coords):
            out = select(enc_class, enc_coords)
            if self._armed:
                self._points = out
            return out

        def spot_rec(frames_u8, target_hw):
            self._armed = True
            try:
                packed = spot(frames_u8, target_hw)
            finally:
                self._armed = False
            self.spot.append({"packed": packed, "ref_points": self._points,
                              "n": len(frames_u8), "done": time.perf_counter() - self.t_start,
                              "probe": np.asarray(frames_u8[:, ::97, ::89], np.int64).sum()})
            self._points = None
            return packed

        def assoc_rec(tokens, valid, short_term, *rest):
            out = assoc(tokens, valid, short_term, *rest)
            self.assoc.append({"tokens": tokens, "valid": valid, "short_term": short_term,
                               "out": out})
            return out

        spotter.select_proposals = select_rec
        predictor.spot_batch_packed = spot_rec
        predictor.tracker.associate_fn = assoc_rec


def _install_spans(predictor, spans: tracing.Spans, sampler_calls: List):
    """The traced run's spans around the program's layers."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    predictor.spot_batch_packed = spans.wrap("spot_batch", predictor.spot_batch_packed)
    trk = predictor.tracker
    trk.associate_fn = spans.wrap("associate", trk.associate_fn)
    for name in ("precompute_short_asso", "precompute_long_asso", "step"):
        setattr(trk, name, spans.wrap("tracker", getattr(trk, name)))

    def count(value, shapes, *_):
        sampler_calls.append((value.shape[0], value.shape[1], str(value.dtype).split(".")[-1]))

    spotter_mod.ms_deform_attn_encoder = spans.wrap(
        "encoder_sampler", spotter_mod.ms_deform_attn_encoder, on_call=count)
    return lambda: setattr(spotter_mod, "ms_deform_attn_encoder",
                           spotter_mod.ms_deform_attn_encoder.__wrapped__)


def run(ctx: Dict) -> Dict:
    """One run of a video cell; ``ctx`` holds the cell, configuration, traffic, seed,
    seconds, trace flag, device and the process's start time."""
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    m, tr, seed, device = ctx["model"], ctx["traffic"], ctx["seed"], ctx["device"]
    stages = {"imports": time.perf_counter() - ctx["t0"]}
    mark = time.perf_counter()

    def stage(name):
        nonlocal mark
        now = time.perf_counter()
        stages[name] = now - mark
        mark = now

    cfg = port_cfg(ctx["config"], ctx.get("extra_opts", ()))
    check_cfg(cfg, m)
    tf32 = bool(m.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    sd = make_state_dict(m, seed, device)
    stage("weights")
    ref = check_video.build_reference(m, sd, device)
    stage("reference")
    predictor = VideoPredictor(cfg, state_dict=sd, device=device)
    del sd
    stage("predictor")
    hw = tuple(tr["frame_hw"])
    pan, window = int(tr["pan_px"]), int(tr["window_frames"])
    batch = int(m["spot_batch"])

    # threshold: on the reference's scores of the first frame of each of the first
    # ``threshold_videos`` videos, the one that leaves ``kept_per_frame`` detections a
    # frame after NMS (so that the tracker's work varies little from seed to seed)
    order = frames.video_order(tr["video_lengths"], seed)
    firsts = [frames.frame(frames.canvas(seed, k, hw), 0, pan)
              for k in range(int(tr["threshold_videos"]))]
    thresh = calibrate_threshold(ref, m, firsts, float(tr["kept_per_frame"]), device)
    predictor.score_thresh = thresh
    ref.cpu()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stage("threshold")
    # the reference's seconds are not set-up's
    ref_s = stages["reference"] + stages["threshold"]
    # warm-up: every spot batch size and one whole window, on a video of its own
    cw = frames.canvas(seed, frames.WARM_UP, hw)
    n_warm = window + batch - 1
    predictor.process_video((frames.frame(cw, t, pan) for t in range(n_warm)), window=window)

    stage("warm-up")
    print("set-up by stage (s): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          file=sys.stderr)
    rec = Recorder(predictor)
    spans, sampler_calls = tracing.Spans(), []
    prof, undo = None, None
    if ctx["trace"]:
        undo = _install_spans(predictor, spans, sampler_calls)
        prof = tracing.profile_window(ctx["trace_dir"])
        prof.__enter__()
    tc: Dict[str, float] = {}
    pulled: List[int] = []
    returned: List[int] = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t0"] - ref_s
    t_start = time.perf_counter()
    rec.t_start = t_start
    deadline = t_start + ctx["seconds"]
    stop = False
    win = torch.profiler.record_function(tracing.WINDOW)
    win.__enter__()

    def video(k: int, n: int):
        nonlocal stop
        cv = frames.canvas(seed, k, hw)
        for t in range(n):
            if time.perf_counter() >= deadline:
                stop = True
                return
            pulled[-1] += 1
            if prof is not None:
                with torch.profiler.record_function("frames"):
                    f = frames.frame(cv, t, pan)
            else:
                f = frames.frame(cv, t, pan)
            yield f

    k = 0
    while not stop:
        n = order[k % len(order)]
        pulled.append(0)
        out = predictor.process_video(video(k, n), tc, window=window)
        returned.append(len(out))
        k += 1
    t_end = time.perf_counter()
    win.__exit__(None, None, None)
    window_s = t_end - t_start
    memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    trace_stats = None
    if prof is not None:
        prof.__exit__(None, None, None)
        undo()
        path = os.path.join(ctx["trace_dir"], f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        del prof
        trace_stats = tracing.reduce_trace(path, SPAN_NAMES)
        os.remove(path)

    n_frames = int(sum(returned))
    kept = float(np.mean([np.sum(c["packed"][..., 1] > 0.5) / c["n"] for c in rec.spot]))
    print(f"threshold {thresh!r}, kept a frame {kept:.2f}; frames/s by tenth of the window "
          "(spot calls done): " + " ".join(
              f"{r:.2f}" for r in tenths([(c["done"], c["n"]) for c in rec.spot], window_s)),
          file=sys.stderr)
    # the comparison, after the window: the program's state is freed first
    spot_rec, assoc_rec = rec.spot, rec.assoc
    flops_matcher = sum(
        counts.matcher_flops(int(v), m, c["short_term"])
        for c in assoc_rec for v in np.asarray(c["valid"]).sum(1))
    del predictor, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.to(device)
    checks = compare(ctx, ref, m, tr, seed, pulled, spot_rec, assoc_rec)
    checks["frames_missing"] = float(sum(pulled) - n_frames)

    h, w = check_video.resize_hw_of(hw, m)
    sf = counts.spot_flops(h, w, m)
    peaks = ctx["peaks"]
    return {
        "attempted": int(sum(pulled)), "failed": int(sum(pulled) - n_frames),
        "end_to_end": {"frames_per_s": n_frames / window_s, "setup_s": setup_s},
        "memory_peak_bytes": int(memory_peak), "checks": checks,
        "records": {
            "kind": "video", "frames": n_frames, "window_s": window_s, "time_cost": tc,
            "spans": spans.seconds, "trace": trace_stats, "threshold": thresh,
            "flops": sf["total"] * n_frames + flops_matcher,
            "peak_flops": peaks[m["precision"]], "mem_bw": peaks["mem_bw"],
            "sampler_calls": sampler_calls, "model": m,
        },
    }


def nms_kept_scores(scores: np.ndarray, boxes: np.ndarray, iou: float) -> np.ndarray:
    """Greedy NMS over all of a frame's queries (descending score, ties in slot order; a
    box goes if it overlaps a kept one by IoU > ``iou``) -> the kept boxes' scores. The
    boxes NMS keeps among those above a threshold are these, above it."""
    order = np.argsort(-scores, kind="stable")
    over = iou_np(boxes[order], boxes[order]) > iou
    keep: List[int] = []
    for i in range(len(order)):
        if not over[i, keep].any():
            keep.append(i)
    return scores[order[keep]]


@torch.no_grad()
def calibrate_threshold(ref, m: Dict, frames_u8: List[np.ndarray], kept: float,
                        device) -> float:
    """The score threshold under which the reference's detections on ``frames_u8``, after
    NMS, number ``kept`` a frame (all of them, threshold 0, where there are fewer)."""
    pool = []
    batch = int(m["spot_batch"])
    for b in range(0, len(frames_u8), batch):
        x = check_video.preprocess(np.stack(frames_u8[b:b + batch]), m, device)
        enc = ref.encode(x)
        dec = ref.decode(enc, ref.select(enc), x.shape[1:3])
        del enc, x
        scores = dec["scores"].float().cpu().numpy()
        pts = dec["bd"].float().cpu().numpy().reshape(*scores.shape, -1, 2)
        boxes = np.concatenate([pts.min(2), pts.max(2)], -1)
        pool += [nms_kept_scores(s, bx, m["nms_thresh"]) for s, bx in zip(scores, boxes)]
    pool = np.sort(np.concatenate(pool))[::-1]
    n = int(round(kept * len(frames_u8)))
    return float((pool[n - 1] + pool[n]) / 2) if len(pool) > n else 0.0


def tenths(done, window_s: float) -> List[float]:
    """Frames a second by tenth of the window, from (time done, frames) of each spot call."""
    n = [0] * 10
    for t, k in done:
        n[min(int(10 * t / window_s), 9)] += k
    return [10 * k / window_s for k in n]


def compare(ctx, ref, m, tr, seed, pulled, spot_rec, assoc_rec) -> Dict:
    """The sampled answers of the window against the reference."""
    hw = tuple(tr["frame_hw"])
    pan, window, batch = int(tr["pan_px"]), int(tr["window_frames"]), int(m["spot_batch"])
    # (video, first frame, count) of every spot call, in order
    where = []
    for k, n in enumerate(pulled):
        where += [(k, f0, c) for f0, c in frames.spot_calls(n, window, batch)]
    if len(where) != len(spot_rec):
        raise RuntimeError(f"{len(spot_rec)} spot calls recorded, {len(where)} expected")
    rng = np.random.default_rng([int(seed), 2])
    n_spot = min(int(tr["sample_spot_calls"]), len(spot_rec))
    n_assoc = min(int(tr["sample_assoc_calls"]), len(assoc_rec))
    readings = dict.fromkeys(check_video.READINGS, 0.0)
    device = ctx["device"]
    for i in sorted(rng.choice(len(spot_rec), n_spot, replace=False)):
        k, f0, c = where[i]
        cv = frames.canvas(seed, k, hw)
        fr = np.stack([frames.frame(cv, f0 + t, pan) for t in range(c)])
        got = spot_rec[i]
        if got["n"] != c or np.asarray(fr[:, ::97, ::89], np.int64).sum() != got["probe"]:
            raise RuntimeError(f"spot call {i} does not hold the frames expected")
        program = check_video.unpack(got["packed"], m["num_points"])
        program["ref_points"] = got["ref_points"]
        if got["ref_points"] is None or len(got["ref_points"]) != c or len(got["packed"]) != c:
            # the program answered for other frames than it was given
            readings = {key: max(v, MISSING) for key, v in readings.items()}
            continue
        answers = program if ctx.get("control") is None else ctx["control"](ref, m, fr, device)
        r = check_video.spot_readings(check_video.reference_spot(
            ref, m, fr, answers["ref_points"], device), answers)
        for key, v in r.items():
            readings[key] = max(readings[key], v)
    for i in sorted(rng.choice(len(assoc_rec), n_assoc, replace=False)):
        call = assoc_rec[i]
        if ctx.get("control") is not None:
            call = check_video.control_affinity(ref, m, call, device)
        readings["affinity_gap"] = max(readings["affinity_gap"],
                                       check_video.affinity_reading(ref, m, call, device))
    return readings
