#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (gomatching_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device check and kernel build (nvcc, from the sources in this checkout);
  2. each hand-written kernel against its plain PyTorch version at the full-width
     ICDAR15 shapes (1000x1778 input: levels (125,223) (63,112) (32,56) (16,28),
     S=37171 tokens, M=8 heads, D=32, L=4, P=4, 100x25 decoder queries), with
     locations and offsets outside the maps; max |kernel - plain| against
     ATOL_KERNEL, and the kernel's / plain version's time beside the roofline bound;
  3. one frame through the full-depth spotter with the kernels and with the plain
     versions (same seeded weights, TF32 off): encoder memory, then the decoder from
     the same proposals, compared at ATOL_PATH;
  4. the main path: ``VideoPredictor`` on configs/GoMatching_ICDAR15.yaml at full
     width with seeded random weights and a lowered detection threshold, over
     N_FRAMES synthetic 720x1280 frames; XML/JSON written and parsed back; each
     kernel must have launched 6 x (spot batches) times in that run;
  5. the same frames once more under torch.profiler: device time by kernel.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ATOL_KERNEL = 1e-4  # f32: the kernel and grid_sample sum the same taps in another order
ATOL_PATH = 2e-3  # 6 encoder / 6 decoder layers amplify those differences
SHAPES = [(125, 223), (63, 112), (32, 56), (16, 28)]
B, M, D, L, P = 3, 8, 32, 4, 4  # B = TPU.SPOT_BATCH, the main path's batch
NQ, NPTS = 100, 25
N_FRAMES = 8
N_REPEATS = 5  # timed runs of the clip; the first is the checked, counted one
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
CONFIG = "configs/GoMatching_ICDAR15.yaml"


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def value_reads(torch, loc, S, D):
    """What this run's locations need of value (B, S, M, D): the distinct
    (batch, token, head) rows that an in-range bilinear corner touches, read once,
    and the number of corner taps (taps outside the map read nothing).
    loc (B, Lq, M, L, P, 2) normalized; the kernel's x = loc * W - 0.5."""
    B, _, M = loc.shape[:3]
    touched = torch.zeros(B * S * M, dtype=torch.bool, device=loc.device)
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    m = torch.arange(M, device=loc.device).view(1, 1, M, 1)
    taps, start = 0, 0
    for lvl, (h, w) in enumerate(SHAPES):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()  # (B, Lq, M, P)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                row = ((b * S + start + y * w + x) * M + m)[ok]
                touched[row] = True
                taps += row.numel()
        start += h * w
    return int(touched.sum().item()) * D * 4, taps


def phase_kernels(torch, da):
    """Kernel vs plain at full width; returns the kernels-line records (sans launches)."""
    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator().manual_seed(0)
    dev = "cuda"
    value = torch.randn(B, S, M, D, generator=g).to(dev)
    records = {}

    # B1: arbitrary locations, some outside [0, 1]
    Lq = NQ * NPTS
    loc = (torch.rand(B, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.randn(B, Lq, M, L * P, generator=g).softmax(-1).view(B, Lq, M, L, P).to(dev)
    got = da.ms_deform_attn_queries(value, SHAPES, loc, attn)
    want = da.ms_deform_attn_queries_plain(value, SHAPES, loc, attn)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= ATOL_KERNEL, f"{da.QUERIES}: max err {err}")
    ms = cuda_time_ms(lambda: da.ms_deform_attn_queries(value, SHAPES, loc, attn))
    plain_ms = cuda_time_ms(lambda: da.ms_deform_attn_queries_plain(value, SHAPES, loc, attn))
    v_bytes, taps = value_reads(torch, loc, S, D)
    samples = B * Lq * M * L * P
    b_ms, b_by = bound(v_bytes + nbytes(loc, attn, got),
                       samples * (20 + 2 * D) + taps * (2 * D + 1))
    records[da.QUERIES] = dict(
        name=da.QUERIES, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_dec_vmem.py:54", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, value_mb=v_bytes / 1e6,
    )

    # B2: raw offsets of a few cells, some far beyond the map, and logits
    off = torch.randn(B, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(B, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    logits = torch.randn(B, S, M, L * P, generator=g).to(dev)
    got = da.ms_deform_attn_encoder(value, SHAPES, off, logits)
    want = da.ms_deform_attn_encoder_plain(value, SHAPES, off, logits)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(math.isfinite(err) and err <= ATOL_KERNEL, f"{da.ENCODER}: max err {err}")
    ms = cuda_time_ms(lambda: da.ms_deform_attn_encoder(value, SHAPES, off, logits))
    plain_ms = cuda_time_ms(lambda: da.ms_deform_attn_encoder_plain(value, SHAPES, off, logits),
                            iters=5, warmup=1)
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    enc_loc = (da.encoder_reference_points(SHAPES, dev)[None, :, None, None, None, :]
               + off / wh[None, None, None, :, None, :])
    v_bytes, taps = value_reads(torch, enc_loc, S, D)
    del enc_loc
    samples = B * S * M * L * P
    b_ms, b_by = bound(v_bytes + nbytes(off, logits, got),
                       samples * (27 + 2 * D) + taps * (2 * D + 1))
    records[da.ENCODER] = dict(
        name=da.ENCODER, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
        replaces="gomatching_tpu/ops/deform_attn_vmem.py:246", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, value_mb=v_bytes / 1e6,
    )
    for r in records.values():
        print(f"[2] {r['name']}: max|kernel-plain| {r['max_abs_err']:.3e} (atol {ATOL_KERNEL}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['value_mb']:.1f} MB of value rows touched of "
              f"{nbytes(value) / 1e6:.1f} MB) at B={B}")
    return records


def phase_path(torch, predictor, da):
    """One frame through the spotter with the kernels and with the plain versions."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    model = predictor.model
    spotter = model.detection_transformer
    g = torch.Generator().manual_seed(1)
    img = (torch.rand(1, 1000, 1778, 3, generator=g) * 4 - 2).cuda()

    def run(plain, enc=None, refs=None):
        saved = spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries
        if plain:
            spotter_mod.ms_deform_attn_encoder = da.ms_deform_attn_encoder_plain
            spotter_mod.ms_deform_attn_queries = da.ms_deform_attn_queries_plain
        try:
            with torch.no_grad():
                if enc is None:
                    feats, pos = model.features(img)
                    return spotter.encode(feats, pos, None)
                return spotter.decode(enc, refs)
        finally:
            spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries = saved

    enc_k = run(False)
    enc_p = run(True)
    err_mem = (enc_k["memory"] - enc_p["memory"]).abs().max().item()
    with torch.no_grad():
        refs = spotter.propose(enc_k)
    out_k = run(False, enc_k, refs)
    out_p = run(True, enc_k, refs)
    errs = {"encoder memory": err_mem}
    for k, v in out_k.items():
        check(bool(torch.isfinite(v).all()), f"path: non-finite {k}")
        errs[k] = (v - out_p[k]).abs().max().item()
    for k, e in errs.items():
        print(f"[3] spotter {k}: max|kernels-plain| {e:.3e} (atol {ATOL_PATH})")
        check(math.isfinite(e) and e <= ATOL_PATH, f"path: {k} differs by {e}")


def synthetic_frames():
    """N_FRAMES 720x1280 BGR frames: one random image panning 6 px per frame."""
    base = np.random.RandomState(0).randint(0, 255, (720, 1280, 3), dtype="uint8")
    return [np.roll(base, 6 * t, axis=1) for t in range(N_FRAMES)]


def phase_profile(torch, predictor):
    """The main path once more under torch.profiler: device time by kernel and the
    device's busy share of the wall time (kernels run on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    frames = synthetic_frames()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        predictor.process_video([f.copy() for f in frames])
        torch.cuda.synchronize()
        wall = time.time() - t0
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == cuda]  # kernels and copies, not the host ops launching them
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        print("[5] profiler: no device time recorded (not measured)")
        return
    print(f"[5] profiled main path: wall {wall * 1e3:.1f} ms for {N_FRAMES} frames, device busy "
          f"{total_ms:.1f} ms ({100 * total_ms / (wall * 1e3):.1f}% of wall; profiler on)")
    for t_us, n, key in rows[:15]:
        print(f"[5]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / total_ms:5.1f}% x{n:<5d} {key[:90]}")


def phase_main(torch, predictor, da):
    """VideoPredictor over synthetic 720p frames; returns the launch counts."""
    import xml.etree.ElementTree as ET

    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results

    frames = synthetic_frames()
    predictor.process_video([f.copy() for f in frames[:2]])  # warm-up, not counted
    torch.cuda.synchronize()
    da.reset_launch_counts()
    tc = {}
    t0 = time.time()
    tracked = predictor.process_video([f.copy() for f in frames], tc)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    counts = dict(da.launch_counts)
    walls = [elapsed]
    for _ in range(N_REPEATS - 1):
        t0 = time.time()
        predictor.process_video([f.copy() for f in frames])
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    fps = sorted(N_FRAMES / w for w in walls)

    n_batches = -(-N_FRAMES // predictor.spot_batch)
    t = predictor.cfg.MODEL.TRANSFORMER
    check(len(tracked) == N_FRAMES, f"{len(tracked)} tracked frames")
    n_det = sum(len(f) for f in tracked)
    ids = set()
    for f in tracked:
        check(len(set(f.track_ids.tolist())) == len(f), "duplicate track ids in a frame")
        check(f.bd.shape[1:] == (NPTS, 4) and f.ctrl_points.shape[1] == 2 * NPTS, "shapes")
        for a in (f.boxes, f.scores, f.bd, f.ctrl_points):
            check(bool(np.isfinite(a).all()), "non-finite detections")
        ids.update(f.track_ids.tolist())
    stats = predictor.tracker.asso_stats
    check(stats["short_calls"] > 0, f"the short-term matcher never ran: {stats}")
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = os.path.join(tmp, "res_video_1.xml")
        json_path = os.path.join(tmp, "video_1.json")
        write_video_results(annotate(predictor, tracked), json_path, xml_path)
        root = ET.parse(xml_path).getroot()
        with open(json_path) as fp:
            js = json.load(fp)
        n_obj = sum(len(fr) for fr in root)
        check(root.tag == "Frames" and len(js) == N_FRAMES, "XML/JSON structure")
        check(n_obj == sum(len(v) for v in js.values()), "XML and JSON disagree")
    print(f"[4] main path: {N_FRAMES} frames 720x1280 -> 1000x1778, {N_REPEATS} runs: "
          f"median {fps[len(fps) // 2]:.3f} frames/s (min {fps[0]:.3f}, max {fps[-1]:.3f}; "
          f"spot batch {predictor.spot_batch}); first run: "
          f"{n_det} detections after short-track removal, {len(ids)} tracks, "
          f"{n_obj} XML objects; matcher calls {stats}")
    print("[4] host wall by stage (s): " + ", ".join(f"{k} {v:.4f}" for k, v in tc.items()))
    print(f"[4] kernels launched in the main path: {counts}")
    for name, n in counts.items():
        want = (t.ENC_LAYERS if name == da.ENCODER else t.DEC_LAYERS) * n_batches
        check(n == want, f"{name}: {n} launches, expected {want}")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.ops import _build
    from gomatching_tpu_torch.ops import deform_attn as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # as nvidia-smi gives it: name, power limit
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build("ms_deform_attn.cu")
    print(f"[1] kernels built in {time.time() - t0:.1f} s")

    records = phase_kernels(torch, da)
    cfg = setup_eval_cfg(CONFIG, ["MODEL.WEIGHTS", "''",
                                  "MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.05", "SEED", "0"])
    t0 = time.time()
    predictor = VideoPredictor(cfg)
    print(f"[1] VideoPredictor built with seeded random weights in {time.time() - t0:.1f} s")
    phase_path(torch, predictor, da)
    counts = phase_main(torch, predictor, da)
    phase_profile(torch, predictor)

    kernels = []
    for name, rec in records.items():
        rec = dict(rec, launches=counts[name])
        kernels.append({k: rec[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
