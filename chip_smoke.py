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
  5. the same frames once more under torch.profiler: device time by kernel;
  6. each backward kernel (B3: B1's VJP, B4: B2's VJP) against its plain version
     (autograd through grid_sample) at the pretraining shapes (1280x1280 square input:
     levels (160,160) (80,80) (40,40) (20,20), S=34000, B=1, 100x25 decoder queries),
     with locations and offsets outside the maps; max |kernel - plain| / max |plain| of
     each gradient against RTOL_BWD, and times beside the bound;
  7. one full-width pretraining step (forward, costs, host Hungarian, losses,
     backward) with the kernels, with the plain versions, and with the plain versions
     in float64 at the same matches: same seeded weights, image and targets, TF32 off;
     identical matches and top-k proposals, losses within RTOL_LOSS; every backward
     kernel call of the step, on its own inputs, as close to the f64 VJP as the plain
     f32 one (F64_RATIO); every parameter gradient within RTOL_GRAD (L2) and
     RTOL_GRAD_MAX (largest entry) of the plain step's, beside the count of samples
     that fall in another grid cell in one step than in the other;
  8. the pretraining path: ``gomatching_tpu_torch.train_net.main`` (--task spotter) at
     TRAIN_SIZE 1280 over a synthetic dataset of 720x1280 images with text boxes; finite
     losses, moved parameters, a checkpoint that loads back strictly, each of B1-B4
     launched 6 x steps times; ms/step, images/s and peak memory over the steps after
     warm-up; host wall per stage; one step under torch.profiler.
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
# f32 atomics reorder the dValue sums, and x is rounded another way than grid_sample's
RTOL_BWD = 1e-4
RTOL_LOSS = 1e-4
# Each backward kernel call of a step, on its own inputs: max |g_kernel - g_f64| <=
# max(F64_RATIO * max |g_plain_f32 - g_f64|, RTOL_BWD * max |g_f64|), per gradient
# (the kernel is as close to the f64 VJP as the plain f32 one, up to atomics' order).
F64_RATIO = 2.0
# The step as a whole, kernels vs plain, per parameter: |dg|_2 <= RTOL_GRAD * |g|_2 and
# max |dg| <= RTOL_GRAD_MAX * max |g|. The two steps' forwards differ in the last bits,
# so a few samples fall in another grid cell in one than in the other; each then takes
# the bilinear derivative of the other side, which moves single entries of the
# gradients upstream (phase 7 counts those samples). Read on an NVIDIA H100 80GB HBM3,
# 700 W: 1.7e-2 at point_embed, while each kernel call is as exact as the plain one.
RTOL_GRAD = 1e-2
RTOL_GRAD_MAX = 5e-2
TRAIN_SHAPES = [(160, 160), (80, 80), (40, 40), (20, 20)]  # 1280x1280 at strides 8..64
TRAIN_SIZE = 1280
N_TRAIN_STEPS, N_TRAIN_WARMUP = 8, 3
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


def value_reads(torch, loc, S, D, shapes=SHAPES):
    """What this run's locations need of value (B, S, M, D): the distinct
    (batch, token, head) rows that an in-range bilinear corner touches, read once,
    and the number of corner taps (taps outside the map read nothing).
    loc (B, Lq, M, L, P, 2) normalized; the kernel's x = loc * W - 0.5."""
    B, _, M = loc.shape[:3]
    touched = torch.zeros(B * S * M, dtype=torch.bool, device=loc.device)
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    m = torch.arange(M, device=loc.device).view(1, 1, M, 1)
    taps, start = 0, 0
    for lvl, (h, w) in enumerate(shapes):
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
        refs = spotter.select_proposals(*spotter.encoder_proposals(enc_k))
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


def device_rows(torch, prof):
    """(self device us, count, name) of each kernel and copy, largest first: not the host
    ops launching them, and not user annotations (such as ``Optimizer.step``), which
    repeat their kernels' time."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)), reverse=True)


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
    rows = device_rows(torch, prof)
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
    for name, layers in ((da.ENCODER, t.ENC_LAYERS), (da.QUERIES, t.DEC_LAYERS),
                         (da.ENCODER_BWD, 0), (da.QUERIES_BWD, 0)):
        want = layers * n_batches
        check(counts[name] == want, f"{name}: {counts[name]} launches, expected {want}")
    return counts


def off_grid(torch, x, margin=1e-3):
    """Move pixel coordinates that lie within ``margin`` of a grid line off it: the
    bilinear derivative jumps there, and two right versions that round x differently
    may take either side."""
    r = torch.round(x)
    f = x - r
    return torch.where(f.abs() < margin, r + torch.where(f < 0, -margin, margin), x)


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_backward(torch, da):
    """Each backward kernel against its plain version at the pretraining shapes;
    returns the kernels-line records (sans launches)."""
    shapes = TRAIN_SHAPES
    S = sum(h * w for h, w in shapes)
    Lq = NQ * NPTS
    g = torch.Generator().manual_seed(2)
    dev = "cuda"
    value = torch.randn(1, S, M, D, generator=g).to(dev)
    records = {}
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)

    # B3: arbitrary locations, some outside [0, 1], none on a grid line
    loc = (torch.rand(1, Lq, M, L, P, 2, generator=g) * 1.2 - 0.1).to(dev)
    loc = (off_grid(torch, loc * wh[:, None, :] - 0.5) + 0.5) / wh[:, None, :]
    attn = torch.randn(1, Lq, M, L * P, generator=g).softmax(-1).view(1, Lq, M, L, P).to(dev)
    dout = torch.randn(1, Lq, M * D, generator=g).to(dev)
    args3 = (value, shapes, loc, attn, dout)

    # B4: raw offsets of a few cells, some far beyond the map, none on a grid line
    # (x = ref * W + off - 0.5 at the sample's level W; ref * W is a multiple of 1/16)
    off = torch.randn(1, S, M, L, P, 2, generator=g) * 4.0
    far = torch.rand(1, S, M, L, P, 2, generator=g) < 0.01
    off = torch.where(far, off * 100.0, off).to(dev)
    ref_px = (da.encoder_reference_points(shapes, dev)[None, :, None, None, None, :]
              * wh[None, None, None, :, None, :])
    off = off_grid(torch, ref_px + off - 0.5) + 0.5 - ref_px
    logits = torch.randn(1, S, M, L * P, generator=g).to(dev)
    dout4 = torch.randn(1, S, M * D, generator=g).to(dev)
    args4 = (value, shapes, off, logits, dout4)
    enc_loc = (ref_px + off) / wh[None, None, None, :, None, :]
    del ref_px

    cases = [
        (da.QUERIES_BWD, da.ms_deform_attn_queries_backward,
         da.ms_deform_attn_queries_plain_backward, args3, loc, Lq, ("value", "loc", "attn"),
         "gomatching_tpu/ops/deform_attn_dec_vmem.py:83", 30),
        (da.ENCODER_BWD, da.ms_deform_attn_encoder_backward,
         da.ms_deform_attn_encoder_plain_backward, args4, enc_loc, S,
         ("value", "offsets", "logits"), "gomatching_tpu/ops/deform_attn_vmem.py:473", 60),
    ]
    for name, kernel, plain, args, sample_loc, n_q, grad_names, replaces, ops_per_sample in cases:
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        errs = {n: rel_err(a, b) for n, a, b in zip(grad_names, got, want)}
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for n, e in errs.items():
            check(math.isfinite(e) and e <= RTOL_BWD, f"{name}: d{n} relative error {e}")
        ms = cuda_time_ms(lambda: kernel(*args))
        plain_ms = cuda_time_ms(lambda: plain(*args), iters=5, warmup=1)
        v_bytes, taps = value_reads(torch, sample_loc, S, D, shapes)
        samples = n_q * M * L * P
        # bytes: touched value rows read once; dValue (zeroed first) and the other two
        # gradients written once; the per-sample inputs and dOut read once.
        # operations, the fewest the function needs: per in-range corner tap one dot
        # sum_d dOut[d] * v_corner[d] (2D) and the dValue scale-and-add (2D); per sample
        # attn * dOut (D) and the scalars (coordinates, corner weights, softmax), from
        # which the four corner dots give dAttn, dx and dy without further channel work
        b_ms, b_by = bound(v_bytes + nbytes(*args[2:], *got),
                           samples * (ops_per_sample + D) + taps * 4 * D)
        records[name] = dict(
            name=name, route="cuda", source="gomatching_tpu_torch/csrc/ms_deform_attn.cu",
            replaces=replaces, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        )
        print(f"[6] {name}: max|kernel-plain|/max|plain| "
              + ", ".join(f"d{n} {e:.3e}" for n, e in errs.items())
              + f" (rtol {RTOL_BWD}); max abs {abs_err:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {v_bytes / 1e6:.1f} MB of value "
              f"rows touched of {nbytes(value) / 1e6:.1f} MB) at B=1, {n_q} queries")
        del got, want
    return records


def train_cfg(extra=()):
    from gomatching_tpu_torch.config import setup_train_cfg

    return setup_train_cfg(CONFIG, ["MODEL.WEIGHTS", "''", "SEED", "1", *extra])


def random_targets(rng, cfg, n_valid=20):
    t = cfg.MODEL.TRANSFORMER
    G, npts, voc = cfg.TPU.MAX_GT, t.NUM_POINTS, t.VOC_SIZE
    lengths = rng.randint(1, 11, (1, G, 1))
    return {
        "valid": np.arange(G)[None] < n_valid,
        "labels": np.zeros((1, G), np.int32),
        "ctrl_points": rng.rand(1, G, npts, 2).astype(np.float32),
        "bd_points": rng.rand(1, G, npts, 4).astype(np.float32),
        "texts": np.where(np.arange(25)[None, None] < lengths,
                          rng.randint(0, voc - 1, (1, G, 25)), voc).astype(np.int32),
        "beziers": rng.rand(1, G, 4, 2).astype(np.float32),
    }


def sample_cells(torch, da, kind, shapes, a):
    """Per level, the grid cell (floor x, floor y, as int32) of every sample and whether
    the sample is in range, computed in f64 from the sampler's input ``a``: normalized
    locations (decoder) or offsets in cells from each token's centre (encoder)."""
    a = a.double()
    if kind == "encoder":
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=a.dtype, device=a.device)
        a = (da.encoder_reference_points(shapes, a.device).double()[None, :, None, None, None, :]
             + a / wh[None, None, None, :, None, :])
    cells = []
    for lvl, (h, w) in enumerate(shapes):
        x = a[:, :, :, lvl, :, 0] * w - 0.5
        y = a[:, :, :, lvl, :, 1] * h - 0.5
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
        cells.append((x.floor().int(), y.floor().int(), inside))
    return cells


def phase_train_step(torch, da):
    """One full-width pretraining step with the kernels, with the plain versions, and
    with the plain versions in float64; each backward kernel call of the kernel step
    against the plain backward in f32 and in f64 on the same inputs."""
    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.models.spotter import MSDeformAttn

    cfg = train_cfg()
    trainer = SpotterPretrainer(cfg, generator=torch.Generator().manual_seed(1))
    # the offset and attention projections start at zero kernels, which puts every
    # encoder sample exactly on a grid line, where the gradient is a subgradient either
    # side may take (not compared); small random kernels move them off
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in trainer.model.modules():
            if isinstance(mod, MSDeformAttn):
                for lin, scale in ((mod.sampling_offsets, 0.05), (mod.attention_weights, 0.1)):
                    lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * scale)
    rng = np.random.RandomState(4)
    image = rng.randn(1, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
    imgs, tg = trainer.to_device(image, random_targets(rng, cfg))
    named = dict(trainer.model.named_parameters())
    spotter = trainer.model.detection_transformer
    # what each step's samplers saw (the cell of every sample, and the top-k proposals,
    # a sort that a near-tie could order another way), and every backward kernel call
    # of the kernel step with its inputs and outputs
    seen = {}
    bwd_calls = []

    def watch(tag, kind, fn):
        def sampler(value, shapes, a, b):
            seen[tag]["cells"].append((kind, sample_cells(torch, da, kind, shapes, a.detach())))
            return fn(value, shapes, a, b)
        return sampler

    def watch_bwd(kind, fn):
        def backward(*args):
            out = fn(*args)
            bwd_calls.append((kind, args, out))
            return out
        return backward

    def select(enc_class, enc_coords):
        seen[tag]["topk"] = torch.sort(enc_class, dim=1, descending=True,
                                       stable=True).indices[:, :spotter.num_queries]
        return type(spotter).select_proposals(spotter, enc_class, enc_coords)

    def grads():
        return {n: p.grad.detach().double().clone() for n, p in named.items()
                if p.grad is not None}

    saved = (spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries,
             da.ms_deform_attn_encoder_backward, da.ms_deform_attn_queries_backward)
    spotter.select_proposals = select
    results = {}
    try:
        for tag in ("kernels", "plain", "f64"):
            seen[tag] = {"cells": []}
            kernels = tag == "kernels"
            spotter_mod.ms_deform_attn_encoder = watch(tag, "encoder", (
                saved[0] if kernels else da.ms_deform_attn_encoder_plain))
            spotter_mod.ms_deform_attn_queries = watch(tag, "decoder", (
                saved[1] if kernels else da.ms_deform_attn_queries_plain))
            da.ms_deform_attn_encoder_backward = (
                watch_bwd("encoder", saved[2]) if kernels else saved[2])
            da.ms_deform_attn_queries_backward = (
                watch_bwd("decoder", saved[3]) if kernels else saved[3])
            if tag == "kernels":
                da.reset_launch_counts()
                losses, matches = trainer.forward_backward(imgs, tg)
                counts = dict(da.launch_counts)
            elif tag == "plain":
                losses, matches = trainer.forward_backward(imgs, tg)
            else:
                # the same step in float64 at the kernel step's matches (the criterion
                # computes the losses in f32, as the JAX one does)
                model = trainer.model.double()
                tg64 = {k: v.double() if v.is_floating_point() else v for k, v in tg.items()}
                model.zero_grad(set_to_none=True)
                out = model(imgs.double())
                losses = trainer.criterion(out, tg64, num_inst=tg64["valid"].sum().float(),
                                           matches=results["kernels"][1])
                losses["total_loss"] = torch.stack(list(losses.values())).sum()
                losses["total_loss"].backward()
                matches, out = None, None
            results[tag] = ({k: v.item() for k, v in losses.items()}, matches, grads())
    finally:
        (spotter_mod.ms_deform_attn_encoder, spotter_mod.ms_deform_attn_queries,
         da.ms_deform_attn_encoder_backward, da.ms_deform_attn_queries_backward) = saved
        del spotter.select_proposals
    (lk, mk, gk), (lp, mp, gp), (l64, _, g64) = (results[t] for t in ("kernels", "plain", "f64"))

    t = cfg.MODEL.TRANSFORMER
    check(counts == {da.ENCODER: t.ENC_LAYERS, da.QUERIES: t.DEC_LAYERS,
                     da.ENCODER_BWD: t.ENC_LAYERS, da.QUERIES_BWD: t.DEC_LAYERS},
          f"train step launches {counts}")
    for k in mk:
        check(torch.equal(mk[k], mp[k]), f"train step: matches {k} differ")
    for tag in ("plain", "f64"):
        check(torch.equal(seen[tag]["topk"], seen["kernels"]["topk"]),
              f"train step: the {tag} step chose other top-k proposals")
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)
    loss64 = {n: max(abs(ls[k] - l64[k]) / max(abs(l64[k]), 1e-12) for k in l64)
              for n, ls in (("kernels", lk), ("plain", lp))}
    check(set(gk) == set(gp) == set(g64), "train step: different parameters got gradients")
    print(f"[7] pretraining step, kernels vs plain: {len(mk)} matches and the top-"
          f"{spotter.num_queries} proposals identical; losses max rel err {loss_err:.3e} (rtol "
          f"{RTOL_LOSS}); vs the f64 step {loss64['kernels']:.3e} (kernels), "
          f"{loss64['plain']:.3e} (plain); total loss {lk['total_loss']:.4f}")

    # each backward kernel call on the step's own inputs, against the plain backward in
    # f32 and in f64: max |error| / max |f64 gradient|, the worst over the calls
    worst = {}
    for kind, args, got in bwd_calls:
        plain = (da.ms_deform_attn_encoder_plain_backward if kind == "encoder"
                 else da.ms_deform_attn_queries_plain_backward)
        names = ("value", "offsets", "logits") if kind == "encoder" else ("value", "loc", "attn")
        want32 = plain(*args)
        want64 = plain(*(a.double() if torch.is_tensor(a) else a for a in args))
        for name, k_, p_, e_ in zip(names, got, want32, want64):
            scale = e_.abs().max().clamp(min=1e-30)
            ek = ((k_.double() - e_).abs().max() / scale).item()
            ep = ((p_.double() - e_).abs().max() / scale).item()
            w = worst.setdefault((kind, name), [0.0, 0.0, 0.0])
            w[0], w[1] = max(w[0], ek), max(w[1], ep)
            w[2] = max(w[2], ek / max(F64_RATIO * ep, RTOL_BWD))
        del want32, want64
    print("[7]   backward kernel calls of the step vs f64 on their inputs (kernel; plain f32): "
          + "; ".join(f"{kind} d{name} {ek:.2e}; {ep:.2e}"
                      for (kind, name), (ek, ep, _) in worst.items()))
    for (kind, name), (ek, ep, r) in worst.items():
        check(r <= 1.0, f"train step: {kind} d{name} of a backward kernel call is {ek} off the "
              f"f64 gradient, the plain f32 backward {ep} (limit max({F64_RATIO} x plain, "
              f"{RTOL_BWD}))")
    del bwd_calls

    # samples that lie in another grid cell in the kernel step than in the plain step:
    # there the bilinear derivative of each takes another side of a grid line
    crossed = {"encoder": [0, 0], "decoder": [0, 0]}
    for (kind, ck), (_, cp) in zip(seen["kernels"]["cells"], seen["plain"]["cells"]):
        for (xk, yk, ik), (xp, yp, ip) in zip(ck, cp):
            crossed[kind][0] += xk.numel()
            crossed[kind][1] += int((((xk != xp) | (yk != yp)) & (ik | ip)).sum().item())
    print("[7]   samples in another grid cell in the kernel step than in the plain step: "
          + ", ".join(f"{kind} {c} of {n}" for kind, (n, c) in crossed.items()))

    def err(a, b, n, norm):
        if norm == "l2":
            return ((a[n] - b[n]).norm() / b[n].norm().clamp(min=1e-30)).item()
        return ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)).item()

    def med(errs):
        return sorted(errs.values())[len(errs) // 2]

    l2 = {n: err(gk, gp, n, "l2") for n in gp}
    mx = {n: err(gk, gp, n, "max") for n in gp}
    for label, errs in (("|dg|_2/|g|_2 kernels vs plain", l2), ("max|dg|/max|g| kernels vs plain", mx),
                        ("max|dg|/max|g| kernels vs f64", {n: err(gk, g64, n, "max") for n in gp}),
                        ("max|dg|/max|g| plain vs f64", {n: err(gp, g64, n, "max") for n in gp})):
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        print(f"[7]   {label}, worst: " + "; ".join(f"{n} {e:.3e}" for n, e in top)
              + f"; median {med(errs):.3e} ({len(errs)} parameters)")
    check(all(math.isfinite(v) for v in lk.values()) and loss_err <= RTOL_LOSS,
          f"train step: losses differ by {loss_err} (relative)")
    for errs, tol in ((l2, RTOL_GRAD), (mx, RTOL_GRAD_MAX)):
        name = max(errs, key=errs.get)
        check(errs[name] <= tol, f"train step: gradient of {name} differs by {errs[name]}")
    del trainer, model


def write_train_dataset(root, n_images=4):
    """n_images random 720x1280 images, each with 8 quadrilateral text boxes."""
    import cv2

    rng = np.random.RandomState(5)
    images, annotations = [], []
    for i in range(n_images):
        fn = f"{i}.jpg"
        cv2.imwrite(os.path.join(root, fn), rng.randint(0, 255, (720, 1280, 3), np.uint8))
        images.append({"id": i + 1, "file_name": fn, "height": 720, "width": 1280})
        for j in range(8):
            x0, y0 = rng.randint(40, 1000), rng.randint(40, 620)
            w, h = rng.randint(60, 240), rng.randint(20, 60)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                "poly": [x0, y0, x0 + w, y0 + 3, x0 + w, y0 + h, x0, y0 + h - 3],
                "transcription": "".join(rng.choice(list("abcdefgh0123"), rng.randint(1, 9))),
            })
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "text"}]}, f)
    return root, path


def phase_train(torch, da):
    """The pretraining path through its entry point; returns its launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.models.gomatching import build_pretrain_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    with tempfile.TemporaryDirectory() as tmp:
        register_dataset("chip_smoke_pretrain", *write_train_dataset(tmp))
        out_dir = os.path.join(tmp, "out")
        opts = ["DATASETS.TRAIN", "('chip_smoke_pretrain',)", "OUTPUT_DIR", out_dir,
                "INPUT.TRAIN_SIZE", str(TRAIN_SIZE), "SOLVER.CHECKPOINT_PERIOD",
                str(N_TRAIN_STEPS)]
        argv = ["--config-file", CONFIG, "--task", "spotter", "--max-iter", str(N_TRAIN_STEPS),
                "--opts", "MODEL.WEIGHTS", "''", "SEED", "1", *opts]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        da.reset_launch_counts()
        history = train_net.main(argv)
        torch.cuda.synchronize()
        counts = dict(da.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        cfg = train_cfg(opts)
        t = cfg.MODEL.TRANSFORMER
        check(len(history) == N_TRAIN_STEPS, f"{len(history)} steps ran")
        check(all(math.isfinite(h["total_loss"]) for h in history), "non-finite loss")
        for name, layers in ((da.ENCODER, t.ENC_LAYERS), (da.QUERIES, t.DEC_LAYERS),
                             (da.ENCODER_BWD, t.ENC_LAYERS), (da.QUERIES_BWD, t.DEC_LAYERS)):
            want = layers * N_TRAIN_STEPS
            check(counts[name] == want, f"{name}: {counts[name]} launches, expected {want}")
        ckpt = os.path.join(out_dir, "checkpoints", f"spotter_{N_TRAIN_STEPS:07d}.pth")
        sd = load_checkpoint(ckpt)
        load_weights(build_pretrain_model(cfg), sd)
        init = init_state_dict(cfg, torch.Generator().manual_seed(1), pretrain=True)
        moved = sum(not torch.equal(sd[k], init[k]) for k in init)
        check(moved > 0 and set(sd) == set(init), f"{moved} of {len(init)} tensors moved")
        # the whole iteration: image read, augmentation, resize, targets and the step
        steps = sorted(h["step_s"] * 1e3 for h in history[N_TRAIN_WARMUP:])
        med = steps[len(steps) // 2]
        data = sorted(h["data_s"] * 1e3 for h in history[N_TRAIN_WARMUP:])
        print(f"[8] pretraining CLI: {N_TRAIN_STEPS} steps at {TRAIN_SIZE}x{TRAIN_SIZE}, "
              f"losses {history[0]['total_loss']:.4f} -> {history[-1]['total_loss']:.4f}; "
              f"checkpoint loads back strict, {moved} of {len(init)} tensors moved; "
              f"launches {counts}")
        print(f"[8] steps {N_TRAIN_WARMUP + 1}-{N_TRAIN_STEPS}: median {med:.1f} ms/step "
              f"(min {steps[0]:.1f}, max {steps[-1]:.1f}) from image read to optimizer step, "
              f"{1e3 / med:.3f} images/s; of it the data stage (read, augment, resize, "
              f"targets) median {data[len(data) // 2]:.1f} ms; peak memory "
              f"{peak / 2**30:.2f} GiB")

    # host wall per stage, synchronizing at the stage boundaries, and one step under the
    # profiler: a fresh trainer on one seeded batch
    trainer = SpotterPretrainer(cfg)
    rng = np.random.RandomState(6)
    image = rng.randn(1, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
    targets = random_targets(rng, cfg)
    for _ in range(2):
        trainer.step(image, targets)  # warm-up
    trainer.stage_times = {}
    for _ in range(3):
        trainer.step(image, targets)
    st = trainer.stage_times
    total = sum(st.values())
    print("[8] host wall per step by stage (synchronized; ms): " + ", ".join(
        f"{k} {v / 3 * 1e3:.1f}" for k, v in st.items())
        + f"; costs + hungarian {100 * (st['costs'] + st['hungarian']) / total:.1f}% of the "
        "step")
    trainer.stage_times = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.step(image, targets)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(torch, prof)
    if not rows:
        print("[8] profiler: no device time recorded (not measured)")
        return counts
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[8] profiled step: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% of wall; profiler on) in "
          f"{sum(r[1] for r in rows)} kernels and copies")
    for t_us, n, key in rows[:15]:
        print(f"[8]   {t_us / 1e3:9.3f} ms {100 * t_us / 1e3 / busy:5.1f}% x{n:<5d} {key[:90]}")
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
    del predictor
    bwd_records = phase_backward(torch, da)
    phase_train_step(torch, da)
    train_counts = phase_train(torch, da)

    kernels = []
    for name, rec in [*records.items(), *bwd_records.items()]:
        # the forwards' launches are the inference path's, the backwards' the pretraining's
        rec = dict(rec, launches=(counts if name in records else train_counts)[name])
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
