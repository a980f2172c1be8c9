"""Sampler benchmark: every encoder deformable-attention sampler of the port on one input.

    python -m gomatching_tpu_torch.tools.bench_deform_attn [--size 1000x1778] [--batch 3]
        [--halo 5] [--block 8] [--impl gather,encoder,merged,vmem,vmem_tm,vmem_v3,fused]
        [--tilesets "8x16,8x16,8x16,8x16;16x16,16x16,16x16,16x16"] [--offset-cells 3]
        [--seed 0] [--iters 10] [--dtype bfloat16] [--cpu]

The port's counterpart of tools/bench_deform_attn.py and of tools/bench_vmem_v2.py's
tile sweep. Encoder self-attention at the levels of a ``--size`` input (strides 8-64),
M = 8 heads of D = 32, L = P = 4, on one seeded input: value, reference points plus
uniform offsets of up to ``--offset-cells`` target cells, and attention normalized over
(L, P). ``--dtype`` bfloat16 (the default) makes the inputs in JAX's benchmark's dtypes
(tools/bench_deform_attn.py:30-50): value and attention rounded to bf16, locations and
offsets f32; every sampler then runs its bf16-value kernel, and the attention goes in
widened exactly to f32, as the kernels take their weights (JAX's kernels widen it too).
``--dtype float32`` keeps everything f32, as the port's earlier records were taken. Each
implementation gets the same samples in its own layout:

  gather   B1, ``ms_deform_attn_queries`` (normalized locations)
  encoder  B2, ``ms_deform_attn_encoder`` (offsets in cells, logits = log attention)
  merged   B5 with its table build, ``ms_deform_attn_merged``
  vmem     B6a, ``ms_deform_attn_encoder_vmem`` (natural layout)
  vmem_tm  B6a, ``ms_deform_attn_encoder_vmem_tm`` (tile-major locT/attnT)
  vmem_v3  B6b, ``ms_deform_attn_encoder_vmem_v3`` (tile-major offT/attnT)
  fused    B6c, ``ms_deform_attn_encoder_fused`` (its own square tiles)

``--tilesets`` (``;``-separated, one ``TYxTX`` per level) sweeps the query tiles of vmem,
vmem_tm and vmem_v3. For each run it prints ms per call (CUDA events, median of 5
windows of ``--iters`` calls), max |output - exact| against B1's plain version
(``grid_sample``) in f32 on the same (bf16-valued) inputs (vmem_v3 on its real tokens; B2
on the attention its softmax of the logits gives);
in bf16 also the most an output exceeds one rounding of the exact value
(``round_excess``: |output - exact| - (2**-8 |exact| + 3e-5), <= 0 when every output is
within half a bf16 ulp plus the f32 sums' reordering); and for the footprint entries the
share of in-map corner taps read from shared memory per (source, target) level pair. It runs on the current CUDA device and raises without one;
``--cpu`` runs the plain versions at a small default size (times are then the CPU's).
``main(argv)`` returns the results as a dict.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gomatching_tpu_torch import resolve_device
from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_fused as daf
from gomatching_tpu_torch.ops import deform_attn_merged as dam
from gomatching_tpu_torch.ops import deform_attn_vmem as dav

IMPLS = ("gather", "encoder", "merged", "vmem", "vmem_tm", "vmem_v3", "fused")
SWEPT = ("vmem", "vmem_tm", "vmem_v3")  # the implementations --tilesets applies to
M, D, P = 8, 32, 4
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def level_shapes(h: int, w: int):
    return [(-(-h // s), -(-w // s)) for s in (8, 16, 32, 64)]


def parse_tilesets(spec: str):
    return [tuple(tuple(int(v) for v in t.split("x")) for t in ts.split(","))
            for ts in spec.split(";") if ts]


def make_inputs(shapes, B: int, offset_cells: float, seed: int):
    """value (B, S, M, D); offsets (B, S, M, L, P, 2) in target cells; locations =
    reference + offsets / (W, H); attention (B, S, M, L, P) normalized over (L, P); all
    f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    refs = []
    for h, w in shapes:
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        refs.append(np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    off = rng.uniform(-offset_cells, offset_cells, (B, S, M, L, P, 2)).astype(np.float32)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    loc = (ref + off / wh[None, None, None, :, None, :]).astype(np.float32)
    attn = rng.rand(B, S, M, L, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return value, off, loc, attn


def layouts(impl, shapes, tiles, value, off, loc, attn, halo, block):
    """(call, to natural order, Footprints or None, locations in the kernel's query
    order) of one implementation on these inputs."""
    B, S = value.shape[:2]
    L = len(shapes)
    natural = (lambda out: out)
    if impl == "gather":
        return lambda: da.ms_deform_attn_queries(value, shapes, loc, attn), natural, None, None
    if impl == "encoder":
        logits = attn.log().reshape(B, S, M, L * P)
        return (lambda: da.ms_deform_attn_encoder(value, shapes, off, logits), natural, None,
                None)
    if impl == "merged":
        return lambda: dam.ms_deform_attn_merged(value, shapes, loc, attn), natural, None, None
    if impl == "vmem":
        fp = dav.vmem_footprints(da.VMEM, shapes, P, halo, block, tiles)
        return (lambda: dav.ms_deform_attn_encoder_vmem(value, shapes, loc, attn, halo, block,
                                                        tiles), natural, fp, loc)
    if impl == "fused":
        fp = daf.fused_footprints(shapes, P, halo, block)
        return (lambda: daf.ms_deform_attn_encoder_fused(value, shapes, loc, attn, halo, block),
                natural, fp, loc)
    perm = torch.from_numpy(dav.tile_major_perm(shapes, tiles)[0].astype(np.int64)).to(
        value.device)
    S_tm = perm.numel()
    if impl == "vmem_tm":
        fp = dav.vmem_footprints(da.VMEM_TM, shapes, P, halo, block, tiles, S_tm)
        locT = loc[:, perm].permute(0, 2, 3, 4, 5, 1).contiguous()
        attnT = attn[:, perm].permute(0, 2, 3, 4, 1).contiguous()
        return (lambda: dav.ms_deform_attn_encoder_vmem_tm(value, shapes, locT, attnT, halo,
                                                           block, tiles), natural, fp,
                loc[:, perm])
    if impl == "vmem_v3":
        fp = dav.vmem_footprints(da.VMEM_V3, shapes, P, halo, block, tiles, S_tm)
        offT = off[:, perm].permute(0, 3, 5, 2, 4, 1).reshape(B, 2 * L * M * P, S_tm).contiguous()
        attnT = attn[:, perm].permute(0, 3, 2, 4, 1).reshape(B, L * M * P, S_tm).contiguous()
        inv = torch.from_numpy(dav.tile_major_inverse(shapes, tiles).astype(np.int64)).to(
            value.device)
        loc_tm = dav.v3_locations(shapes, offT, attnT, M, tiles)[0]
        return (lambda: dav.ms_deform_attn_encoder_vmem_v3(value, shapes, offT, attnT, halo,
                                                           block, tiles),
                lambda out: out[:, inv], fp, loc_tm)
    raise ValueError(f"unknown implementation {impl!r}; expected one of {IMPLS}")


def time_ms(fn, device, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``iters`` calls (CUDA events on the
    card; the host clock on the CPU)."""
    fn()
    times = []
    for _ in range(windows if device.type == "cuda" else 1):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default=None, help="input HxW (default 1000x1778; 64x112 with --cpu)")
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--halo", type=int, default=5, help="TPU.TILED_HALO: footprint margin")
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--impl", default=",".join(IMPLS))
    ap.add_argument("--tilesets", default="8x16,8x16,8x16,8x16")
    ap.add_argument("--offset-cells", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="value and attention: bf16 as JAX's benchmark, or f32")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    size = args.size or ("64x112" if args.cpu else "1000x1778")
    shapes = level_shapes(*(int(x) for x in size.split("x")))
    impls = [i for i in args.impl.split(",") if i]
    tilesets = parse_tilesets(args.tilesets)
    dtype = DTYPES[args.dtype]
    value, off, loc, attn = (torch.from_numpy(a).to(device) for a in make_inputs(
        shapes, args.batch, args.offset_cells, args.seed))
    # JAX's dtypes: value and attention in bf16 (the kernels take the attention widened)
    value = value.to(dtype)
    attn = attn.to(dtype).float()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU (plain versions)")
    print(f"levels={shapes} S={value.shape[1]} B={args.batch} M={M} D={D} P={P} "
          f"halo={args.halo} block={args.block} offsets<={args.offset_cells} cells, value "
          f"{args.dtype}, on {where}")
    results: List[Dict] = []
    with torch.no_grad():
        want = da.ms_deform_attn_queries_plain(value.float(), shapes, loc, attn)
        # B2 softmaxes its logits (log attention): the attention it samples with is
        # normalized again, which moves bf16-rounded attention off its sum of 1
        enc_attn = attn.log().flatten(-2).softmax(-1).view(attn.shape)
        want_enc = da.ms_deform_attn_queries_plain(value.float(), shapes, loc, enc_attn)
        for impl in impls:
            for tiles in (tilesets if impl in SWEPT else [None]):
                call, to_natural, fp, fp_loc = layouts(impl, shapes, tiles, value, off, loc,
                                                       attn, args.halo, args.block)
                out = to_natural(call())
                if out.dtype != dtype:
                    raise RuntimeError(f"{impl}: a {out.dtype} output from {dtype} value")
                exact = want_enc if impl == "encoder" else want
                diff = (out.float() - exact).abs()
                err = diff.max().item()
                ms = time_ms(call, device, args.iters)
                res = dict(impl=impl, tiles=tiles, dtype=args.dtype, ms=ms, max_abs_err=err)
                line = f"{impl:8s} " + (f"tiles={'/'.join(f'{a}x{b}' for a, b in tiles)} "
                                        if tiles else "") + f"{ms:9.4f} ms/call  max|err| {err:.3e}"
                if dtype == torch.bfloat16:
                    res["round_excess"] = (diff - (2.0**-8 * exact.abs() + 3e-5)).max().item()
                    line += f"  round_excess {res['round_excess']:.3e}"
                del out, diff
                if fp is not None:
                    share = dav.staged_share(fp, shapes, fp_loc)
                    smem, taps = (sum(v[k] for v in share.values()) for k in (0, 1))
                    res["staged"] = {f"{a}->{b}": v for (a, b), v in share.items()}
                    res["staged_share"] = smem / max(taps, 1)
                    pairs = ", ".join(f"{a}->{b} {100 * s / max(t, 1):.0f}%"
                                      for (a, b), (s, t) in share.items())
                    line += f"  staged {100 * smem / max(taps, 1):.1f}% of corner taps ({pairs})"
                print(line, flush=True)
                results.append(res)
    return {"shapes": shapes, "batch": args.batch, "dtype": args.dtype, "device": where,
            "results": results}


if __name__ == "__main__":
    main()
