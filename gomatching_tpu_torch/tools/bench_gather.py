"""Gather rate probe: how fast the card gathers random table rows (T1).

    python -m gomatching_tpu_torch.tools.bench_gather [--iters 20] [--cpu]

The port's counterpart of tools/bench_pallas_gather.py. It runs that tool's four cases,
with its data from ``np.random.RandomState(0)`` in its order: a table v (R, C) of randn
and indices idx (n, R) uniform in [0, R), at (R, C, n) = (8192, 32, 16), (8192, 128, 16)
and (32768, 32, 64) with an f32 table, and (32768, 32, 64) with a bf16 table. Each case
sums every gathered row to one f32 number with ``gather_rows_sum`` (the kernel on the
card) and prints ms per call (CUDA events, the median of 5 windows of ``--iters`` calls
of one callable), M rows/s and GB/s of gathered bytes (n * R * C * element size per
call), and the same for the library baseline, the counterpart of that tool's XLA
``jnp.take(v, idx, 0).sum()``: ``torch.index_select(v, 0, idx.flatten()).sum(dtype=
torch.float32)``, which writes the gathered array and reads it back. It runs on the
current CUDA device and raises without one; ``--cpu`` runs the plain version at R / 32
(times are then the CPU's). ``main(argv)`` returns the results as a dict.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gomatching_tpu_torch import resolve_device
from gomatching_tpu_torch.ops.gather_probe import gather_rows_sum
from gomatching_tpu_torch.tools.bench_deform_attn import time_ms

# (R, C, n, table dtype), as tools/bench_pallas_gather.py runs them
CASES = ((8192, 32, 16, torch.float32), (8192, 128, 16, torch.float32),
         (32768, 32, 64, torch.float32), (32768, 32, 64, torch.bfloat16))
CPU_SCALE = 32  # --cpu divides R by this


def make_cases(scale: int = 1):
    """[(v, idx)] of the four cases from one RandomState(0): v (R, C) randn in the
    case's dtype, idx (n, R) int32 in [0, R)."""
    rng = np.random.RandomState(0)
    out = []
    for R, C, n, dtype in CASES:
        R //= scale
        v = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dtype)
        idx = torch.from_numpy(rng.randint(0, R, (n, R)).astype(np.int32))
        out.append((v, idx))
    return out


def library_sum(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The library baseline: one ``index_select`` and an f32 sum."""
    return torch.index_select(v, 0, idx.flatten()).sum(dtype=torch.float32)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU (plain version)")
    print(f"gather rate probe on {where}")
    results: List[Dict] = []
    for v, idx in make_cases(CPU_SCALE if args.cpu else 1):
        v, idx = v.to(device), idx.to(device)
        (R, C), n = v.shape, idx.shape[0]
        rows, row_bytes = idx.numel(), C * v.element_size()
        res = dict(R=R, C=C, n=n, dtype=str(v.dtype).replace("torch.", ""),
                   value=gather_rows_sum(v, idx).item(), library_value=library_sum(v, idx).item())
        line = f"R={R} C={C} x{n} {res['dtype']:8s}"
        for key, fn in (("kernel", lambda: gather_rows_sum(v, idx)),
                        ("library", lambda: library_sum(v, idx))):
            ms = time_ms(fn, device, args.iters)
            res[f"{key}_ms"] = ms
            res[f"{key}_rows_per_s"] = rows / ms * 1e3
            res[f"{key}_gb_per_s"] = rows * row_bytes / ms / 1e6
            line += (f"  {key} {ms:8.4f} ms -> {rows / ms / 1e3:7.0f}M rows/s, "
                     f"{rows * row_bytes / ms / 1e6:7.1f} GB/s")
        print(line + f"  (sum {res['value']:.6g}, library {res['library_value']:.6g})", flush=True)
        results.append(res)
    return {"device": where, "results": results}


if __name__ == "__main__":
    main()
