"""One-hot G build probe: f32 against bf16 arithmetic and storage (T2).

    python -m gomatching_tpu_torch.tools.probe_bf16_g [--iters 30] [--cpu]

The port's counterpart of tools/probe_bf16_g.py, at its shape (P = 8, FH = FW = 32,
Q = 256) and on its data (``np.random.RandomState(0)``: x, y uniform in [2, F - 3), a
uniform in [0, 1)). It builds G (FH, FW, Q) with ``onehot_g`` (the kernel on the card)
in that tool's three variants:

  1. f32 arithmetic, f32 out (the production formulation);
  2. bf16 arithmetic, bf16 out (every op rounded to bf16);
  3. f32 arithmetic, bf16 out (halves the stored bytes only).

For each it prints ms per call (CUDA events, the median of 5 windows of ``--iters``
calls of one callable, built once: nothing is rebuilt inside the timing loop), then the
speed ratios against f32 and max |bf16 - f32| over G. At this shape one call's work is
far below a launch's cost. It runs on the current CUDA device and raises without one;
``--cpu`` runs the plain version (times are then the CPU's). ``main(argv)`` returns the
results as a dict.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gomatching_tpu_torch import resolve_device
from gomatching_tpu_torch.ops.onehot_g import onehot_g
from gomatching_tpu_torch.tools.bench_deform_attn import time_ms

P, FH, FW, Q = 8, 32, 32, 256
# name -> (arithmetic, output) dtypes, as tools/probe_bf16_g.py runs them
RUNS = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
        "f32_bf16_out": (torch.float32, torch.bfloat16)}


def make_inputs():
    """x, y (P, Q) uniform in [2, F - 3) and a (P, Q) uniform in [0, 1), f32."""
    rng = np.random.RandomState(0)
    x = rng.uniform(2, FW - 3, (P, Q))
    y = rng.uniform(2, FH - 3, (P, Q))
    a = rng.uniform(0, 1, (P, Q))
    return [torch.from_numpy(t.astype(np.float32)) for t in (x, y, a)]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU (plain version)")
    print(f"one-hot G build probe, P={P} FH={FH} FW={FW} Q={Q}, on {where}")
    x, y, a = (t.to(device) for t in make_inputs())
    ms, out = {}, {}
    for name, (dtype, out_dtype) in RUNS.items():
        def call(dtype=dtype, out_dtype=out_dtype):
            return onehot_g(x, y, a, FH, FW, dtype, out_dtype)

        out[name] = call().float()
        ms[name] = time_ms(call, device, args.iters)
        print(f"{name:13s} median {ms[name]:.4f} ms/call", flush=True)
    err = (out["bf16"] - out["f32"]).abs().max().item()
    err_store = (out["f32_bf16_out"] - out["f32"]).abs().max().item()
    print(f"bf16/f32 speed ratio: {ms['f32'] / ms['bf16']:.2f}x; max |bf16 - f32| {err:.4f} "
          f"(max |G| {out['f32'].abs().max().item():.4f})")
    print(f"mixed/f32 speed ratio: {ms['f32'] / ms['f32_bf16_out']:.2f}x; max |mixed - f32| "
          f"{err_store:.4f}")
    return {"device": where, "ms": ms, "bf16_max_abs_err": err, "mixed_max_abs_err": err_store}


if __name__ == "__main__":
    main()
