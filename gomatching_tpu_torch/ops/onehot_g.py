"""The bilinear one-hot G build (T2): the port's counterpart of the bf16 G probe.

Counterpart of the TPU probe ``tools/probe_bf16_g.py`` (``_g_kernel`` :35 in a
``pallas_call`` at :68), the standalone form of ``_accum_onehot_g``
(``gomatching_tpu/ops/deform_attn_vmem.py``), the one-hot operand that the TPU's v2
encoder multiplies with a value footprint:

    G[h, w, q] = sum_p a[p, q] * wy_p(h, q) * wx_p(w, q),
    wx_p(w, q) = (w == floor(x) ? 1 - dx : 0) + (w == floor(x) + 1 ? dx : 0),

with x = x[p, q], dx = x - floor(x), and wy the same in y. A tap outside [0, FH) x
[0, FW) drops out. Three variants, as the probe's: f32 arithmetic with f32 out, bf16
arithmetic with bf16 out (every op rounded to bf16), f32 arithmetic with bf16 out. On
a CPU tensor the wrapper runs the plain version; on a CUDA tensor it launches the
hand-written sm_90a kernel in ``csrc/probes.cu`` or raises; there is no fallback. Each
launch adds one to ``launch_counts[ONEHOT]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .deform_attn import _on_cpu

ONEHOT = "onehot_g"

# launches of the kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {ONEHOT: 0}

# (arithmetic, output) dtypes the kernel is built for
VARIANTS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.bfloat16))
_MAX_P = 64  # G_MAX_P of the .cu file

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"onehot_g": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}


def reset_launch_counts() -> None:
    launch_counts[ONEHOT] = 0


def onehot_g_plain(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor, fh: int, fw: int,
                   dtype: torch.dtype = torch.float32,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``_g_kernel``'s arithmetic op by op in ``dtype``: x, y, a (P, Q) -> (FH, FW, Q)
    in ``out_dtype``."""
    P, Q = x.shape
    x, y, a = (t.to(dtype) for t in (x, y, a))
    one = torch.ones((), dtype=dtype, device=x.device)
    zero = torch.zeros((), dtype=dtype, device=x.device)

    def taps(c, n):  # (P, n, Q): the two-tap one-hot of c over 0..n-1
        c0 = torch.floor(c)
        d = (c - c0).reshape(P, 1, Q)
        i = c0.to(torch.int32).reshape(P, 1, Q)
        grid = torch.arange(n, dtype=torch.int32, device=c.device).reshape(1, n, 1)
        return torch.where(grid == i, one - d, zero) + torch.where(grid == i + 1, d, zero)

    xw = taps(x, fw)
    yw = taps(y, fh) * a.reshape(P, 1, Q)
    acc = None
    for p in range(P):
        term = yw[p].reshape(fh, 1, Q) * xw[p].reshape(1, fw, Q)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)


def onehot_g(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor, fh: int, fw: int,
             dtype: torch.dtype = torch.float32,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """T2: x, y (P, Q) coordinates in cells (finite, within int32), a (P, Q) weights,
    all float32 -> G (FH, FW, Q) in ``out_dtype``, computed in ``dtype``;
    (``dtype``, ``out_dtype``) is one of ``VARIANTS``."""
    if (dtype, out_dtype) not in VARIANTS:
        raise ValueError(f"{ONEHOT}: (dtype, out_dtype) must be one of {VARIANTS}, got "
                         f"({dtype}, {out_dtype})")
    if x.dim() != 2 or not 1 <= x.shape[0] <= _MAX_P or y.shape != x.shape or a.shape != x.shape:
        raise ValueError(f"{ONEHOT}: x, y, a must be (P, Q) with 1 <= P <= {_MAX_P}, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(a.shape)}")
    if any(t.dtype != torch.float32 for t in (x, y, a)):
        raise TypeError(f"{ONEHOT}: x, y, a must be float32")
    if _on_cpu(x, y, a):
        return onehot_g_plain(x, y, a, fh, fw, dtype, out_dtype)
    if not all(t.is_contiguous() for t in (x, y, a)):
        raise ValueError(f"{ONEHOT}: x, y, a must be contiguous")
    from ._build import load

    fn = load("probes.cu", _SIGNATURES).onehot_g
    P, Q = x.shape
    out = torch.empty(fh, fw, Q, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), a.data_ptr(), out.data_ptr(), P, fh, fw, Q,
                int(dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"{ONEHOT}: CUDA launch failed with cudaError {rc}")
    launch_counts[ONEHOT] += 1
    return out
