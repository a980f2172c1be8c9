"""Random-row gather reduced to one number (T1): the port's gather rate probe.

Counterpart of the TPU probe ``tools/bench_pallas_gather.py`` (kernels ``kernel`` :49,
f32 table, and ``kernel_b`` :82, bf16 table, each in a ``pallas_call`` at :57 / :90):
``out = sum_g sum_r sum_c v[idx[g, r], c]``, accumulated in f32. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the hand-written sm_90a
kernel in ``csrc/probes.cu`` (deterministic: per-block partials, then one block) or
raises; there is no fallback. Each launch adds one to ``launch_counts[GATHER]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .deform_attn import _on_cpu

GATHER = "gather_rows_sum"

# launches of the kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {GATHER: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gather_rows_sum": [_P, _P, _P, _P, ctypes.c_int64, _I, _I, _I, _P],
    "gather_rows_sum_blocks": [ctypes.c_int64],
}
_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    launch_counts[GATHER] = 0


def gather_rows_sum_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_select`` of the flattened indices, then the f32 sum: (1, 1) f32."""
    return torch.index_select(v, 0, idx.reshape(-1)).float().sum().reshape(1, 1)


def gather_rows_sum(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """T1: v (R, C) f32 or bf16, idx (n, k) int32 -> (1, 1) f32, the sum of every
    element of every gathered row.

    Every index must lie in [0, R), as in the TPU probe: the kernel does not check
    them (an index out of range reads outside the table)."""
    if v.dim() != 2 or v.dtype not in _TABLE_DTYPES:
        raise ValueError(f"{GATHER}: v must be (R, C) float32 or bfloat16, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"{GATHER}: idx must be (n, k) int32, got {tuple(idx.shape)} {idx.dtype}")
    if _on_cpu(v, idx):
        return gather_rows_sum_plain(v, idx)
    if not (v.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{GATHER}: v and idx must be contiguous")
    from ._build import load

    lib = load("probes.cu", _SIGNATURES)
    n_rows = idx.numel()
    blocks = lib.gather_rows_sum_blocks(n_rows)
    partials = torch.empty(blocks, dtype=torch.float32, device=v.device)
    out = torch.empty(1, 1, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.gather_rows_sum(v.data_ptr(), idx.data_ptr(), partials.data_ptr(),
                                 out.data_ptr(), n_rows, v.shape[1],
                                 int(v.dtype == torch.bfloat16), blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{GATHER}: CUDA launch failed with cudaError {rc}")
    launch_counts[GATHER] += 1
    return out
