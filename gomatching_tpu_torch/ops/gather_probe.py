"""Random-row gather reduced to one number (T1): the port's gather rate probe.

Counterpart of the TPU probe ``tools/bench_pallas_gather.py`` (kernels ``kernel`` :49,
f32 table, and ``kernel_b`` :82, bf16 table, each in a ``pallas_call`` at :57 / :90):
``out = sum_g sum_r sum_c v[idx[g, r], c]``, accumulated in f32. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the hand-written sm_90a
kernels in ``csrc/probes.cu`` (the indices sorted by table slice, then every row
gathered from its slice in shared memory; deterministic) or raises; there is no
fallback. Each launch adds one to ``launch_counts[GATHER]``.

``slice_plan`` cuts the table into the slices the kernel copies into shared memory, and
``scratch_sizes`` mirrors the C entry ``gather_rows_sum_scratch``, which sizes the
scratch the wrapper allocates; the constants below are those of the .cu file.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .deform_attn import _on_cpu

GATHER = "gather_rows_sum"

# launches of the kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {GATHER: 0}

# the slice plan and pass A's grid: T1_SLICE_BYTES, T1_SLICE_ALIGN_ROWS, T1_MAX_SLICES,
# T1_SORT_WARPS and T1_WARP_ELEMS of csrc/probes.cu
SLICE_BYTES = 231424
SLICE_ALIGN_ROWS = 8
MAX_SLICES = 32
SORT_WARPS = 16
WARP_ELEMS = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "gather_rows_sum": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _P],
    "gather_rows_sum_scratch": [_I64, _I, _I, ctypes.POINTER(_I64)],
}
_TABLE_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    launch_counts[GATHER] = 0


def gather_rows_sum_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_select`` of the flattened indices, then the f32 sum: (1, 1) f32."""
    return torch.index_select(v, 0, idx.reshape(-1)).float().sum().reshape(1, 1)


def slice_plan(R: int, C: int, elem_size: int) -> Tuple[int, int]:
    """(rows per slice, slices) of an (R, C) table of ``elem_size``-byte elements: the
    most rows whose bytes fit SLICE_BYTES, a multiple of SLICE_ALIGN_ROWS (so that every
    slice starts on a 16-byte boundary); slice s holds rows [s * rows, min(R, (s + 1) *
    rows)). Raises ValueError when fewer than SLICE_ALIGN_ROWS rows fit or the table
    needs more than MAX_SLICES slices."""
    row_bytes = C * elem_size
    rows = SLICE_BYTES // row_bytes // SLICE_ALIGN_ROWS * SLICE_ALIGN_ROWS
    if R < 1 or rows < SLICE_ALIGN_ROWS:
        raise ValueError(f"{GATHER}: a table of {R} rows of {row_bytes} bytes has no slice plan "
                         f"({SLICE_ALIGN_ROWS} rows must fit {SLICE_BYTES} bytes)")
    n_slices = -(-R // rows)
    if n_slices > MAX_SLICES:
        raise ValueError(f"{GATHER}: a table of {R} rows of {row_bytes} bytes needs {n_slices} "
                         f"slices, more than {MAX_SLICES}")
    return rows, n_slices


def scratch_sizes(n_rows: int, n_slices: int, n_blocks: int) -> Tuple[int, ...]:
    """Int32 words of each piece of the kernel's scratch, as ``gather_rows_sum_scratch``
    gives them: the sorted rows, pass A's per-warp counts, its per-block counts and their
    scan, the buckets' starts, and pass B's partials (``n_blocks``, one a block)."""
    per = SORT_WARPS * WARP_ELEMS
    blocks = -(-n_rows // per) if n_rows > 0 else 1
    return (n_rows, blocks * SORT_WARPS * n_slices, n_slices * blocks + 1, n_slices + 1,
            n_blocks)


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
    if v.data_ptr() % 16:
        raise ValueError(f"{GATHER}: v must start on a 16-byte boundary (its slices are "
                         f"copied with cp.async.bulk)")
    from ._build import load

    lib = load("probes.cu", _SIGNATURES)
    (R, C), n_rows = v.shape, idx.numel()
    rows, n_slices = slice_plan(R, C, v.element_size())
    n_blocks = torch.cuda.get_device_properties(v.device).multi_processor_count
    sizes = (_I64 * 5)()
    rc = lib.gather_rows_sum_scratch(n_rows, n_slices, n_blocks, sizes)
    if rc != 0:
        raise RuntimeError(f"{GATHER}: gather_rows_sum_scratch failed with cudaError {rc}")
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=v.device)
    out = torch.empty(1, 1, dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.gather_rows_sum(v.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                                 out.data_ptr(), n_rows, R, C, int(v.dtype == torch.bfloat16),
                                 rows, n_slices, n_blocks, stream)
    if rc != 0:
        raise RuntimeError(f"{GATHER}: CUDA launch failed with cudaError {rc}")
    launch_counts[GATHER] += 1
    return out
