"""Deformable attention from the corner-merged table (B5, ``TPU.SAMPLING_IMPL 'pallas'``).

Counterpart of ``gomatching_tpu/ops/deform_attn_pallas.py`` (``ms_deform_attn_pallas``,
the TPU kernel ``_sampling_kernel``) and of the merged-table half of
``gomatching_tpu/ops/deform_attn.py`` (``_merged_corner_table`` :26,
``_merged_indices_and_slot_weights`` :61, ``ms_deform_attn_core`` :128). The function
is B1's (exact ``grid_sample`` semantics, zero padding, align_corners=False), computed
another way: row ``s`` of the table holds the four bilinear corners of token ``s``
side by side, so a sample is one clamped base row and four slot weights.

Plain versions (all torch): ``merged_corner_table``, ``merged_indices_and_slot_weights``
and ``ms_deform_attn_merged_plain`` (the gather and sum; also the port of JAX's
``ms_deform_attn_core``, the 'xla' sampler).

``ms_deform_attn_merged`` takes B1's contract: value (B, S, M, D), locations
(B, Lq, M, L, P, 2) normalized, attention (B, Lq, M, L, P) -> (B, Lq, M*D). On CPU
tensors it runs the plain version. On CUDA tensors it launches two kernels of
``csrc/ms_deform_attn.cu``, or raises: the table build (``merged_table``,
``ms_deform_attn_merged_table``; JAX builds the table with XLA outside the Pallas
kernel, and a torch gather took 5.5x its byte bound on an H100) and B5 on the table
(``merged_sample``, ``ms_deform_attn_merged_fwd``); it needs D == 32 and L*P <= 64
there. It has no backward: the TPU kernel has none and JAX trains through 'tiled' when
'pallas' is asked for (``gomatching_tpu/config.py:417-425``), so it raises when grad is
enabled and an input requires grad. Launches count in ``deform_attn.launch_counts``
under ``MERGED`` and ``MERGED_TABLE``.

A bfloat16 value (``MODEL.PRECISION`` bfloat16 under 'pallas') takes two bf16 kernels of
their own (``ms_deform_attn_merged_table_bf16``, a bf16 table that copies the value's bits;
``ms_deform_attn_merged_fwd_bf16``, two heads a warp), both reading 16-byte words
(``MERGED_WIDTH``), counted under ``MERGED_TABLE_BF16`` and ``MERGED_BF16``, with
locations and attention in f32: as JAX's ``ms_deform_attn_pallas``
builds the table in value's dtype, widens each row to f32, multiplies it by f32 slot
weights, sums in f32 and casts the output to value's dtype once. The plain version does
the same on the CPU. Any other dtype mix raises ValueError on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .deform_attn import (
    _MAX_LEVELS,
    _MAX_SAMPLES,
    KERNEL_D,
    LANE_WIDTHS,
    MERGED,
    MERGED_BF16,
    MERGED_TABLE,
    MERGED_TABLE_BF16,
    MERGED_WIDTH,
    Shapes,
    _launch,
    _level_slices,
    _on_cpu,
    _queries_dims,
    _shape_key,
    kernel_dtype,
)


def _corner_rows(spatial_shapes: Shapes, device=None) -> torch.Tensor:
    """(S, 4) token index of each slot of each row: (0,0), (0,+x), (+y,0), (+y,+x)
    within the row's level, clamped to the last row/column (edge duplicates)."""
    rows = []
    for s0, _, h, w in _level_slices(spatial_shapes):
        r = torch.arange(h, device=device)[:, None]
        c = torch.arange(w, device=device)[None, :]
        r1, c1 = (r + 1).clamp(max=h - 1), (c + 1).clamp(max=w - 1)
        slots = [r * w + c, r * w + c1, r1 * w + c, r1 * w + c1]
        rows.append(torch.stack([t.expand(h, w) for t in slots], -1).reshape(h * w, 4) + s0)
    return torch.cat(rows, 0)


def merged_corner_table(value_bm: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    """(B, M, S, D) level-concatenated values -> the (B, M, S, 4D) corner-merged table
    (JAX ``_merged_corner_table``, edge-duplicate padding). ``value_bm`` may be a
    permuted view; the table is a new contiguous tensor."""
    B, M, S, D = value_bm.shape
    rows = _corner_rows(spatial_shapes, value_bm.device).reshape(-1)
    return value_bm.index_select(2, rows).view(B, M, S, 4 * D)


def merged_indices_and_slot_weights(
    sampling_locations: torch.Tensor, attention_weights: torch.Tensor, spatial_shapes: Shapes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base (top-left, clamped) table row and per-slot weights of every sample (JAX
    ``_merged_indices_and_slot_weights``): idx (B, M, Lq, L*P) int64, slot_w
    (B, M, Lq, L*P, 4) with the attention folded in."""
    B, Lq, M, L, P, _ = sampling_locations.shape
    dev = sampling_locations.device
    loc = sampling_locations.permute(0, 2, 1, 3, 4, 5).float()  # (B, M, Lq, L, P, 2)
    attn = attention_weights.permute(0, 2, 1, 3, 4).float()  # (B, M, Lq, L, P)
    hs = torch.tensor([h for h, _ in spatial_shapes], dtype=torch.float32, device=dev)
    ws = torch.tensor([w for _, w in spatial_shapes], dtype=torch.float32, device=dev)
    starts = torch.tensor([s0 for s0, _, _, _ in _level_slices(spatial_shapes)], device=dev)
    hs, ws, starts = (t.view(1, 1, 1, L, 1) for t in (hs, ws, starts))

    x = loc[..., 0] * ws - 0.5
    y = loc[..., 1] * hs - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    # 1-wide / 1-tall levels: the upper clamp is 0, not W-2 (JAX :98-101)
    base_x = torch.minimum(x0.clamp(min=0.0), (ws - 2.0).clamp(min=0.0))
    base_y = torch.minimum(y0.clamp(min=0.0), (hs - 2.0).clamp(min=0.0))

    def axis_slot_weights(c0, frac, base, size):
        zero = torch.zeros_like(frac)
        w_lo = torch.where(base == c0, 1.0 - frac, zero) + torch.where(base == c0 + 1, frac, zero)
        w_hi = (torch.where(base + 1 == c0, 1.0 - frac, zero)
                + torch.where(base + 1 == c0 + 1, frac, zero))
        # the +1 slot past the level's edge holds a duplicate, not a zero (JAX :110)
        return w_lo, torch.where(base + 1 <= size - 1, w_hi, zero)

    wx0, wx1 = axis_slot_weights(x0, dx, base_x, ws)
    wy0, wy1 = axis_slot_weights(y0, dy, base_y, hs)
    slot_w = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1) * attn[..., None]
    idx = starts + base_y.long() * ws.long() + base_x.long()
    return idx.reshape(B, M, Lq, L * P), slot_w.reshape(B, M, Lq, L * P, 4)


def ms_deform_attn_merged_plain(value: torch.Tensor, spatial_shapes: Shapes,
                                sampling_locations: torch.Tensor,
                                attention_weights: torch.Tensor) -> torch.Tensor:
    """Table, indices and slot weights, then a gather of whole merged rows and the
    weighted sum over (samples, slots), in query chunks that keep the gathered rows
    under ~256 MB. value (B, S, M, D) -> (B, Lq, M*D). A bf16 value gives a bf16 table
    whose rows the f32 slot weights scale in f32 (torch widens bf16 against f32 exactly);
    the f32 sums are rounded to bf16 once."""
    B, S, M, D = value.shape
    Lq, LP = sampling_locations.shape[1], attention_weights.shape[3] * attention_weights.shape[4]
    table = merged_corner_table(value.permute(0, 2, 1, 3), spatial_shapes)
    idx, slot_w = merged_indices_and_slot_weights(sampling_locations, attention_weights,
                                                  spatial_shapes)
    chunk = max(1, (1 << 28) // (B * M * LP * 4 * D * 4))
    outs = []
    for q0 in range(0, Lq, chunk):
        i = idx[:, :, q0:q0 + chunk]
        n = i.shape[2]
        g = torch.gather(table, 2, i.reshape(B, M, n * LP, 1).expand(-1, -1, -1, 4 * D))
        g = g.view(B, M, n, LP, 4, D)
        outs.append((g * slot_w[:, :, q0:q0 + chunk, :, :, None]).sum((3, 4)))
    out = torch.cat(outs, 2)  # (B, M, Lq, D)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


def merged_table(value: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    """The corner-merged table of value (B, S, M, D) -> (B, M, S, 4D) in value's dtype
    (float32 or bfloat16): the plain version on CPU tensors, the
    ``ms_deform_attn_merged_table`` kernel (``_bf16`` on bf16 value) on CUDA ones
    (D == 32)."""
    bf16 = kernel_dtype(MERGED_TABLE, value) == torch.bfloat16
    if _on_cpu(value):
        return merged_corner_table(value.permute(0, 2, 1, 3), spatial_shapes)
    B, S, M, D = value.shape
    if D != KERNEL_D or not 1 <= len(spatial_shapes) <= _MAX_LEVELS:
        raise ValueError(f"{MERGED_TABLE}: the kernel takes D == {KERNEL_D} and 1..{_MAX_LEVELS} "
                         f"levels; got value {tuple(value.shape)}, {len(spatial_shapes)} levels")
    name, c_fn = ((MERGED_TABLE_BF16, "ms_deform_attn_merged_table_bf16") if bf16
                  else (MERGED_TABLE, "ms_deform_attn_merged_table"))
    return _launch(name, c_fn, {"value": value}, spatial_shapes, [((B, M, S, 4 * D), False)],
                   (B, S, M, D, len(spatial_shapes)), value_dtype=value.dtype,
                   widths={"value": MERGED_WIDTH})[0]


def merged_sample(table: torch.Tensor, spatial_shapes: Shapes, sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor) -> torch.Tensor:
    """B5 on a prebuilt table (B, M, S, 4*32) of float32 or bfloat16, with float32
    locations and attention: launches the kernel (``_bf16`` on a bf16 table; CUDA tensors
    only) -> (B, Lq, M*32) in the table's dtype."""
    bf16 = kernel_dtype(MERGED, table, sampling_locations,
                        attention_weights) == torch.bfloat16
    if _on_cpu(table, sampling_locations, attention_weights):
        raise ValueError(f"{MERGED}: the kernel takes CUDA tensors; on the CPU "
                         "ms_deform_attn_merged runs the plain version")
    B, M, S, D4 = table.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (D4 != 4 * KERNEL_D or L * P > _MAX_SAMPLES or L > _MAX_LEVELS
            or sampling_locations.shape[:3] != (B, Lq, M)
            or attention_weights.shape != (B, Lq, M, L, P)):
        raise ValueError(f"{MERGED}: the kernel takes D == {KERNEL_D} and L*P <= "
                         f"{_MAX_SAMPLES}; got table {tuple(table.shape)} and locations "
                         f"{tuple(sampling_locations.shape)}")
    name, c_fn = ((MERGED_BF16, "ms_deform_attn_merged_fwd_bf16") if bf16
                  else (MERGED, "ms_deform_attn_merged_fwd"))
    return _launch(name, c_fn,
                   {"table": table, "sampling_locations": sampling_locations,
                    "attention_weights": attention_weights},
                   spatial_shapes, [((B, Lq, M * KERNEL_D), False)],
                   (B, S, Lq, M, KERNEL_D, L, P), S=S, value_dtype=table.dtype,
                   widths={**LANE_WIDTHS, "table": MERGED_WIDTH})[0]


def ms_deform_attn_merged(value: torch.Tensor, spatial_shapes: Shapes,
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """B5: deformable attention through the corner-merged table, forward only.

    value (B, S, M, D) float32 or bfloat16; sampling_locations (B, Lq, M, L, P, 2)
    normalized; attention_weights (B, Lq, M, L, P) softmaxed over (L, P), float32 on the
    card -> (B, Lq, M*D) in value's dtype.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        raise RuntimeError(f"{MERGED} has no backward (TPU.SAMPLING_IMPL 'pallas' is an "
                           "inference sampler); run it under torch.no_grad()")
    if _on_cpu(value, sampling_locations, attention_weights):
        return ms_deform_attn_merged_plain(value, spatial_shapes, sampling_locations,
                                           attention_weights)
    # refuse a dtype mix before the table kernel launches, not after it
    kernel_dtype(MERGED, value, sampling_locations, attention_weights)
    _queries_dims(value, spatial_shapes, sampling_locations, attention_weights, MERGED)
    shapes = _shape_key(spatial_shapes)
    return merged_sample(merged_table(value, shapes), shapes, sampling_locations.contiguous(),
                         attention_weights.contiguous())
