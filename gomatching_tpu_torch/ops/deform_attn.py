"""Multi-scale deformable attention: the two forwards the inference path runs.

Numerical spec: the reference oracle ``ms_deform_attn_core_pytorch``
(third_party/adet/layers/ms_deform_attn.py:40-60) -- for every (batch, query, head),
``n_points`` bilinear taps per level with ``grid_sample`` align_corners=False and zero
padding, reduced with softmaxed attention weights. Counterpart of
``gomatching_tpu/ops/deform_attn.py`` (``ms_deform_attn_core`` :128,
``ms_deform_attn_reference`` :201).

Two ops, each a plain PyTorch version plus a wrapper that dispatches on the device of
its inputs:

``ms_deform_attn_queries``  (B1) arbitrary normalized locations + softmaxed attention;
    replaces the TPU kernel ``gomatching_tpu/ops/deform_attn_dec_vmem.py:_kernel``
    (entry ``ms_deform_attn_queries_vmem``), the decoder cross-attention sampler.
``ms_deform_attn_encoder``  (B2) encoder self-attention: queries are the grid tokens,
    inputs are raw offsets in target-level cells and attention logits; replaces
    ``gomatching_tpu/ops/deform_attn_vmem.py:_kernel_v2`` (entry
    ``ms_deform_attn_encoder_vmem_v2``). Exact over the whole level: the TPU kernel
    drops sampling mass beyond its ``TILED_HALO`` footprint, this one does not.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it launches the
hand-written sm_90a kernel in ``csrc/ms_deform_attn.cu`` or raises; there is no
fallback. Both kernels are bound by memory traffic on an H100 (see the source note in
the .cu file for the design). Each launch adds one to ``launch_counts[name]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Shapes = Sequence[Tuple[int, int]]

QUERIES = "ms_deform_attn_queries"
ENCODER = "ms_deform_attn_encoder"

# launches of each hand-written kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {QUERIES: 0, ENCODER: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ms_deform_attn_queries_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_encoder_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _P],
}
_MAX_LEVELS = 8


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _level_slices(spatial_shapes: Shapes) -> List[Tuple[int, int, int, int]]:
    out, start = [], 0
    for h, w in spatial_shapes:
        out.append((start, start + h * w, h, w))
        start += h * w
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ms_deform_attn_queries_plain(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Per-level ``F.grid_sample``, as ``ms_deform_attn_core_pytorch``.

    value (B, S, M, D); sampling_locations (B, Lq, M, L, P, 2) normalized to [0, 1];
    attention_weights (B, Lq, M, L, P) -> (B, Lq, M*D).
    """
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    grids = 2 * sampling_locations - 1
    samples = []
    for lvl, (s0, s1, h, w) in enumerate(_level_slices(spatial_shapes)):
        v = value[:, s0:s1].permute(0, 2, 3, 1).reshape(B * M, D, h, w)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * M, Lq, P, 2)
        samples.append(
            F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        )  # (B*M, D, Lq, P)
    a = attention_weights.permute(0, 2, 1, 3, 4).reshape(B * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * a).sum(-1)  # (B*M, D, Lq)
    return out.view(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)


def encoder_reference_points(spatial_shapes: Shapes, device=None) -> torch.Tensor:
    """(S, 2) grid-cell centres ((col+0.5)/W, (row+0.5)/H) of every token, level by
    level: the encoder's reference points when nothing is padded (valid_ratios=1)."""
    refs = []
    for h, w in spatial_shapes:
        ry, rx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) + 0.5,
            torch.arange(w, dtype=torch.float32, device=device) + 0.5,
            indexing="ij",
        )
        refs.append(torch.stack([rx.reshape(-1) / w, ry.reshape(-1) / h], -1))
    return torch.cat(refs, 0)


def ms_deform_attn_encoder_plain(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    offsets: torch.Tensor,
    attn_logits: torch.Tensor,
) -> torch.Tensor:
    """Reference points + raw offsets, softmax, then the plain B1 sampler.

    value (B, S, M, D); offsets (B, S, M, L, P, 2) in target-level cells;
    attn_logits (B, S, M, L*P) -> (B, S, M*D).
    """
    B, S, M, L, P, _ = offsets.shape
    ref = encoder_reference_points(spatial_shapes, value.device)
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                      device=value.device)
    loc = ref[None, :, None, None, None, :] + offsets / wh[None, None, None, :, None, :]
    attn = attn_logits.softmax(-1).view(B, S, M, L, P)
    return ms_deform_attn_queries_plain(value, spatial_shapes, loc, attn)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs must all lie on the CPU or on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return False


def _launch(name: str, c_fn: str, inputs: Dict[str, torch.Tensor], spatial_shapes: Shapes,
            out_shape: Tuple[int, ...], dims: Tuple[int, ...]) -> torch.Tensor:
    """Validate the inputs, allocate the output and launch ``c_fn`` on the current
    stream; raise on a refused launch. ``inputs`` are passed in order, then the output,
    the level shapes and ``dims``."""
    S = next(iter(inputs.values())).shape[1]
    if sum(h * w for h, w in spatial_shapes) != S or not 1 <= len(spatial_shapes) <= _MAX_LEVELS:
        raise ValueError(f"{name}: spatial_shapes {spatial_shapes} do not match S={S} "
                         f"(1..{_MAX_LEVELS} levels)")
    for key, t in inputs.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the CUDA kernel has no backward yet")
    from ._build import load

    fn = getattr(load("ms_deform_attn.cu", _SIGNATURES), c_fn)
    device = next(iter(inputs.values())).device
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    flat = [int(x) for hw in spatial_shapes for x in hw]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(t.data_ptr() for t in inputs.values()), out.data_ptr(),
                (_I * len(flat))(*flat), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    launch_counts[name] += 1
    return out


def ms_deform_attn_queries(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """B1: deformable attention for arbitrary normalized locations.

    value (B, S, M, D); sampling_locations (B, Lq, M, L, P, 2); attention_weights
    (B, Lq, M, L, P), softmaxed over (L, P) -> (B, Lq, M*D).
    """
    if _on_cpu(value, sampling_locations, attention_weights):
        return ms_deform_attn_queries_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape != (B, Lq, M, L, P, 2)
            or attention_weights.shape != (B, Lq, M, L, P) or len(spatial_shapes) != L):
        raise ValueError(f"{QUERIES}: shape mismatch {tuple(sampling_locations.shape)} / "
                         f"{tuple(attention_weights.shape)} for value {tuple(value.shape)} "
                         f"and {L} levels")
    return _launch(QUERIES, "ms_deform_attn_queries_fwd",
                   {"value": value, "sampling_locations": sampling_locations,
                    "attention_weights": attention_weights},
                   spatial_shapes, (B, Lq, M * D), (B, S, Lq, M, D, L, P))


def ms_deform_attn_encoder(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    offsets: torch.Tensor,
    attn_logits: torch.Tensor,
) -> torch.Tensor:
    """B2: encoder self-attention over every token of every level (no padding).

    value (B, S, M, D); offsets (B, S, M, L, P, 2) raw, in target-level cells
    (the ``sampling_offsets`` projection in its (m, l, p, xy) order); attn_logits
    (B, S, M, L*P) before the softmax -> (B, S, M*D).
    """
    if _on_cpu(value, offsets, attn_logits):
        return ms_deform_attn_encoder_plain(value, spatial_shapes, offsets, attn_logits)
    B, S, M, D = value.shape
    L, P = offsets.shape[3], offsets.shape[4]
    if (offsets.shape != (B, S, M, L, P, 2) or attn_logits.shape != (B, S, M, L * P)
            or len(spatial_shapes) != L):
        raise ValueError(f"{ENCODER}: shape mismatch {tuple(offsets.shape)} / "
                         f"{tuple(attn_logits.shape)} for value {tuple(value.shape)} "
                         f"and {L} levels")
    return _launch(ENCODER, "ms_deform_attn_encoder_fwd",
                   {"value": value, "offsets": offsets, "attn_logits": attn_logits},
                   spatial_shapes, (B, S, M * D), (B, S, M, D, L, P))
