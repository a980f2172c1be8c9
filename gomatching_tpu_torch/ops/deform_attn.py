"""Multi-scale deformable attention: the two forwards and their backwards.

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

On a CPU tensor a wrapper runs the plain version, which autograd differentiates. On a
CUDA tensor it launches the hand-written sm_90a kernel in ``csrc/ms_deform_attn.cu`` or
raises; there is no fallback. On CUDA each op is a ``torch.autograd.Function`` whose
backward is a kernel too:

``ms_deform_attn_queries_backward``  (B3) B1's VJP; replaces
    ``gomatching_tpu/ops/deform_attn_dec_vmem.py:_bwd_kernel`` (via ``_op_bwd``).
``ms_deform_attn_encoder_backward``  (B4) B2's VJP, through the softmax to the logits;
    replaces ``gomatching_tpu/ops/deform_attn_vmem.py:_bwd_kernel_v2`` (via
    ``_v2_bwd_impl``), exact over the whole level.

The plain backwards (``*_plain_backward``) are ``torch.autograd.grad`` through the plain
forwards; the tests and ``chip_smoke.py`` hold the kernels against them.

A bfloat16 value (``MODEL.PRECISION`` bfloat16, the frozen spotter) takes B1's and B2's
bf16 variants, the same kernels instantiated for bf16 value and output
(``ms_deform_attn_queries_bf16``, ``ms_deform_attn_encoder_bf16``; the bf16 runs of the
same TPU kernels): locations, offsets, attention and logits stay float32, the sums are f32
and the output is rounded once to bf16. Their plain versions (``*_plain_bf16``) widen the
value to f32, run the plain sampler and round the output. They have no backward: the bf16
spotter is frozen. B5 with its table and the footprint entries take bf16 value the same
way (``ops/deform_attn_merged.py``, ``ops/deform_attn_vmem.py``; ``kernel_dtype`` names
the dtype mixes their kernels take), counted under the ``*_BF16`` names. B1-B4 take
D == 32 channels per head (one float4 per lane and corner) within the limits that
``check_lane_layout`` names (through autograd B3 meets only what B1's forward already
took). The source note in the .cu file gives each
kernel's design and what bounds it on an H100. Each
launch adds one to ``launch_counts[name]``, which also counts the
launches of B5 and of its table build (``ms_deform_attn_merged``,
``ms_deform_attn_merged_table``; ``ops/deform_attn_merged.py``) and of the four
footprint entries (``ms_deform_attn_encoder_vmem``, ``..._vmem_tm``, ``..._vmem_v3``,
``ops/deform_attn_vmem.py``; ``ms_deform_attn_encoder_fused``,
``ops/deform_attn_fused.py``), whose kernels live in the same .cu file.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Shapes = Sequence[Tuple[int, int]]

QUERIES = "ms_deform_attn_queries"
ENCODER = "ms_deform_attn_encoder"
QUERIES_BF16 = "ms_deform_attn_queries_bf16"
ENCODER_BF16 = "ms_deform_attn_encoder_bf16"
QUERIES_BWD = "ms_deform_attn_queries_bwd"
ENCODER_BWD = "ms_deform_attn_encoder_bwd"
MERGED = "ms_deform_attn_merged"
MERGED_TABLE = "ms_deform_attn_merged_table"
VMEM = "ms_deform_attn_encoder_vmem"
VMEM_TM = "ms_deform_attn_encoder_vmem_tm"
VMEM_V3 = "ms_deform_attn_encoder_vmem_v3"
FUSED = "ms_deform_attn_encoder_fused"
# the same kernels on bf16 value
MERGED_BF16 = "ms_deform_attn_merged_bf16"
MERGED_TABLE_BF16 = "ms_deform_attn_merged_table_bf16"
VMEM_BF16 = "ms_deform_attn_encoder_vmem_bf16"
VMEM_TM_BF16 = "ms_deform_attn_encoder_vmem_tm_bf16"
VMEM_V3_BF16 = "ms_deform_attn_encoder_vmem_v3_bf16"
FUSED_BF16 = "ms_deform_attn_encoder_fused_bf16"

# launches of each hand-written kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {
    name: 0 for name in (QUERIES, ENCODER, QUERIES_BWD, ENCODER_BWD, MERGED, MERGED_TABLE, VMEM,
                         VMEM_TM, VMEM_V3, FUSED, QUERIES_BF16, ENCODER_BF16, MERGED_BF16,
                         MERGED_TABLE_BF16, VMEM_BF16, VMEM_TM_BF16, VMEM_V3_BF16, FUSED_BF16)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ms_deform_attn_queries_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_encoder_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_queries_fwd_bf16": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                        _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_encoder_fwd_bf16": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                        _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_queries_bwd": [_P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_encoder_bwd": [_P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(_I),
                                   _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_merged_fwd": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                  _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_merged_table": [_P, _P, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_merged_fwd_bf16": [_P, _P, _P, _P, ctypes.POINTER(_I),
                                       _I, _I, _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_merged_table_bf16": [_P, _P, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _P],
    "ms_deform_attn_footprint_fwd": [_I, _P, _P, _P, _P, _P, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _P],
    "ms_deform_attn_footprint_fwd_bf16": [_I, _P, _P, _P, _P, _P, ctypes.POINTER(_I),
                                          ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _P],
    "ms_deform_attn_kernel_info": [_I, _I, ctypes.POINTER(_I)],
}
_MAX_LEVELS = 8
_MAX_SAMPLES = 64  # L * P per head (MSDA_MAX_SAMPLES of the .cu file)
KERNEL_D = 32  # channels per head of B1-B5: one row word (4 channels) per lane and corner
_MAX_GRID_Y = 65535  # (batch, head) pairs: the grid's y extent
_INT32_MAX = 2**31 - 1


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


def ms_deform_attn_queries_plain_bf16(value, spatial_shapes, sampling_locations,
                                      attention_weights):
    """The bf16 B1's plain version: bf16 value widened to f32, the plain sampler on the f32
    locations and weights, the output rounded to bf16."""
    return ms_deform_attn_queries_plain(value.float(), spatial_shapes, sampling_locations,
                                        attention_weights).to(torch.bfloat16)


def ms_deform_attn_encoder_plain_bf16(value, spatial_shapes, offsets, attn_logits):
    """The bf16 B2's plain version: bf16 value widened to f32, the plain encoder sampler on
    the f32 offsets and logits, the output rounded to bf16."""
    return ms_deform_attn_encoder_plain(value.float(), spatial_shapes, offsets,
                                        attn_logits).to(torch.bfloat16)


def _plain_backward(forward, value, spatial_shapes, a, b, grad_out):
    """VJP of ``forward(value, shapes, a, b)`` at ``grad_out`` by autograd."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (value, a, b)]
        out = forward(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out)


def ms_deform_attn_queries_plain_backward(value, spatial_shapes, sampling_locations,
                                          attention_weights, grad_out):
    """B3's plain version: (dValue, dLoc, dAttn) through ``grid_sample``."""
    return _plain_backward(ms_deform_attn_queries_plain, value, spatial_shapes,
                           sampling_locations, attention_weights, grad_out)


def ms_deform_attn_encoder_plain_backward(value, spatial_shapes, offsets, attn_logits, grad_out):
    """B4's plain version: (dValue, dOffsets, dLogits) through ``grid_sample`` and the
    softmax."""
    return _plain_backward(ms_deform_attn_encoder_plain, value, spatial_shapes, offsets,
                           attn_logits, grad_out)


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


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    if _on_cpu(*tensors):
        raise ValueError(f"{name}: the backward kernel takes CUDA tensors; on the CPU "
                         f"autograd differentiates the plain forward")


def _launch(name: str, c_fn: str, inputs: Dict[str, torch.Tensor], spatial_shapes: Shapes,
            outs: Sequence[Tuple[Tuple[int, ...], bool]],
            dims: Tuple[int, ...], S: Optional[int] = None,
            value_dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Validate the inputs, allocate the outputs ((shape, zeroed) each) and launch
    ``c_fn`` on the current stream; raise on a refused launch. ``inputs`` are passed
    in order, then the outputs, the level shapes and ``dims``. ``S`` (tokens) defaults
    to the first input's dimension 1. The first input (value, or B5's table) must be of
    ``value_dtype``, every other input float32 (TypeError otherwise); the outputs take
    ``value_dtype``."""
    S = next(iter(inputs.values())).shape[1] if S is None else S
    if sum(h * w for h, w in spatial_shapes) != S or not 1 <= len(spatial_shapes) <= _MAX_LEVELS:
        raise ValueError(f"{name}: spatial_shapes {spatial_shapes} do not match S={S} "
                         f"(1..{_MAX_LEVELS} levels)")
    for i, (key, t) in enumerate(inputs.items()):
        want = value_dtype if i == 0 else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if _on_cpu(*inputs.values()):
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    from ._build import load

    fn = getattr(load("ms_deform_attn.cu", _SIGNATURES), c_fn)
    device = next(iter(inputs.values())).device
    results = [(torch.zeros if zeroed else torch.empty)(shape, dtype=value_dtype, device=device)
               for shape, zeroed in outs]
    flat = [int(x) for hw in spatial_shapes for x in hw]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(t.data_ptr() for t in inputs.values()), *(r.data_ptr() for r in results),
                (_I * len(flat))(*flat), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    launch_counts[name] += 1
    return results


def kernel_dtype(name: str, value: torch.Tensor, *f32_inputs: torch.Tensor) -> torch.dtype:
    """The value dtype a kernel entry takes: float32 or bfloat16 value (or table) with
    float32 locations, offsets and weights; ValueError for any other mix."""
    if value.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != torch.float32 for t in f32_inputs):
        raise ValueError(f"{name}: the kernels take float32 or bfloat16 value with float32 "
                         f"locations and weights, got {value.dtype} and "
                         f"{[str(t.dtype) for t in f32_inputs]}")
    return value.dtype


def _queries_dims(value, spatial_shapes, sampling_locations, attention_weights, name=QUERIES):
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if (sampling_locations.shape != (B, Lq, M, L, P, 2)
            or attention_weights.shape != (B, Lq, M, L, P) or len(spatial_shapes) != L):
        raise ValueError(f"{name}: shape mismatch {tuple(sampling_locations.shape)} / "
                         f"{tuple(attention_weights.shape)} for value {tuple(value.shape)} "
                         f"and {L} levels")
    return B, S, Lq, M, D, L, P


def _encoder_dims(value, spatial_shapes, offsets, attn_logits, name=ENCODER):
    B, S, M, D = value.shape
    L, P = offsets.shape[3], offsets.shape[4]
    if (offsets.shape != (B, S, M, L, P, 2) or attn_logits.shape != (B, S, M, L * P)
            or len(spatial_shapes) != L):
        raise ValueError(f"{name}: shape mismatch {tuple(offsets.shape)} / "
                         f"{tuple(attn_logits.shape)} for value {tuple(value.shape)} "
                         f"and {L} levels")
    return B, S, M, D, L, P


def check_lane_layout(name: str, B: int, S: int, M: int, D: int, L: int, P: int) -> None:
    """Raise ValueError, naming the limit, for value (B, S, M, D) and L levels of P points
    that the lane-layout kernels (B1-B4) do not take; their C entries refuse the same."""
    if D != KERNEL_D:
        raise ValueError(f"{name}: the kernel takes D == {KERNEL_D} channels per head, got D={D}")
    if not 1 <= P or L * P > _MAX_SAMPLES:
        raise ValueError(f"{name}: the kernel takes 1 <= P and L*P <= {_MAX_SAMPLES} samples "
                         f"per head, got L={L}, P={P}")
    if B * M > _MAX_GRID_Y:
        raise ValueError(f"{name}: the kernel takes B*M <= {_MAX_GRID_Y} (batch, head) pairs, "
                         f"got B={B}, M={M}")
    if S * M * 8 > _INT32_MAX:
        raise ValueError(f"{name}: the kernel takes S*M*8 <= {_INT32_MAX} (the row words of one "
                         f"batch item, 8 a head row: float4s of f32 value, 8-byte words of 4 "
                         f"bf16), got S={S}, M={M}")


def _check_grad_out(name, grad_out, shape):
    if tuple(grad_out.shape) != shape:
        raise ValueError(f"{name}: grad_out has shape {tuple(grad_out.shape)}, expected {shape}")


def ms_deform_attn_queries_backward(value, spatial_shapes, sampling_locations,
                                    attention_weights, grad_out):
    """B3: B1's VJP at ``grad_out`` (B, Lq, M*D) -> (dValue, dLoc, dAttn). CUDA
    tensors only: on the CPU, autograd differentiates the plain forward."""
    _require_cuda(QUERIES_BWD, value, sampling_locations, attention_weights, grad_out)
    B, S, Lq, M, D, L, P = _queries_dims(value, spatial_shapes, sampling_locations,
                                         attention_weights, QUERIES_BWD)
    check_lane_layout(QUERIES_BWD, B, S, M, D, L, P)
    _check_grad_out(QUERIES_BWD, grad_out, (B, Lq, M * D))
    return tuple(_launch(
        QUERIES_BWD, "ms_deform_attn_queries_bwd",
        {"value": value, "sampling_locations": sampling_locations,
         "attention_weights": attention_weights, "grad_out": grad_out.contiguous()},
        spatial_shapes, [((B, S, M, D), True), ((B, Lq, M, L, P, 2), False),
                         ((B, Lq, M, L, P), False)],
        (B, S, Lq, M, D, L, P)))


def ms_deform_attn_encoder_backward(value, spatial_shapes, offsets, attn_logits, grad_out):
    """B4: B2's VJP at ``grad_out`` (B, S, M*D) -> (dValue, dOffsets, dLogits). CUDA
    tensors only: on the CPU, autograd differentiates the plain forward."""
    _require_cuda(ENCODER_BWD, value, offsets, attn_logits, grad_out)
    B, S, M, D, L, P = _encoder_dims(value, spatial_shapes, offsets, attn_logits, ENCODER_BWD)
    check_lane_layout(ENCODER_BWD, B, S, M, D, L, P)
    _check_grad_out(ENCODER_BWD, grad_out, (B, S, M * D))
    return tuple(_launch(
        ENCODER_BWD, "ms_deform_attn_encoder_bwd",
        {"value": value, "offsets": offsets, "attn_logits": attn_logits,
         "grad_out": grad_out.contiguous()},
        spatial_shapes, [((B, S, M, D), True), ((B, S, M, L, P, 2), False),
                         ((B, S, M, L * P), False)],
        (B, S, M, D, L, P)))


class _QueriesFunction(torch.autograd.Function):
    """B1 forward, B3 backward."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights, spatial_shapes):
        dims = _queries_dims(value, spatial_shapes, sampling_locations, attention_weights)
        B, S, Lq, M, D, L, P = dims
        check_lane_layout(QUERIES, B, S, M, D, L, P)
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _launch(QUERIES, "ms_deform_attn_queries_fwd",
                       {"value": value, "sampling_locations": sampling_locations,
                        "attention_weights": attention_weights},
                       spatial_shapes, [((B, Lq, M * D), False)], dims)[0]

    @staticmethod
    def backward(ctx, grad_out):
        return (*ms_deform_attn_queries_backward(ctx.saved_tensors[0], ctx.spatial_shapes,
                                                 *ctx.saved_tensors[1:], grad_out), None)


class _EncoderFunction(torch.autograd.Function):
    """B2 forward, B4 backward."""

    @staticmethod
    def forward(ctx, value, offsets, attn_logits, spatial_shapes):
        dims = _encoder_dims(value, spatial_shapes, offsets, attn_logits)
        check_lane_layout(ENCODER, *dims)
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, offsets, attn_logits)
        B, S, M, D, L, P = dims
        return _launch(ENCODER, "ms_deform_attn_encoder_fwd",
                       {"value": value, "offsets": offsets, "attn_logits": attn_logits},
                       spatial_shapes, [((B, S, M * D), False)], dims)[0]

    @staticmethod
    def backward(ctx, grad_out):
        return (*ms_deform_attn_encoder_backward(ctx.saved_tensors[0], ctx.spatial_shapes,
                                                 *ctx.saved_tensors[1:], grad_out), None)


def _kernel_info(name: str, which: int, smem_bytes: int = 0) -> Dict[str, int]:
    """Registers and local memory a thread, and resident warps per SM at ``smem_bytes`` of
    dynamic shared memory a block, of kernel ``which`` of ``ms_deform_attn_kernel_info``
    as the CUDA runtime reports them for the loaded library (needs a card)."""
    from ._build import load

    fn = load("ms_deform_attn.cu", _SIGNATURES).ms_deform_attn_kernel_info
    info = (_I * 3)()
    rc = fn(which, smem_bytes, info)
    if rc != 0:
        raise RuntimeError(f"{name}: cudaFuncGetAttributes failed with cudaError {rc}")
    return {"registers": info[0], "local_bytes": info[1], "warps_per_sm": info[2]}


def kernel_info() -> Dict[str, Dict[str, int]]:
    """``_kernel_info`` of the lane-layout kernels B1, B2, B4, B5, B3, of B1, B2 and B5 on
    bf16 value, and of B5's table build on f32 and bf16 value."""
    kernels = ((0, QUERIES), (1, ENCODER), (2, ENCODER_BWD), (3, MERGED), (4, QUERIES_BWD),
               (8, QUERIES_BF16), (9, ENCODER_BF16), (10, MERGED_BF16), (15, MERGED_TABLE),
               (11, MERGED_TABLE_BF16))
    return {name: _kernel_info(name, which) for which, name in kernels}


def _shape_key(spatial_shapes: Shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def ms_deform_attn_queries_bf16(value, spatial_shapes, sampling_locations, attention_weights):
    """B1's kernel on bf16 value (the production precision path): value (B, S, M, 32)
    bfloat16, sampling_locations (B, Lq, M, L, P, 2) and attention_weights (B, Lq, M, L, P)
    float32 -> (B, Lq, M*32) bfloat16, the f32 sums rounded once. Any other dtype raises
    TypeError, CPU tensors ValueError. No backward: the bf16 spotter is frozen."""
    dims = _queries_dims(value, spatial_shapes, sampling_locations, attention_weights,
                         QUERIES_BF16)
    B, S, Lq, M, D, L, P = dims
    check_lane_layout(QUERIES_BF16, B, S, M, D, L, P)
    return _launch(QUERIES_BF16, "ms_deform_attn_queries_fwd_bf16",
                   {"value": value, "sampling_locations": sampling_locations,
                    "attention_weights": attention_weights},
                   spatial_shapes, [((B, Lq, M * D), False)], dims,
                   value_dtype=torch.bfloat16)[0]


def ms_deform_attn_encoder_bf16(value, spatial_shapes, offsets, attn_logits):
    """B2's kernel on bf16 value: value (B, S, M, 32) bfloat16, offsets (B, S, M, L, P, 2)
    and attn_logits (B, S, M, L*P) float32 -> (B, S, M*32) bfloat16, the softmax and sums
    f32 and the output rounded once. Any other dtype raises TypeError, CPU tensors
    ValueError. No backward."""
    dims = _encoder_dims(value, spatial_shapes, offsets, attn_logits, ENCODER_BF16)
    check_lane_layout(ENCODER_BF16, *dims)
    B, S, M, D, L, P = dims
    return _launch(ENCODER_BF16, "ms_deform_attn_encoder_fwd_bf16",
                   {"value": value, "offsets": offsets, "attn_logits": attn_logits},
                   spatial_shapes, [((B, S, M * D), False)], dims,
                   value_dtype=torch.bfloat16)[0]


def ms_deform_attn_queries(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """B1: deformable attention for arbitrary normalized locations (B3 its backward).

    value (B, S, M, D); sampling_locations (B, Lq, M, L, P, 2); attention_weights
    (B, Lq, M, L, P), softmaxed over (L, P) -> (B, Lq, M*D). The kernel takes D == 32.
    A bfloat16 value takes B1's bf16 kernel (f32 locations and weights, a bf16 output)
    or, on the CPU, its plain version.
    """
    on_cpu = _on_cpu(value, sampling_locations, attention_weights)
    if value.dtype == torch.bfloat16:
        if on_cpu:
            return ms_deform_attn_queries_plain_bf16(value, spatial_shapes, sampling_locations,
                                                     attention_weights)
        return ms_deform_attn_queries_bf16(value, _shape_key(spatial_shapes),
                                           sampling_locations.contiguous(),
                                           attention_weights.contiguous())
    if on_cpu:
        return ms_deform_attn_queries_plain(
            value, spatial_shapes, sampling_locations, attention_weights
        )
    return _QueriesFunction.apply(value, sampling_locations, attention_weights,
                                  _shape_key(spatial_shapes))


def ms_deform_attn_encoder(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    offsets: torch.Tensor,
    attn_logits: torch.Tensor,
) -> torch.Tensor:
    """B2: encoder self-attention over every token of every level (no padding; B4 its
    backward).

    value (B, S, M, D); offsets (B, S, M, L, P, 2) raw, in target-level cells
    (the ``sampling_offsets`` projection in its (m, l, p, xy) order); attn_logits
    (B, S, M, L*P) before the softmax -> (B, S, M*D). The kernel takes D == 32. A bfloat16
    value takes B2's bf16 kernel (f32 offsets and logits, a bf16 output) or, on the CPU,
    its plain version.
    """
    on_cpu = _on_cpu(value, offsets, attn_logits)
    if value.dtype == torch.bfloat16:
        if on_cpu:
            return ms_deform_attn_encoder_plain_bf16(value, spatial_shapes, offsets, attn_logits)
        return ms_deform_attn_encoder_bf16(value, _shape_key(spatial_shapes),
                                           offsets.contiguous(), attn_logits.contiguous())
    if on_cpu:
        return ms_deform_attn_encoder_plain(value, spatial_shapes, offsets, attn_logits)
    return _EncoderFunction.apply(value, offsets, attn_logits, _shape_key(spatial_shapes))
