"""Encoder deformable attention staged through tile footprints (B6a, B6b).

Counterpart of ``gomatching_tpu/ops/deform_attn_vmem.py``'s footprint entries and their
geometry: ``ms_deform_attn_encoder_vmem`` :932 and ``ms_deform_attn_encoder_vmem_tm``
:1097 (TPU kernel ``_kernel`` :896, B6a) and ``ms_deform_attn_encoder_vmem_v3`` :793
(``_kernel_v3`` :724, B6b); ``ops/deform_attn_fused.py`` holds the third variant (B6c).
All compute encoder self-attention: every token of every level is a query (Lq = S),
and its four bilinear corners at each (level, point) are weighted by attention, with
``grid_sample`` semantics (zero padding, align_corners=False).

Each TPU kernel stages, for a tile of queries, a footprint of every target level (the
tile's reference region plus ``halo`` cells) in fast memory and drops the samples that
fall beyond it. Here the footprint is a cache and the halo only sizes it: a corner
inside the staged footprint is read from shared memory, any other from device memory,
so the result is exact whatever the halo. The geometry arguments keep JAX's meaning:
``halo``, ``block`` and ``tile_sizes`` size the footprints, and for ``_tm`` and ``_v3``
they also define the tile-major input layout (``tile_major_perm``). JAX's
``interpret`` (the TPU interpreter), ``heads_per_step`` (how many heads one TPU grid
step folds) and ``ablate`` (timing-only ablations with wrong numerics) have no meaning
here and are not taken.

Input layouts, one per entry:
  ``ms_deform_attn_encoder_vmem``     loc (B, S, M, L, P, 2) normalized, attn
      (B, S, M, L, P) softmaxed -> (B, S, M*D) natural token order;
  ``ms_deform_attn_encoder_vmem_tm``  locT (B, M, L, P, 2, S_tm), attnT (B, M, L, P, S_tm)
      on the tile-major token axis -> (B, S, M*D) natural order (filler slots dropped);
  ``ms_deform_attn_encoder_vmem_v3``  offT (B, 2*L*M*P, S_tm) raw offsets in target-level
      cells, rows (l, xy, m, p), attnT (B, L*M*P, S_tm) softmaxed, rows (l, m, p); the
      reference point of each slot comes from its tile and in-tile row and column ->
      (B, S_tm, M*D) tile-major, filler slots computed like any other slot.

On CPU tensors an entry runs its plain version: B1's ``ms_deform_attn_queries_plain``
on natural locations (the tile-major ones converted by ``tm_locations`` /
``v3_locations``). On CUDA tensors it launches ``ms_deform_attn_footprint_fwd`` of
``csrc/ms_deform_attn.cu`` (D == 32, L*P <= 64) or raises; there is no fallback. The
entries are forward only, as in JAX (only v2 has a VJP there): each raises when grad
is enabled and an input requires grad. Launches count in ``deform_attn.launch_counts``
under the entry's name. ``staged_share`` counts, per (source, target) level pair, the
corner taps that the kernel reads from shared memory.

The kernel copies each staged footprint into one of two shared-memory buffers with one
TMA copy (a tensor map per (source, target) pair, encoded per call by the C entry), the
next level's copy in flight while a level is sampled, and samples on B1's lane layout.
``SMEM_BLOCK_BYTES`` sets which pairs are staged.

A bfloat16 value (JAX's dtype in its sampler benchmark, ``tools/bench_deform_attn.py``)
takes the same kernel instantiated for bf16 (``ms_deform_attn_footprint_fwd_bf16``,
counted under the entry's name + ``_bf16``): bf16 footprints of 64-byte cells, so the same
budget stages about twice the cells; locations, offsets and attention stay f32, the
bilinear weight x attention products and the sums are f32 and the output is rounded once
to bf16. JAX's kernels round the one-hot G to bf16 before their product
(``deform_attn_vmem.py:918-919``); keeping it f32 is a difference by design (ROADMAP
section C). The plain versions widen the value to f32, run the exact sampler and round
the output. Any other dtype mix raises ValueError on the card.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._build import load
from .deform_attn import (
    _I,
    _INT32_MAX,
    _MAX_LEVELS,
    _MAX_SAMPLES,
    _SIGNATURES,
    FUSED,
    FUSED_BF16,
    VMEM,
    VMEM_BF16,
    VMEM_TM,
    VMEM_TM_BF16,
    VMEM_V3,
    VMEM_V3_BF16,
    Shapes,
    _kernel_info,
    _on_cpu,
    _queries_dims,
    _shape_key,
    kernel_dtype,
    launch_counts,
    ms_deform_attn_queries_plain,
)

KERNEL_D = 32  # channels per head the kernel takes: one row word (4 channels) per lane
# The kernel's layout codes (``FootprintGeometry`` of the .cu file)
NATURAL_LOC, TM_LOC, TM_OFF_CELLS = 0, 1, 2
QCHUNK = 128  # queries of one block (FP_QCHUNK): a tile with more is split into chunks
NBUF = 2  # footprint buffers of a block (FP_NBUF): one copy in flight while one is sampled
MAX_BOX = 256  # a TMA box's largest extent per dimension (Fh, Fw)
SMEM_MAX_BYTES = 232448  # dynamic shared memory one block may have on an H100 (227 KB)
GEO_STRIDE = QCHUNK + 1  # FP_GEO_STRIDE
# A block's dynamic shared memory (FP_SMEM_BYTES): 128 bytes of alignment slack, the chunk's
# partial outputs (QCHUNK rows of 128 bytes), its geometry (x, y and attention per (level,
# point) and query), NBUF footprint buffers of the largest staged footprint, NBUF 8-byte
# mbarriers. SMEM_BLOCK_BYTES caps it: a (source, target) pair whose footprint does not
# fit a buffer of (SMEM_BLOCK_BYTES - the rest) / NBUF takes the direct route (every
# corner from device memory). The kernel's block (16 warps) is one an SM, so the cap is
# all a block may have (buffers of up to 86 KB at L*P = 16); a cap of 0 stages nothing.
SMEM_BLOCK_BYTES = SMEM_MAX_BYTES


def smem_bytes(fp_bytes: int, L: int, P: int) -> int:
    """A block's dynamic shared memory for footprint buffers of ``fp_bytes`` each."""
    geo = _round_up(3 * L * P * GEO_STRIDE * 4, 128)
    return 128 + QCHUNK * 128 + geo + NBUF * fp_bytes + 8 * NBUF


# ---------------------------------------------------------------------------
# geometry: copies of deform_attn_tiled.py :45-130 and deform_attn_vmem.py :81-176
# ---------------------------------------------------------------------------

# per-source-level query tile edge of the fused (B6c) and tiled paths
_DEFAULT_TILES = (16, 8, 8, 4)
# (ty, tx) query tiles of the vmem paths: 8 rows keep the footprints short, 16 columns
# keep Q = 128 on every level
_VMEM_TILES = ((8, 16), (8, 16), (8, 16), (8, 16))


def _level_starts(spatial_shapes):
    starts, cur = [], 0
    for h, w in spatial_shapes:
        starts.append(cur)
        cur += h * w
    return starts, cur


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _footprint_bounds(n_src: int, tile: int, n_tiles: int, n_tgt: int, n_tgt_pad: int,
                      halo: int, block: int):
    """Per-tile footprint origin and common footprint extent along one axis.

    Source cell k has reference centre (k + 0.5) / n_src * n_tgt - 0.5 in target cells;
    offsets of at most ``halo`` target cells and the bilinear pair (floor, floor + 1)
    stay inside. Returns (origins, F): origins block-aligned and clamped to
    [0, n_tgt_pad - F], F a block multiple (at most n_tgt_pad) covering every tile."""
    scale = n_tgt / n_src
    lo_raw, hi_raw = [], []
    for i in range(n_tiles):
        k_lo = i * tile
        k_hi = min((i + 1) * tile, n_src) - 1
        lo = (k_lo + 0.5) * scale - 0.5 - halo
        hi = (k_hi + 0.5) * scale - 0.5 + halo
        lo_raw.append(int(math.floor(lo)))
        hi_raw.append(int(math.floor(hi)) + 1)
    extent = 0
    origins = []
    for lo, hi in zip(lo_raw, hi_raw):
        o = (lo // block) * block
        origins.append(o)
        extent = max(extent, hi - o + 1)
    F = min(_round_up(extent, block), n_tgt_pad)
    origins = [max(0, min(o, n_tgt_pad - F)) for o in origins]
    return origins, F


def _tile_queries(arr: torch.Tensor, h: int, w: int, ty: int, tx: int):
    """(B, h*w, ...) -> ((T, B, ty*tx, ...), nty, ntx), zero-padding partial edge tiles."""
    B, rest = arr.shape[0], tuple(arr.shape[2:])
    nty, ntx = -(-h // ty), -(-w // tx)
    a = arr.reshape(B, h, w, *rest)
    pad = [0, 0] * len(rest) + [0, ntx * tx - w, 0, nty * ty - h]
    a = torch.nn.functional.pad(a, pad).reshape(B, nty, ty, ntx, tx, *rest)
    a = a.movedim((1, 3), (0, 1))  # (nty, ntx, B, ty, tx, ...)
    return a.reshape(nty * ntx, B, ty * tx, *rest), nty, ntx


def _untile_queries(tiled: torch.Tensor, nty: int, ntx: int, h: int, w: int, ty: int, tx: int):
    """(T, B, Q, ...) -> (B, h*w, ...), dropping edge-tile padding."""
    B, rest = tiled.shape[1], tuple(tiled.shape[3:])
    a = tiled.reshape(nty, ntx, B, ty, tx, *rest).movedim((0, 1), (1, 3))
    a = a.reshape(B, nty * ty, ntx * tx, *rest)
    return a[:, :h, :w].reshape(B, h * w, *rest)


def _norm_tiles(tile_sizes, L):
    tiles = list(tile_sizes) if tile_sizes is not None else list(_VMEM_TILES[:L])
    while len(tiles) < L:
        tiles.append(tiles[-1])
    return [(t, t) if isinstance(t, int) else (int(t[0]), int(t[1])) for t in tiles]


def tile_major_perm(spatial_shapes: Shapes, tile_sizes=None):
    """Token permutation putting each query tile's tokens contiguous.

    Returns (perm (S_tm,) int32, level_info [(start_tm, T, Q, ty, tx, nty, ntx)] per
    level). tx becomes a power of two and the tile rows grow until Q is a multiple of
    128; slots beyond the level (edge tiles, grown rows) are fillers that point at the
    level's first token."""
    tiles = _norm_tiles(tile_sizes, len(spatial_shapes))
    starts, _ = _level_starts(spatial_shapes)
    perm_parts, level_info, pos = [], [], 0
    for l, (H1, W1) in enumerate(spatial_shapes):
        ty, tx = tiles[l]
        ty, tx = min(ty, H1), min(tx, W1)
        tx = 1 << (tx.bit_length() - 1)
        if (ty * tx) % 128:
            ty = -(-(ty * tx) // 128) * 128 // tx
        nty, ntx = -(-H1 // ty), -(-W1 // tx)
        idx = np.zeros((nty * ty, ntx * tx), np.int64)
        iy, ix = np.mgrid[0: nty * ty, 0: ntx * tx]
        valid = (iy < H1) & (ix < W1)
        idx[valid] = starts[l] + (iy * W1 + ix)[valid]
        idx[~valid] = starts[l]
        tiled = idx.reshape(nty, ty, ntx, tx).transpose(0, 2, 1, 3).reshape(-1)
        perm_parts.append(tiled)
        level_info.append((pos, nty * ntx, ty * tx, ty, tx, nty, ntx))
        pos += tiled.size
    return np.concatenate(perm_parts).astype(np.int32), level_info


def tile_major_inverse(spatial_shapes: Shapes, tile_sizes=None) -> np.ndarray:
    """(S,) int32: the tile-major slot of each natural-order token."""
    _, level_info = tile_major_perm(spatial_shapes, tile_sizes)
    S = sum(h * w for h, w in spatial_shapes)
    inv = np.zeros((S,), np.int64)
    starts, _ = _level_starts(spatial_shapes)
    for l, (H1, W1) in enumerate(spatial_shapes):
        pos, T, Q, ty, tx, nty, ntx = level_info[l]
        iy, ix = np.mgrid[0: nty * ty, 0: ntx * tx]
        valid = (iy < H1) & (ix < W1)
        tm_pos = pos + np.arange(T * Q).reshape(nty, ntx, ty, tx).transpose(
            0, 2, 1, 3).reshape(nty * ty, ntx * tx)
        inv[starts[l] + (iy * W1 + ix)[valid]] = tm_pos[valid]
    return inv.astype(np.int32)


def offset_column_perm(M: int, L: int, P: int) -> np.ndarray:
    """Sampling-offsets feature order (m, l, p, xy) -> the offT row order (l, xy, m, p):
    new -> old index."""
    return np.arange(M * L * P * 2).reshape(M, L, P, 2).transpose(1, 3, 0, 2).reshape(
        -1).astype(np.int32)


def attn_column_perm(M: int, L: int, P: int) -> np.ndarray:
    """Attention-weights order (m, l, p) -> the attnT row order (l, m, p)."""
    return np.arange(M * L * P).reshape(M, L, P).transpose(1, 0, 2).reshape(-1).astype(np.int32)


# ---------------------------------------------------------------------------
# the kernel's per-tile table
# ---------------------------------------------------------------------------


class Footprints(NamedTuple):
    """One entry's tile and footprint geometry, and the table its kernel reads.

    ``tiles[l1]`` = (first slot, T, Q, ty, tx, nty, ntx) of source level l1 (first
    slot 0 in the natural layout). ``pairs[l1][l2]`` = (oy (T,), ox (T,), Fh, Fw,
    staged) of the footprint that l1's tiles keep of target level l2. ``table`` (int32):
    L rows (H, W, first token, 0), then one record per block, ``8 + 4 L`` ints:
    (source level, tile row origin, tile column origin, tile width, first query of
    the chunk, queries in the chunk, tile's first slot, 0) and per target level (oy,
    ox, Fh, Fw), all four 0 when the pair takes the direct route. ``boxes`` (int32,
    (L, L, 2)): (Fh, Fw) of each staged pair, the box of its tensor map, 0 for a direct
    pair. ``fp_bytes``: one footprint buffer (the largest staged footprint, in 128-byte
    units); ``smem_bytes``: the block's dynamic shared memory; ``elem_bytes``: the bytes of
    one value element the footprints are sized for (4 f32, 2 bf16)."""

    layout: int
    tiles: Tuple[Tuple[int, ...], ...]
    pairs: Tuple[Tuple[tuple, ...], ...]
    table: np.ndarray
    boxes: np.ndarray
    n_items: int
    fp_bytes: int
    smem_bytes: int
    elem_bytes: int = 4


@functools.lru_cache(maxsize=64)
def footprints(spatial_shapes: Tuple[Tuple[int, int], ...], layout: int,
               tiles: Tuple[Tuple[int, ...], ...], halo: int, block: int, fh_block: int,
               P: int, elem_bytes: int = 4) -> Footprints:
    """Geometry and kernel table for query tiles ``tiles`` (as ``Footprints.tiles``):
    footprints from ``_footprint_bounds`` with x aligned to ``block`` and y to
    ``fh_block`` (1 for the vmem entries, whose TPU windows have exact heights); a pair is
    staged when its footprint of ``elem_bytes`` values, rounded up to 128 bytes, fits a
    buffer under ``SMEM_BLOCK_BYTES`` and a TMA box."""
    L = len(spatial_shapes)
    starts, _ = _level_starts(spatial_shapes)
    budget = (SMEM_BLOCK_BYTES - smem_bytes(0, L, P)) // NBUF
    rows = [[h, w, s, 0] for (h, w), s in zip(spatial_shapes, starts)]
    boxes = np.zeros((L, L, 2), np.int32)
    pairs, fp_bytes = [], 0
    for l1, (H1, W1) in enumerate(spatial_shapes):
        pos, T, Q, ty, tx, nty, ntx = tiles[l1]
        per_l2 = []
        for l2, (H2, W2) in enumerate(spatial_shapes):
            oys, Fh = _footprint_bounds(H1, ty, nty, H2, _round_up(H2, block), halo, fh_block)
            oxs, Fw = _footprint_bounds(W1, tx, ntx, W2, _round_up(W2, block), halo, block)
            nbytes = _round_up(Fh * Fw * KERNEL_D * elem_bytes, 128)
            staged = nbytes <= budget and max(Fh, Fw) <= MAX_BOX
            if staged:
                fp_bytes = max(fp_bytes, nbytes)
                boxes[l1, l2] = (Fh, Fw)
            per_l2.append((np.repeat(np.asarray(oys, np.int64), ntx),
                           np.tile(np.asarray(oxs, np.int64), nty), Fh, Fw, staged))
        pairs.append(tuple(per_l2))
        t = np.arange(T)
        for q0 in range(0, Q, QCHUNK):
            head = np.stack([np.full(T, l1), (t // ntx) * ty, (t % ntx) * tx, np.full(T, tx),
                             np.full(T, q0), np.full(T, min(QCHUNK, Q - q0)), pos + t * Q,
                             np.zeros(T, np.int64)], 1)
            fps = [np.stack([oy, ox, np.full(T, Fh), np.full(T, Fw)], 1) * staged
                   for oy, ox, Fh, Fw, staged in per_l2]
            rows.extend(np.concatenate([head, *fps], 1).tolist())
    table = np.concatenate([np.asarray(part, np.int32).reshape(-1)
                            for part in (rows[:L], rows[L:])])
    return Footprints(layout, tuple(tiles), tuple(pairs), table, boxes, len(rows) - L,
                      fp_bytes, smem_bytes(fp_bytes, L, P), elem_bytes)


def natural_tiles(spatial_shapes: Shapes, tiles) -> Tuple[Tuple[int, ...], ...]:
    """``Footprints.tiles`` of the natural layout for (ty, tx) per level, each clipped to
    its level as the JAX entries do."""
    out = []
    for (H1, W1), (ty, tx) in zip(spatial_shapes, tiles):
        ty, tx = min(ty, H1), min(tx, W1)
        nty, ntx = -(-H1 // ty), -(-W1 // tx)
        out.append((0, nty * ntx, ty * tx, ty, tx, nty, ntx))
    return tuple(out)


# device copies of the tables, by (id of the cached Footprints, device); each entry keeps
# its Footprints alive, so the id is not reused
_device_tables: Dict[Tuple[int, str], Tuple[Footprints, torch.Tensor]] = {}


# the count of each entry's launches on bf16 value
BF16_NAMES = {VMEM: VMEM_BF16, VMEM_TM: VMEM_TM_BF16, VMEM_V3: VMEM_V3_BF16, FUSED: FUSED_BF16}


def _launch(name: str, fp: Footprints, value: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            out_shape: Tuple[int, ...], P: int, Sq: int) -> torch.Tensor:
    """Launch the footprint kernel for ``fp`` on the current stream (its bf16 entry on bf16
    value, counted under ``BF16_NAMES[name]``); raise on a refused launch. ``a``/``b`` are
    the layout's location (or offset) and attention tensors, ``Sq`` the length of their
    token axis (S_tm in the tile-major layouts)."""
    B, S, M, D = value.shape
    L = len(fp.tiles)
    if D != KERNEL_D or L * P > _MAX_SAMPLES or not 1 <= L <= _MAX_LEVELS:
        raise ValueError(f"{name}: the kernel takes D == {KERNEL_D}, L*P <= {_MAX_SAMPLES} and "
                         f"1..{_MAX_LEVELS} levels; got value {tuple(value.shape)}, L={L}, P={P}")
    bf16 = kernel_dtype(name, value, a, b) == torch.bfloat16
    for key, t in (("value", value), ("locations", a), ("attention", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if fp.elem_bytes != value.element_size():
        raise ValueError(f"{name}: footprints sized for {fp.elem_bytes}-byte values, got "
                         f"{value.dtype}")
    if S * M * 8 > _INT32_MAX:
        raise ValueError(f"{name}: the kernel takes S*M*8 <= {_INT32_MAX} (row words of one "
                         f"batch item), got S={S}, M={M}")
    if bf16:
        name = BF16_NAMES[name]
    lib = load("ms_deform_attn.cu", _SIGNATURES)
    fn = lib.ms_deform_attn_footprint_fwd_bf16 if bf16 else lib.ms_deform_attn_footprint_fwd
    key = (id(fp), str(value.device))
    if key not in _device_tables:
        _device_tables[key] = (fp, torch.from_numpy(fp.table).to(value.device))
    table = _device_tables[key][1]
    out = torch.empty(out_shape, dtype=value.dtype, device=value.device)
    shapes = [int(x) for row in fp.table[:4 * L].reshape(L, 4) for x in row[:2]]
    boxes = fp.boxes.reshape(-1).tolist()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = fn(fp.layout, value.data_ptr(), a.data_ptr(), b.data_ptr(),
                table.data_ptr(), out.data_ptr(), (_I * len(shapes))(*shapes),
                (_I * len(boxes))(*boxes),
                B, S, M, D, L, P, fp.n_items, Sq, fp.fp_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    launch_counts[name] += 1
    return out


def footprint_kernel_info(fp: Footprints) -> Dict[str, Dict[str, int]]:
    """``deform_attn._kernel_info`` of the footprint kernel's three instantiations for
    ``fp``'s value type at ``fp.smem_bytes`` of dynamic shared memory a block, by the
    entries that take each."""
    names = {f"{VMEM}, {FUSED} (NATURAL_LOC)": 5, f"{VMEM_TM} (TM_LOC)": 6,
             f"{VMEM_V3} (TM_OFF_CELLS)": 7}
    shift = 7 if fp.elem_bytes == 2 else 0  # the bf16 instantiations are 12-14
    return {name: _kernel_info(name, which + shift, fp.smem_bytes)
            for name, which in names.items()}


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward (nor has its JAX counterpart); run it "
                           "under torch.no_grad()")


def _natural_dims(name, value, spatial_shapes, sampling_locations, attention_weights):
    dims = _queries_dims(value, spatial_shapes, sampling_locations, attention_weights, name)
    S, Lq = dims[1:3]
    if Lq != S or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"{name}: encoder self-attention takes Lq == S queries over levels "
                         f"of S tokens, got Lq={Lq}, S={S} for {list(spatial_shapes)}")
    return dims


def vmem_footprints(name: str, spatial_shapes: Shapes, P: int, halo: int = 8, block: int = 8,
                    tile_sizes=None, S_tm: Optional[int] = None,
                    elem_bytes: int = 4) -> Footprints:
    """The ``Footprints`` of entry ``name`` (``VMEM``, ``VMEM_TM`` or ``VMEM_V3``) for value
    elements of ``elem_bytes``: natural tiles for ``VMEM``, ``tile_major_perm``'s for the
    other two, whose token axis must have ``S_tm`` slots."""
    shapes = _shape_key(spatial_shapes)
    tiles = tuple(_norm_tiles(tile_sizes, len(shapes)))
    if name == VMEM:
        return footprints(shapes, NATURAL_LOC, natural_tiles(shapes, tiles), int(halo),
                          int(block), 1, P, elem_bytes)
    level_info = _tile_major_info(shapes, tiles)
    pos, T, Q = level_info[-1][:3]
    if pos + T * Q != S_tm:
        raise ValueError(f"{name}: the token axis has {S_tm} slots; tile_major_perm of "
                         f"{list(shapes)} with tiles {tile_sizes} gives {pos + T * Q}")
    return footprints(shapes, TM_LOC if name == VMEM_TM else TM_OFF_CELLS, level_info,
                      int(halo), int(block), 1, P, elem_bytes)


@functools.lru_cache(maxsize=64)
def _tile_major_info(spatial_shapes, tiles) -> Tuple[Tuple[int, ...], ...]:
    """``tile_major_perm``'s level_info, kept per (shapes, tiles): the wrappers ask for it
    on every call."""
    return tuple(tuple(x) for x in tile_major_perm(spatial_shapes, tiles)[1])


# ---------------------------------------------------------------------------
# plain versions of the tile-major layouts
# ---------------------------------------------------------------------------


def tm_locations(spatial_shapes: Shapes, locT: torch.Tensor, attnT: torch.Tensor,
                 tile_sizes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """locT (B, M, L, P, 2, S_tm), attnT (B, M, L, P, S_tm) -> natural loc
    (B, S, M, L, P, 2) and attn (B, S, M, L, P), level by level through
    ``_untile_queries`` (the filler slots drop out)."""
    B, M, L, P = locT.shape[:4]
    _, level_info = tile_major_perm(spatial_shapes, tile_sizes)
    locs, attns = [], []
    for (H1, W1), (pos, T, Q, ty, tx, nty, ntx) in zip(spatial_shapes, level_info):
        seg = locT[..., pos: pos + T * Q].reshape(B, M, L, P, 2, T, Q).permute(5, 0, 6, 1, 2, 3, 4)
        locs.append(_untile_queries(seg, nty, ntx, H1, W1, ty, tx))
        seg = attnT[..., pos: pos + T * Q].reshape(B, M, L, P, T, Q).permute(4, 0, 5, 1, 2, 3)
        attns.append(_untile_queries(seg, nty, ntx, H1, W1, ty, tx))
    return torch.cat(locs, 1), torch.cat(attns, 1)


def v3_reference_points(spatial_shapes: Shapes, tile_sizes=None, device=None) -> torch.Tensor:
    """(S_tm, 2) normalized reference point of every tile-major slot, fillers included:
    ((col + 0.5) / W, (row + 0.5) / H) from the slot's tile and in-tile row and column
    (``_kernel_v3`` :750-765); rows and columns past the level continue the grid."""
    _, level_info = tile_major_perm(spatial_shapes, tile_sizes)
    refs = []
    for (H1, W1), (pos, T, Q, ty, tx, nty, ntx) in zip(spatial_shapes, level_info):
        t, q = np.meshgrid(np.arange(T), np.arange(Q), indexing="ij")
        row = (t // ntx) * ty + q // tx
        col = (t % ntx) * tx + q % tx
        refs.append(np.stack([(col + 0.5) / W1, (row + 0.5) / H1], -1).reshape(-1, 2))
    return torch.from_numpy(np.concatenate(refs).astype(np.float32)).to(device)


def v3_locations(spatial_shapes: Shapes, offT: torch.Tensor, attnT: torch.Tensor, M: int,
                 tile_sizes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """offT (B, 2*L*M*P, S_tm) rows (l, xy, m, p) in target cells, attnT (B, L*M*P, S_tm)
    rows (l, m, p) -> loc (B, S_tm, M, L, P, 2) = reference + offset / (W, H) and attn
    (B, S_tm, M, L, P), for every slot."""
    B, F2, S_tm = offT.shape
    L = len(spatial_shapes)
    P = F2 // (2 * L * M)
    off = offT.reshape(B, L, 2, M, P, S_tm).permute(0, 5, 3, 1, 4, 2)
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                      device=offT.device)
    ref = v3_reference_points(spatial_shapes, tile_sizes, offT.device)
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
    attn = attnT.reshape(B, L, M, P, S_tm).permute(0, 4, 2, 1, 3)
    return loc, attn


def sampler_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """The footprint entries' exact sampler: B1's plain version; on bf16 value, the value
    widened to f32 and the output rounded to bf16 once."""
    if value.dtype == torch.bfloat16:
        return ms_deform_attn_queries_plain(value.float(), spatial_shapes, sampling_locations,
                                            attention_weights).to(torch.bfloat16)
    return ms_deform_attn_queries_plain(value, spatial_shapes, sampling_locations,
                                        attention_weights)


def ms_deform_attn_encoder_vmem_tm_plain(value, spatial_shapes, locT, attnT, tile_sizes=None):
    """B6a's plain version in the tile-major layout -> (B, S, M*D) natural order."""
    return sampler_plain(value, spatial_shapes,
                         *tm_locations(spatial_shapes, locT, attnT, tile_sizes))


def ms_deform_attn_encoder_vmem_v3_plain(value, spatial_shapes, offT, attnT, tile_sizes=None):
    """B6b's plain version -> (B, S_tm, M*D) tile-major, every slot (Lq = S_tm)."""
    loc, attn = v3_locations(spatial_shapes, offT, attnT, value.shape[2], tile_sizes)
    return sampler_plain(value, spatial_shapes, loc, attn)


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def ms_deform_attn_encoder_vmem(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    halo: int = 8,
    block: int = 8,
    tile_sizes=None,
) -> torch.Tensor:
    """B6a: encoder self-attention from natural-order normalized locations
    (B, S, M, L, P, 2) and softmaxed attention (B, S, M, L, P) -> (B, S, M*D), exact.
    (ty, tx) query tiles from ``tile_sizes`` (default 8x16), footprints of ``halo``
    target cells around each, x aligned to ``block``."""
    _forward_only(VMEM, value, sampling_locations, attention_weights)
    B, S, Lq, M, D, L, P = _natural_dims(VMEM, value, spatial_shapes, sampling_locations,
                                         attention_weights)
    if _on_cpu(value, sampling_locations, attention_weights):
        return sampler_plain(value, spatial_shapes, sampling_locations, attention_weights)
    fp = vmem_footprints(VMEM, spatial_shapes, P, halo, block, tile_sizes,
                         elem_bytes=value.element_size())
    return _launch(VMEM, fp, value, sampling_locations, attention_weights, (B, S, M * D), P, S)


def ms_deform_attn_encoder_vmem_tm(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    locT: torch.Tensor,
    attnT: torch.Tensor,
    halo: int = 8,
    block: int = 8,
    tile_sizes=None,
) -> torch.Tensor:
    """B6a in the tile-major layout: locT (B, M, L, P, 2, S_tm) normalized, attnT
    (B, M, L, P, S_tm) softmaxed, on ``tile_major_perm``'s token axis -> (B, S, M*D) in
    natural order."""
    _forward_only(VMEM_TM, value, locT, attnT)
    B, S, M, D = value.shape
    L, P, S_tm = locT.shape[2], locT.shape[3], locT.shape[-1]
    if (locT.shape != (B, M, L, P, 2, S_tm) or attnT.shape != (B, M, L, P, S_tm)
            or len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != S):
        raise ValueError(f"{VMEM_TM}: shape mismatch {tuple(locT.shape)} / "
                         f"{tuple(attnT.shape)} for value {tuple(value.shape)} and "
                         f"{list(spatial_shapes)}")
    fp = vmem_footprints(VMEM_TM, spatial_shapes, P, halo, block, tile_sizes, S_tm,
                         value.element_size())
    if _on_cpu(value, locT, attnT):
        return ms_deform_attn_encoder_vmem_tm_plain(value, spatial_shapes, locT, attnT,
                                                    tile_sizes)
    return _launch(VMEM_TM, fp, value, locT, attnT, (B, S, M * D), P, S_tm)


def ms_deform_attn_encoder_vmem_v3(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    offT: torch.Tensor,
    attnT: torch.Tensor,
    halo: int = 8,
    block: int = 8,
    tile_sizes=None,
) -> torch.Tensor:
    """B6b: B2's contract in the tile-major layout: offT (B, 2*L*M*P, S_tm) raw offsets in
    target-level cells, rows (l, xy, m, p); attnT (B, L*M*P, S_tm) softmaxed, rows
    (l, m, p) -> (B, S_tm, M*D) tile-major, filler slots included (drop them with
    ``tile_major_inverse``)."""
    _forward_only(VMEM_V3, value, offT, attnT)
    B, S, M, D = value.shape
    L = len(spatial_shapes)
    F2, S_tm = offT.shape[1], offT.shape[-1]
    P = F2 // (2 * L * M)
    if (offT.shape != (B, 2 * L * M * P, S_tm) or attnT.shape != (B, L * M * P, S_tm)
            or P < 1 or sum(h * w for h, w in spatial_shapes) != S):
        raise ValueError(f"{VMEM_V3}: shape mismatch {tuple(offT.shape)} / "
                         f"{tuple(attnT.shape)} for value {tuple(value.shape)} and "
                         f"{list(spatial_shapes)}")
    fp = vmem_footprints(VMEM_V3, spatial_shapes, P, halo, block, tile_sizes, S_tm,
                         value.element_size())
    if _on_cpu(value, offT, attnT):
        return ms_deform_attn_encoder_vmem_v3_plain(value, spatial_shapes, offT, attnT,
                                                    tile_sizes)
    return _launch(VMEM_V3, fp, value, offT, attnT, (B, S_tm, M * D), P, S_tm)


# ---------------------------------------------------------------------------
# what the kernel reads from shared memory
# ---------------------------------------------------------------------------


def staged_share(fp: Footprints, spatial_shapes: Shapes,
                 sampling_locations: torch.Tensor) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """{(source level, target level): (corner taps read from shared memory, in-map corner
    taps)} of the kernel for ``fp`` on these locations (B, Lq, M, L, P, 2), normalized,
    in the layout's query order: natural tokens, or every tile-major slot (the fillers
    of ``TM_LOC`` are not counted, as the kernel skips them)."""
    out = {}
    starts, _ = _level_starts(spatial_shapes)
    B = sampling_locations.shape[0]
    dev = sampling_locations.device
    for l1, (H1, W1) in enumerate(spatial_shapes):
        pos, T, Q, ty, tx, nty, ntx = fp.tiles[l1]
        if fp.layout == NATURAL_LOC:
            seg = sampling_locations[:, starts[l1]: starts[l1] + H1 * W1]
            loc_t = _tile_queries(seg, H1, W1, ty, tx)[0]  # (T, B, Q, M, L, P, 2)
            valid = _tile_queries(torch.ones(1, H1 * W1, dtype=torch.bool, device=dev),
                                  H1, W1, ty, tx)[0][:, :, :, None, None]
        else:
            seg = sampling_locations[:, pos: pos + T * Q]
            loc_t = seg.reshape(B, T, Q, *seg.shape[2:]).transpose(0, 1)
            t = torch.arange(T, device=dev)[:, None]
            q = torch.arange(Q, device=dev)[None, :]
            real = ((t // ntx) * ty + q // tx < H1) & ((t % ntx) * tx + q % tx < W1)
            valid = (real | (fp.layout == TM_OFF_CELLS))[:, None, :, None, None]
        for l2, (H2, W2) in enumerate(spatial_shapes):
            oy, ox, Fh, Fw, staged = fp.pairs[l1][l2]
            x = loc_t[..., l2, :, 0] * W2 - 0.5  # (T, B, Q, M, P)
            y = loc_t[..., l2, :, 1] * H2 - 0.5
            gate = valid & (x > -1) & (y > -1) & (x < W2) & (y < H2)
            x0, y0 = torch.floor(x).long(), torch.floor(y).long()
            oyt = torch.from_numpy(oy).to(dev).view(T, 1, 1, 1, 1)
            oxt = torch.from_numpy(ox).to(dev).view(T, 1, 1, 1, 1)
            n_smem = n_taps = 0
            for dy in (0, 1):
                for dx in (0, 1):
                    yy, xx = y0 + dy, x0 + dx
                    tap = gate & (yy >= 0) & (yy < H2) & (xx >= 0) & (xx < W2)
                    n_taps += int(tap.sum())
                    if staged:
                        fy, fx = yy - oyt, xx - oxt
                        n_smem += int((tap & (fy >= 0) & (fy < Fh) & (fx >= 0)
                                       & (fx < Fw)).sum())
            out[(l1, l2)] = (n_smem, n_taps)
    return out
