"""Encoder deformable attention staged through tile footprints, fused variant (B6c).

Counterpart of ``gomatching_tpu/ops/deform_attn_fused.py`` (``ms_deform_attn_encoder_fused``
:106, TPU kernel ``_kernel`` :54). It computes B6a's function from B6a's inputs
(``ops/deform_attn_vmem.py``: ``ms_deform_attn_encoder_vmem``); the TPU needed another
kernel only because of Mosaic's lowering limits (one call per (source, target) level
pair, a flat four-corner compare), so here the same kernel instantiation serves both,
with this entry's geometry: square query tiles of ``_DEFAULT_TILES`` (16, 8, 8, 4)
cells per source level (each further level halves the last, down to 2) and footprints
aligned to ``block`` on both axes. Exact whatever the halo; forward only; plain version
on CPU tensors (B1's ``ms_deform_attn_queries_plain``, the same function), the kernel
or a raise on CUDA ones. Launches count under ``FUSED``.
"""

from __future__ import annotations

import torch

from .deform_attn import FUSED, Shapes, _on_cpu, _shape_key, ms_deform_attn_queries_plain
from .deform_attn_vmem import (
    _DEFAULT_TILES,
    NATURAL_LOC,
    Footprints,
    _forward_only,
    _launch,
    _natural_dims,
    footprints,
    natural_tiles,
)


def fused_tiles(tile_sizes, L):
    """(t, t) query tiles per source level: ``tile_sizes`` or ``_DEFAULT_TILES``, each
    level past the list half the last (at least 2)."""
    tiles = list(tile_sizes) if tile_sizes is not None else list(_DEFAULT_TILES[:L])
    while len(tiles) < L:
        tiles.append(max(2, tiles[-1] // 2))
    return [(int(t), int(t)) for t in tiles]


def fused_footprints(spatial_shapes: Shapes, P: int, halo: int = 8, block: int = 8,
                     tile_sizes=None) -> Footprints:
    """The entry's ``Footprints``: natural square tiles, both axes aligned to ``block``."""
    shapes = _shape_key(spatial_shapes)
    tiles = natural_tiles(shapes, fused_tiles(tile_sizes, len(shapes)))
    return footprints(shapes, NATURAL_LOC, tiles, int(halo), int(block), int(block), P)


def ms_deform_attn_encoder_fused(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    halo: int = 8,
    block: int = 8,
    tile_sizes=None,
) -> torch.Tensor:
    """B6c: loc (B, S, M, L, P, 2) normalized, attn (B, S, M, L, P) softmaxed ->
    (B, S, M*D), exact."""
    _forward_only(FUSED, value, sampling_locations, attention_weights)
    B, S, Lq, M, D, L, P = _natural_dims(FUSED, value, spatial_shapes, sampling_locations,
                                         attention_weights)
    if _on_cpu(value, sampling_locations, attention_weights):
        return ms_deform_attn_queries_plain(value, spatial_shapes, sampling_locations,
                                            attention_weights)
    fp = fused_footprints(spatial_shapes, P, halo, block, tile_sizes)
    return _launch(FUSED, fp, value, sampling_locations, attention_weights, (B, S, M * D), P, S)
