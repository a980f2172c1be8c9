"""Sine positional encodings (port of gomatching_tpu/models/pos_encoding.py).

Parity: adet/layers/pos_encoding.py:46-82 (2D, mask-aware cumsum normalization) and
adet/modeling/model/utils.py:24-37 (per-point query embedding). Channels-last output,
as the JAX side.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .layers import sine_embed


def position_encoding_2d(
    shape: Tuple[int, int, int],
    num_pos_feats: int,
    temperature: float = 10000.0,
    mask: Optional[torch.Tensor] = None,
    scale: float = 2 * math.pi,
    device=None,
) -> torch.Tensor:
    """Mask-aware normalized 2D sine embedding -> (B, H, W, 2*num_pos_feats).

    ``mask`` (B, H, W) is True on padded pixels; with no mask the whole map is valid.
    Channel order: [y-embedding, x-embedding].
    """
    b, h, w = shape
    eps = 1e-6
    if mask is None:
        y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[None, :, None].expand(b, h, w)
        x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, None, :].expand(b, h, w)
        y_max = torch.full((b, 1, w), float(h), device=device)
        x_max = torch.full((b, h, 1), float(w), device=device)
    else:
        not_mask = (~mask).float()
        y = not_mask.cumsum(1)
        x = not_mask.cumsum(2)
        y_max = y[:, -1:, :]
        x_max = x[:, :, -1:]
    y = (y - 0.5) / (y_max + eps)
    x = (x - 0.5) / (x_max + eps)
    return torch.cat(
        [sine_embed(y, num_pos_feats, temperature, scale),
         sine_embed(x, num_pos_feats, temperature, scale)],
        dim=-1,
    )


def point_query_pos_embed(pts: torch.Tensor, d_model: int, temperature: float) -> torch.Tensor:
    """(..., 2) normalized (x, y) -> (..., d_model), channel order [x-emb, y-emb]."""
    scale = 2 * math.pi
    half = d_model // 2
    return torch.cat(
        [sine_embed(pts[..., 0], half, temperature, scale),
         sine_embed(pts[..., 1], half, temperature, scale)],
        dim=-1,
    )
