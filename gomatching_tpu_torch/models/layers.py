"""Shared NN building blocks (port of gomatching_tpu/models/layers.py).

Parameter names follow the reference torch modules: ``MLP.layers.{i}``, and
``MultiHeadAttention`` keeps ``nn.MultiheadAttention``'s packed ``in_proj_weight`` /
``in_proj_bias`` plus ``out_proj``. The attention itself is written out as matmul +
softmax, as the JAX side leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class MLP(nn.Module):
    """ReLU MLP head (adet/modeling/model/utils.py:7-21)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            w, b = layer.weight, layer.bias
            if w.dtype != x.dtype:
                # flax computes a layer whose input and parameters differ in dtype at
                # their promoted type (an f32 input to bf16 weights: f32)
                dt = torch.promote_types(w.dtype, x.dtype)
                x, w, b = x.to(dt), w.to(dt), b.to(dt)
            x = F.linear(x, w, b)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Softmax MHA with torch ``nn.MultiheadAttention`` numerics and parameters.

    Inputs are batch-first (B, N, C); ``key_mask`` (B, Nk) is True on *invalid* keys.
    """

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, key_mask: Optional[torch.Tensor] = None,
                dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """``dropout``: applied to the attention probabilities when given (the
        ``dropout=`` of ``nn.MultiheadAttention``)."""
        B, Nq, C = query.shape
        Nk = key.shape[1]
        H = self.num_heads
        hd = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).view(B, Nq, H, hd).transpose(1, 2)
        k = F.linear(key, wk, bk).view(B, Nk, H, hd).transpose(1, 2)
        v = F.linear(value, wv, bv).view(B, Nk, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)  # (B, H, Nq, Nk)
        if key_mask is not None:
            logits = logits.masked_fill(key_mask[:, None, None, :], -1e9)
        attn = logits.softmax(-1)
        if dropout is not None:
            attn = dropout(attn)
        out = torch.matmul(attn, v)  # (B, H, Nq, hd)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, C))


def ffn(x, linear1: nn.Linear, linear2: nn.Linear, norm: nn.LayerNorm):
    """Post-norm transformer FFN: norm(x + linear2(relu(linear1(x)))). The reference
    keeps the three modules directly on each layer (``linear1``, ``linear2``,
    ``norm2``/``norm3``), so this is a function over them, not a module."""
    return norm(x + linear2(F.relu(linear1(x))))


def sine_embed(coords: torch.Tensor, num_feats: int, temperature: float, scale: float):
    """Interleaved sine/cosine embedding of scalar coordinates -> (..., num_feats)
    (adet/layers/pos_encoding.py:74-81, model/utils.py:24-37)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos = coords[..., None] * scale / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1).reshape(
        *coords.shape, num_feats
    )
