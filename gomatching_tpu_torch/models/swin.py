"""Swin Transformer backbone (tiny/small) with the reference's module names (port of
``gomatching_tpu/models/swin.py``).

Parity target: third_party/adet/modeling/swin/swin_transformer.py:491-726 as the
GoMatching Swin configs set it: patch 4, window 7, embed_dim 96, depths (2, 2, 6, 2)
(tiny) or (2, 2, 18, 2) (small), heads (3, 6, 12, 24), outputs of stages 1-3 through
``norm1``-``norm3`` -> channels 192/384/768 at strides 8/16/32, no absolute position
embedding, patch norm on. Names follow the reference ``state_dict``:
``patch_embed.proj``, ``layers.{s}.blocks.{b}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{s}.downsample.{norm,reduction}``, ``norm{s}``. The reference's
``relative_position_index`` buffer is recomputed here and is not a key (it is one of
``weights.REFERENCE_BUFFERS``).

Layout: NCHW at the module's boundary (as ``ResNet``), NHWC inside. Feature maps are
padded right and bottom to window multiples, the shifted windows masked with -100
(JAX ``_shift_mask``) in the activations' dtype (JAX's f32 constant promotes a bf16 trunk
to f32 from its first shifted block on). Drop-path, the one training-time behaviour, runs only when the
caller passes a ``torch.Generator`` (spotter pretraining): a per-sample keep with
probability 1 - p and a 1/(1 - p) rescale on both residual branches (JAX ``SwinBlock``,
swin.py:80-86, flax ``Dropout`` with ``broadcast_dims=(1, 2, 3)``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


SWIN_DEPTHS = {"tiny": (2, 2, 6, 2), "small": (2, 2, 18, 2)}  # MODEL.SWIN.TYPE


@functools.lru_cache(maxsize=None)
def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(n, n) index into the relative-position table of a wh x ww window."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, n, n) additive mask of the shifted windows: -100 between tokens of
    different regions of the rolled map (JAX swin.py:121-130)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hsl, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * -100.0


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample branch drop: each sample's branch is kept with probability 1 - rate and
    then divided by 1 - rate; the identity when ``generator`` is None or rate is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) with H, W multiples of ws -> (B * nW, ws * ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(xw: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    """Inverse of ``window_partition``: (B * nW, ws * ws, C) -> (B, H, W, C)."""
    c = xw.shape[-1]
    x = xw.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    """Window MHA with the relative-position bias (JAX swin.py:35-64)."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        bn, n, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = self.qkv(x).reshape(bn, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)  # (Bn, h, n, n)
        idx = torch.from_numpy(_rel_pos_index(self.window_size, self.window_size))
        bias = self.relative_position_bias_table[idx.reshape(-1).to(x.device)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bn // nw, nw, h, n, n) + mask[None, :, None]).reshape(bn, h, n, n)
        out = attn.softmax(-1) @ v  # (Bn, h, n, hd)
        return self.proj(out.transpose(1, 2).reshape(bn, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        b, h, w, c = x.shape
        ws = self.window_size
        shortcut = x
        y = F.pad(self.norm1(x), (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))
        hp, wp = y.shape[1:3]
        mask = None
        if self.shift > 0:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_mask(hp, wp, ws, self.shift)).to(
                device=x.device, dtype=y.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, b, hp, wp)
        if self.shift > 0:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + drop_path(y[:, :h, :w], self.drop_path, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: its blocks (shift 0 / window // 2 alternating) and the merging that
    follows it (none after the last stage)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 rates: Sequence[float], downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2,
                      drop_path=float(rates[b]))
            for b in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch: int = 4):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, embed_dim, patch, stride=patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):  # NCHW -> NHWC
        p = self.patch
        x = F.pad(x, (0, (p - x.shape[3] % p) % p, 0, (p - x.shape[2] % p) % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """Swin-T/S trunk: NCHW images -> {res3, res4, res5} NCHW features."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_indices: Sequence[int] = (1, 2, 3), drop_path_rate: float = 0.0):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim)
        # per-block rates ramp linearly to drop_path_rate (swin_transformer.py:570)
        rates = np.linspace(0.0, drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        dim, start = embed_dim, 0
        for si, depth in enumerate(depths):
            self.layers.append(BasicLayer(dim, depth, num_heads[si], window_size,
                                          rates[start:start + depth], si < len(depths) - 1))
            if si in self.out_indices:
                self.add_module(f"norm{si}", nn.LayerNorm(dim, eps=1e-5))
            start += depth
            dim *= 2

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator``: drop-path's random source; None runs deterministically."""
        x = self.patch_embed(x)
        outputs = {}
        for si, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x, generator)
            if si in self.out_indices:
                outputs[f"res{si + 2}"] = getattr(self, f"norm{si}")(x).permute(0, 3, 1, 2)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outputs
