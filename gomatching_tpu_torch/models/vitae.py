"""ViTAEv2-S backbone with the reference's module names (port of
``gomatching_tpu/models/vitae.py``).

Parity target: third_party/adet/modeling/vitae_v2/ (vitae_v2.py:98-255,
ReductionCell.py, NormalCell.py, window.py, token_transformer.py) as
``build_vitaev2_backbone`` configures 'vitaev2_s': four stages of a ReductionCell and
NC_depth (2, 2, 8, 2) NormalCells, token types window, window, transformer, transformer,
embed_dims (64, 64, 128, 256), token_dims (64, 128, 256, 512), downsample (4, 2, 2, 2),
heads RC (1, 1, 2, 4) and NC (1, 2, 4, 8), groups RC (1, 16, 32, 64) and NC
(1, 32, 64, 128), PRM dilations ((1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2)), window 7,
mlp_ratio 4; outputs of stages 1-3 -> channels 128/256/512 at strides 8/16/32. Every
attention shift is 0 in this configuration, so nothing is masked.

Names follow the reference ``state_dict`` (tools/convert_torch_weights.py:113-151):
``layers.{i}.RC.PRM.convs.{k}.0``, ``layers.{i}.RC.PCM.{0,1,3,4,6}`` (conv, BN, SiLU,
conv, BN, SiLU, conv), ``layers.{i}.RC.attn.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}``, ``layers.{i}.NC.{j}.{norm1,attn.*,norm2,mlp.*,PCM.*}``. The PCM's BatchNorm
is a frozen per-channel affine (``FrozenBN``), as in the ResNet trunk; spotter
pretraining makes it trainable as it does the ResNet's.

The frame is padded with zeros at the bottom and right to a multiple of 4 first. Stage
1's PRM (kernel 7, stride 4) and PCM (two stride-2 3x3 convs) give maps of other sizes when
a side is 1 or 2 mod 4, as ICDAR15's 1778-wide test size is, where JAX's reshape of the
PCM output raises; at the other sides the zeros are the convs' own zero padding, so the
output is JAX's exactly.

Layout: NCHW at the module's boundary, tokens (B, N, C) inside. The 'transformer' cells
of stages 3-4 attend over every token of the level with ``torch.matmul`` and ``softmax``
(JAX computes them with XLA, outside any Pallas kernel): at 1280x2276 stage 3 holds
80 x 143 tokens, so one head's score matrix is 11440^2 values.

Spans (``utils/profiling.py``): each attention over a whole level runs in
``trunk.global_attn`` and adds the operations of its two products, 4 B h n^2 hd, to the
counter ``trunk.global_attn.flops.<dtype>``; each cell's PRM and PCM branches run in
``trunk.conv``. The windowed attention of stages 1-2 is in neither.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import count, span
from .resnet import FrozenBN
from .swin import Mlp, window_partition, window_reverse


NC_DEPTHS = (2, 2, 8, 2)
DILATIONS = ((1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2))
TOKENS_TYPES = ("window", "window", "transformer", "transformer")


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over (B, h, n, hd) heads -> (B, n, h * hd)."""
    b, h, n, hd = q.shape
    out = ((q * hd ** -0.5) @ k.transpose(-2, -1)).softmax(-1) @ v
    return out.transpose(1, 2).reshape(b, n, h * hd)


def _attend_level(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_attend`` over every token of a level, in the span ``trunk.global_attn``; counts
    the operations of q k^T and of the product with v."""
    b, h, n, hd = q.shape
    count("trunk.global_attn.flops." + str(q.dtype).split(".")[-1], 4 * b * h * n * n * hd)
    with span("trunk.global_attn"):
        return _attend(q, k, v)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)


class FullAttention(nn.Module):
    """MHA over all tokens (NormalCell.py:33-58); also the windowed attention of the
    'window' cells (window.py:65-145, no relative-position bias), which maps ``dim`` to
    ``out_dim``. ``whole_level``: the tokens are a whole level (a 'transformer' cell's),
    not a window."""

    def __init__(self, dim: int, num_heads: int, out_dim: int = 0, whole_level: bool = False):
        super().__init__()
        out_dim = out_dim or dim
        self.num_heads = num_heads
        self.attend = _attend_level if whole_level else _attend
        self.qkv = nn.Linear(dim, 3 * out_dim)
        self.proj = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        q, k, v = _split_heads(self.qkv(x), self.num_heads)
        return self.proj(self.attend(q, k, v))


class TokenAttention(nn.Module):
    """T2T attention mapping ``dim`` to ``in_dim`` with its v skip and no qkv bias
    (token_transformer.py:9-43; ReductionCell.py:117-118)."""

    def __init__(self, dim: int, in_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * in_dim, bias=False)
        self.proj = nn.Linear(in_dim, in_dim)

    def forward(self, x):
        q, k, v = _split_heads(self.qkv(x), self.num_heads)
        b, h, n, hd = v.shape
        return v.transpose(1, 2).reshape(b, n, h * hd) + self.proj(_attend_level(q, k, v))


def window_apply(x: torch.Tensor, hw: Tuple[int, int], ws: int,
                 attn_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Tokens (B, H * W, C) -> windowed attention -> (B, H * W, C_out). The map is padded
    to window multiples symmetrically, the odd remainder to the bottom / right
    (ReductionCell.py:155-176, NormalCell.py:171-231; JAX ``_window_apply``)."""
    h, w = hw
    b = x.shape[0]
    pad_td, pad_lr = (ws - h % ws) % ws, (ws - w % ws) % ws
    pt, pl = pad_td // 2, pad_lr // 2
    x = F.pad(x.reshape(b, h, w, -1), (0, 0, pl, pad_lr - pl, pt, pad_td - pt))
    hp, wp = h + pad_td, w + pad_lr
    y = window_reverse(attn_fn(window_partition(x, ws)), ws, b, hp, wp)
    return y[:, pt:pt + h, pl:pl + w].reshape(b, h * w, -1)


class PRM(nn.Module):
    """Pyramid reduction: parallel dilated convs, each with a GELU, concatenated on the
    channels (ReductionCell.py:13-65, op 'cat')."""

    def __init__(self, in_chans: int, embed_dim: int, kernel_size: int, stride: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Sequential(
                nn.Conv2d(in_chans, embed_dim, kernel_size, stride=stride, dilation=d,
                          padding=math.ceil(((kernel_size - 1) * d + 1 - stride) / 2)),
                nn.GELU())
            for d in dilations])

    def forward(self, x):  # NCHW
        return torch.cat([conv(x) for conv in self.convs], 1)


def pcm(in_chans: int, dims: Sequence[int], strides: Sequence[int], group: int) -> nn.Sequential:
    """Parallel convolution module: three grouped 3x3 convs, a frozen BN and SiLU after the
    first two (ReductionCell.py:99-107: dims (embed, embed, token); NormalCell.py:147-154:
    (mlp_hidden, dim, dim))."""
    layers, c = [], in_chans
    for i, (d, s) in enumerate(zip(dims, strides)):
        layers.append(nn.Conv2d(c, d, 3, stride=s, padding=1, groups=group))
        if i < 2:
            layers += [FrozenBN(d), nn.SiLU()]
        c = d
    return nn.Sequential(*layers)


class TokenBlock(nn.Module):
    """norm1 -> attention, norm2 -> mlp: the transformer part of a cell."""

    def __init__(self, dim: int, out_dim: int, heads: int, mlp_hidden: int, eps: float,
                 token_attention: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = (TokenAttention(dim, out_dim, heads) if token_attention
                     else FullAttention(dim, heads, out_dim))
        self.norm2 = nn.LayerNorm(out_dim, eps=eps)
        self.mlp = Mlp(out_dim, mlp_hidden, out_dim)

    def attend(self, x, hw, tokens_type: str, ws: int):
        y = self.norm1(x)
        if tokens_type == "window":
            return window_apply(y, hw, ws, self.attn)
        return self.attn(y)


class ReductionCell(nn.Module):
    """PRM -> attention, + PCM, + MLP (ReductionCell.py:67-188)."""

    def __init__(self, in_chans: int, embed_dim: int, token_dim: int, downsample: int,
                 kernel_size: int, heads: int, dilations: Sequence[int], group: int,
                 tokens_type: str, window_size: int = 7):
        super().__init__()
        self.tokens_type = tokens_type
        self.window_size = window_size
        # PCM strides decompose the downsample ratio over three convs
        # (ReductionCell.py:84-90): 4 -> (2, 2, 1), 2 -> (2, 1, 1)
        residual, strides = downsample // 2, []
        for _ in range(3):
            strides.append(2 if residual > 0 else 1)
            residual //= 2
        self.PRM = PRM(in_chans, embed_dim, kernel_size, downsample, dilations)
        self.PCM = pcm(in_chans, (embed_dim, embed_dim, token_dim), strides, group)
        self.attn = TokenBlock(embed_dim * len(dilations), token_dim, heads, token_dim, 1e-5,
                               token_attention=tokens_type != "window")

    def forward(self, x: torch.Tensor):
        """NCHW -> (tokens (B, H' * W', token_dim), (H', W'))."""
        with span("trunk.conv"):
            prm = self.PRM(x)
            b, _, ho, wo = prm.shape
            prm = prm.flatten(2).transpose(1, 2)
            conv_x = self.PCM(x).flatten(2).transpose(1, 2)
        y = self.attn.attend(prm, (ho, wo), self.tokens_type, self.window_size) + conv_x
        return y + self.attn.mlp(self.attn.norm2(y)), (ho, wo)


class NormalCell(nn.Module):
    """out = x + attention(norm1(x)) + PCM(x); out += MLP(norm2(out))
    (NormalCell.py:117-251)."""

    def __init__(self, dim: int, heads: int, group: int, tokens_type: str,
                 mlp_ratio: float = 4.0, window_size: int = 7):
        super().__init__()
        self.tokens_type = tokens_type
        self.window_size = window_size
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = FullAttention(dim, heads, whole_level=tokens_type != "window")
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden, dim)
        self.PCM = pcm(dim, (hidden, dim, dim), (1, 1, 1), group)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        y = self.norm1(x)
        y = (window_apply(y, hw, self.window_size, self.attn) if self.tokens_type == "window"
             else self.attn(y))
        with span("trunk.conv"):
            conv_x = self.PCM(x.transpose(1, 2).reshape(b, c, *hw)).flatten(2).transpose(1, 2)
        x = x + y + conv_x
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, rc: ReductionCell, ncs: Sequence[NormalCell]):
        super().__init__()
        self.RC = rc
        self.NC = nn.ModuleList(ncs)


class ViTAEv2(nn.Module):
    """ViTAEv2-S trunk: NCHW images -> {res3, res4, res5} NCHW features."""

    def __init__(self, embed_dims: Sequence[int] = (64, 64, 128, 256),
                 token_dims: Sequence[int] = (64, 128, 256, 512),
                 downsample: Sequence[int] = (4, 2, 2, 2),
                 kernel_sizes: Sequence[int] = (7, 3, 3, 3),
                 rc_heads: Sequence[int] = (1, 1, 2, 4), nc_heads: Sequence[int] = (1, 2, 4, 8),
                 dilations: Sequence[Sequence[int]] = DILATIONS,
                 rc_groups: Sequence[int] = (1, 16, 32, 64),
                 nc_groups: Sequence[int] = (1, 32, 64, 128),
                 nc_depths: Sequence[int] = NC_DEPTHS, tokens_types: Sequence[str] = TOKENS_TYPES,
                 window_size: int = 7, out_stages: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.out_stages = tuple(out_stages)
        self.stem_stride = downsample[0]
        self.layers = nn.ModuleList()
        in_chans = 3
        for i in range(4):
            rc = ReductionCell(in_chans, embed_dims[i], token_dims[i], downsample[i],
                               kernel_sizes[i], rc_heads[i], dilations[i], rc_groups[i],
                               tokens_types[i], window_size)
            ncs = [NormalCell(token_dims[i], nc_heads[i], nc_groups[i], tokens_types[i],
                              window_size=window_size) for _ in range(nc_depths[i])]
            self.layers.append(BasicLayer(rc, ncs))
            in_chans = token_dims[i]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, _, h, w = x.shape
        r = self.stem_stride
        x = F.pad(x, (0, -w % r, 0, -h % r))
        outputs = {}
        for i, layer in enumerate(self.layers):
            x, hw = layer.RC(x)
            for cell in layer.NC:
                x = cell(x, hw)
            x = x.transpose(1, 2).reshape(b, -1, *hw)  # NCHW for the next cell's convs
            if i in self.out_stages:
                # the reference calls these stage3/4/5 (vitae_v2.py:218-223)
                outputs[f"res{i + 2}"] = x
        return outputs
