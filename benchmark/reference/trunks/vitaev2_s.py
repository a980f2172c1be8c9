"""ViTAEv2-S, as DeepSolo's ``build_vitaev2_backbone`` configures ``vitaev2_s``
(third_party/adet/modeling/vitae_v2/vitae_v2.py:98-255; "ViTAEv2: Vision Transformer
Advanced by Exploring Inductive Bias for Image Recognition and Beyond"), written out in
plain torch, float32. Names follow the reference ``state_dict``.

Four stages, each a reduction cell (``layers.{i}.RC``) and ``NC_depth`` (2, 2, 8, 2)
normal cells (``layers.{i}.NC.{j}``); token types window, window, transformer,
transformer; embed dims (64, 64, 128, 256), token dims (64, 128, 256, 512), downsample
(4, 2, 2, 2), heads RC (1, 1, 2, 4) and NC (1, 2, 4, 8), groups RC (1, 16, 32, 64) and NC
(1, 32, 64, 128), PRM dilations ((1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2)), window 7,
mlp_ratio 4. Stages 2-4 give ``res3``, ``res4``, ``res5`` (128, 256, 512 channels at
strides 8, 16, 32).

- A reduction cell: the PRM's dilated convolutions (``PRM.convs.{k}.0``, each followed by
  a GELU) concatenated on the channels, as tokens; LayerNorm (eps 1e-5) and attention to
  the token dim: within 7x7 windows in the window stages (``attn.attn.qkv`` with a bias,
  ``attn.attn.proj``), over all tokens with T2T's v skip in the transformer stages (qkv
  without a bias; out = v + proj(attention)); plus the PCM: three grouped 3x3
  convolutions (``PCM.0``, ``.3``, ``.6``) with a frozen BatchNorm and a SiLU after the
  first two (``PCM.1``, ``.4``), strides (2, 2, 1) for a downsample of 4 and (2, 1, 1)
  for 2, widths (embed, embed, token); then y + MLP(LayerNorm(y)), hidden = token dim.
- A normal cell: x + attention(LayerNorm(x)) + PCM(x), widths (4 dim, dim, dim), stride
  1; then x + MLP(LayerNorm(x)), hidden 4 dim; LayerNorm eps 1e-6.
- Windowed attention pads the level to multiples of 7 with zero tokens after the norm,
  half of each side's padding before (the odd one after); the padded tokens take part in
  the attention and are cut away after it. No relative-position bias (commented out in
  the reference's window.py) and no shifted windows (every shift is 0): nothing is
  masked.

Departures from the reference, each for the configuration at hand:

- the frame is padded with zeros at the bottom and right to a multiple of 4 first: the
  stem's PRM (7x7, stride 4) and PCM (two stride-2 3x3 convolutions) give maps of other
  sizes at a side of 1 or 2 mod 4, such as ICDAR15's 1778;
- the buffers the configuration never reads (``rcpe``, ``pos_embed``) are left out, as
  the port leaves them out (its ``weights.REFERENCE_BUFFERS``);
- drop path is the identity (inference) and BatchNorm is a frozen affine (the trunk is
  frozen in GoMatching).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..model import FrozenBN
from . import conv_out

NAME = os.path.splitext(os.path.basename(__file__))[0]
PUBLISHED = dict(
    embed_dims=(64, 64, 128, 256), token_dims=(64, 128, 256, 512), downsample=(4, 2, 2, 2),
    kernels=(7, 3, 3, 3), rc_heads=(1, 1, 2, 4), nc_heads=(1, 2, 4, 8),
    rc_groups=(1, 16, 32, 64), nc_groups=(1, 32, 64, 128), nc_depths=(2, 2, 8, 2),
    dilations=((1, 2, 3, 4), (1, 2, 3), (1, 2), (1, 2)),
    windowed=(True, True, False, False), window=7, mlp_ratio=4)
PAD_TO = 4  # the stem's stride


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) heads -> softmax(q k^T / sqrt(hd)) v."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(scores.softmax(-1), v)


class Attention(nn.Module):
    """Tokens (B, N, dim) -> (B, N, out): multi-head attention among the N tokens;
    ``v_skip``: T2T's form, no qkv bias and v added to the projected output."""

    def __init__(self, dim: int, out: int, heads: int, v_skip: bool = False):
        super().__init__()
        self.heads, self.v_skip = heads, v_skip
        self.qkv = nn.Linear(dim, 3 * out, bias=not v_skip)
        self.proj = nn.Linear(out, out)

    def forward(self, x):
        B, N, _ = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        merge = lambda t: t.transpose(1, 2).reshape(B, N, -1)  # noqa: E731
        out = self.proj(merge(attention(q, k, v)))
        return merge(v) + out if self.v_skip else out


def in_windows(attn: nn.Module, t: torch.Tensor, h: int, w: int, ws: int) -> torch.Tensor:
    """``attn`` within ws x ws windows of the (h, w) level of tokens ``t`` (B, h w, C)."""
    B = t.shape[0]
    ph, pw = -h % ws, -w % ws
    top, left = ph // 2, pw // 2
    g = F.pad(t.view(B, h, w, -1), (0, 0, left, pw - left, top, ph - top))
    H, W = h + ph, w + pw
    g = g.view(B, H // ws, ws, W // ws, ws, -1).transpose(2, 3).reshape(-1, ws * ws, g.shape[-1])
    y = attn(g)
    y = y.view(B, H // ws, W // ws, ws, ws, -1).transpose(2, 3).reshape(B, H, W, -1)
    return y[:, top:top + h, left:left + w].reshape(B, h * w, -1)


def tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def grid(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return t.transpose(1, 2).reshape(t.shape[0], -1, h, w)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def pcm(cin: int, widths: Sequence[int], strides: Sequence[int], groups: int) -> nn.Sequential:
    """conv, BN, SiLU, conv, BN, SiLU, conv: 3x3, grouped, padding 1."""
    layers: List[nn.Module] = []
    for i, (cout, s) in enumerate(zip(widths, strides)):
        layers.append(nn.Conv2d(cin, cout, 3, s, 1, groups=groups))
        if i < 2:
            layers += [FrozenBN(cout), nn.SiLU()]
        cin = cout
    return nn.Sequential(*layers)


class PRM(nn.Module):
    def __init__(self, cin: int, embed: int, kernel: int, stride: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, embed, kernel, stride, pad(kernel, d, stride), d),
                          nn.GELU())
            for d in dilations)

    def forward(self, x):
        return torch.cat([c(x) for c in self.convs], 1)


def pad(kernel: int, dilation: int, stride: int) -> int:
    return math.ceil(((kernel - 1) * dilation + 1 - stride) / 2)


class TokenTransformer(nn.Module):
    """The reduction cell's transformer part: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, dim: int, out: int, heads: int, windowed: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, out, heads, v_skip=not windowed)
        self.norm2 = nn.LayerNorm(out, eps=1e-5)
        self.mlp = Mlp(out, out)


class ReductionCell(nn.Module):
    """NCHW (B, cin, H, W) -> NCHW (B, token, H / downsample, W / downsample)."""

    def __init__(self, cin, embed, token, downsample, kernel, heads, dilations, groups,
                 windowed, window):
        super().__init__()
        self.window = window if windowed else 0
        strides = [2 if downsample >> (i + 1) else 1 for i in range(3)]
        self.PRM = PRM(cin, embed, kernel, downsample, dilations)
        self.PCM = pcm(cin, (embed, embed, token), strides, groups)
        self.attn = TokenTransformer(embed * len(dilations), token, heads, windowed)

    def forward(self, x):
        p = self.PRM(x)
        h, w = p.shape[2:]
        a = self.attn
        y = a.norm1(tokens(p))
        y = in_windows(a.attn, y, h, w, self.window) if self.window else a.attn(y)
        y = y + tokens(self.PCM(x))
        return grid(y + a.mlp(a.norm2(y)), h, w)


class NormalCell(nn.Module):
    """NCHW (B, dim, H, W) -> the same."""

    def __init__(self, dim, heads, groups, windowed, window, mlp_ratio):
        super().__init__()
        self.window = window if windowed else 0
        hidden = dim * mlp_ratio
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)
        self.PCM = pcm(dim, (hidden, dim, dim), (1, 1, 1), groups)

    def forward(self, x):
        h, w = x.shape[2:]
        t = tokens(x)
        y = self.norm1(t)
        y = in_windows(self.attn, y, h, w, self.window) if self.window else self.attn(y)
        t = t + y + tokens(self.PCM(x))
        return grid(t + self.mlp(self.norm2(t)), h, w)


class Stage(nn.Module):
    def __init__(self, rc: ReductionCell, ncs: List[NormalCell]):
        super().__init__()
        self.RC = rc
        self.NC = nn.ModuleList(ncs)

    def forward(self, x):
        x = self.RC(x)
        for cell in self.NC:
            x = cell(x)
        return x


class ViTAEv2(nn.Module):
    """NCHW float32 frames -> [res3, res4, res5]; the widths are arguments (``PUBLISHED``
    are ViTAEv2-S's) so that tests can build it small."""

    def __init__(self, embed_dims, token_dims, downsample, kernels, rc_heads, nc_heads,
                 rc_groups, nc_groups, nc_depths, dilations, windowed, window, mlp_ratio):
        super().__init__()
        self.layers = nn.ModuleList()
        cin = 3
        for i in range(4):
            rc = ReductionCell(cin, embed_dims[i], token_dims[i], downsample[i], kernels[i],
                               rc_heads[i], dilations[i], rc_groups[i], windowed[i], window)
            ncs = [NormalCell(token_dims[i], nc_heads[i], nc_groups[i], windowed[i], window,
                              mlp_ratio) for _ in range(nc_depths[i])]
            self.layers.append(Stage(rc, ncs))
            cin = token_dims[i]

    def forward(self, x) -> List[torch.Tensor]:
        x = F.pad(x, (0, -x.shape[3] % PAD_TO, 0, -x.shape[2] % PAD_TO))
        outs = []
        for i, stage in enumerate(self.layers):
            x = stage(x)
            if i > 0:
                outs.append(x)
        return outs


STREAM_LAYERS = (ReductionCell, NormalCell)


def widths(m: Dict) -> Dict:
    if m.get("vitae_type") != NAME:
        raise ValueError(f"trunk {NAME} needs vitae_type {NAME!r}, not {m.get('vitae_type')!r}")
    return PUBLISHED


def build(m: Dict) -> nn.Module:
    return ViTAEv2(**widths(m))


def channels(m: Dict) -> Tuple[int, int, int]:
    return tuple(widths(m)["token_dims"][1:])


def init_rules(module: nn.Module) -> Dict:
    return {}  # linears, convolutions, LayerNorm and FrozenBN only: the generic rules


def operations(h: int, w: int, p: Dict) -> Tuple[Dict[str, int], List[Tuple[int, int]]]:
    """At an (h, w) input, with the widths ``p`` -> (operations by kind, [res3, res4,
    res5] map sizes). Kinds: ``conv`` (PRM and PCM), ``linear`` (qkv, proj, MLP),
    ``window_attn`` and ``global_attn`` (q k^T and the product with v, 2 n m hd each a
    head where n tokens attend to m). The windows' padded tokens are counted."""
    ws = p["window"]
    h, w = h + -h % PAD_TO, w + -w % PAD_TO
    ops = dict.fromkeys(("conv", "linear", "window_attn", "global_attn"), 0)
    cin, sizes = 3, []

    def conv(hh, ww, ci, co, k, s, d=1, g=1):
        ke = (k - 1) * d + 1
        ho, wo = conv_out(hh, ke, s, pad(k, d, s)), conv_out(ww, ke, s, pad(k, d, s))
        ops["conv"] += 2 * ho * wo * co * (ci // g) * k * k
        return ho, wo

    def linear(n, ci, co):
        ops["linear"] += 2 * n * ci * co

    def attend(hh, ww, dim, out, windowed):
        """A level's (hh, ww) tokens' attention, qkv and proj included (on the padded
        tokens too where it is windowed)."""
        if windowed:
            hh, ww = hh + -hh % ws, ww + -ww % ws
        n = hh * ww
        linear(n, dim, 3 * out)
        if windowed:
            ops["window_attn"] += 4 * n * ws * ws * out
        else:
            ops["global_attn"] += 4 * n * n * out
        linear(n, out, out)

    for i in range(4):
        e, t, s, k = p["embed_dims"][i], p["token_dims"][i], p["downsample"][i], p["kernels"][i]
        win = p["windowed"][i]
        for d in p["dilations"][i]:
            ho, wo = conv(h, w, cin, e, k, s, d)
        hh, ww = h, w
        strides = [2 if s >> (j + 1) else 1 for j in range(3)]
        for ci, co, st in zip((cin, e, e), (e, e, t), strides):
            hh, ww = conv(hh, ww, ci, co, 3, st, g=p["rc_groups"][i])
        assert (hh, ww) == (ho, wo), "PRM and PCM maps differ"
        n = ho * wo
        attend(ho, wo, e * len(p["dilations"][i]), t, win)
        linear(n, t, t)  # the MLP, hidden = token dim
        linear(n, t, t)
        hid = t * p["mlp_ratio"]
        for _ in range(p["nc_depths"][i]):
            attend(ho, wo, t, t, win)
            linear(n, t, hid)
            linear(n, hid, t)
            for ci, co in ((t, hid), (hid, t), (t, t)):
                conv(ho, wo, ci, co, 3, 1, g=p["nc_groups"][i])
        h, w, cin = ho, wo, t
        if i > 0:
            sizes.append((h, w))
    return ops, sizes


def flops(h: int, w: int, m: Dict) -> Tuple[int, Sequence[Tuple[int, int]]]:
    """At an (h, w) input -> (operations, [res3, res4, res5] map sizes)."""
    ops, sizes = operations(h, w, widths(m))
    return sum(ops.values()), sizes


def port_fields(cfg) -> Dict:
    built = cfg.MODEL.BACKBONE.NAME
    return {"backbone": NAME if built == "build_vitaev2_backbone" else built,
            "vitae_type": cfg.MODEL.ViTAEv2.TYPE}
