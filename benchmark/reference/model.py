"""Plain PyTorch reference of GoMatching / GoMatching++ inference, float32.

A frozen copy of the equations of the port under test, written out with plain torch
operations only: the deformable samplers are ``F.grid_sample`` (zero padding,
``align_corners=False``, as ``ms_deform_attn_core_pytorch``), every matrix product is
torch's own, and nothing here imports the port. Module and parameter names follow the
reference ``state_dict`` (detectron2 / AdelaiDet / GoMatching), so one seeded
state_dict loads into this model and into the port alike.

What the comparison needs is split in stages:

  - ``preprocess``: uint8 BGR frames -> normalized NHWC frames (resize with
    antialiasing, optional I420 round trip);
  - ``encode``: the configuration's trunk (a file of ``trunks/``) + input projections +
    deformable encoder + the two-stage proposal heads (class logits and Bezier
    coordinates of every token);
  - ``select``: the top-k proposals as per-point reference points;
  - ``decode``: the composite decoder from given reference points, then the heads,
    rescoring, score fusion and the reid embedding;
  - ``associate``: the association matcher (GoMatching's long/short-term matchers or
    GoMatching++'s shared decoder-only one) and its affinity logits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import trunks

Shapes = Sequence[Tuple[int, int]]


# ---------------------------------------------------------------------------
# trunk: the configuration's (``trunks/<name>.py``) under detectron2's names
# ---------------------------------------------------------------------------


class FrozenBN(nn.Module):
    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class MaskedBackbone(nn.Module):
    def __init__(self, trunk):
        super().__init__()
        self.backbone = trunk


# ---------------------------------------------------------------------------
# shared blocks
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, i, h, o, n):
        super().__init__()
        ins = [i] + [h] * (n - 1)
        outs = [h] * (n - 1) + [o]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(ins, outs))

    def forward(self, x):
        for k, layer in enumerate(self.layers):
            x = layer(x)
            if k < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters, batch-first, written out."""

    def __init__(self, c, heads):
        super().__init__()
        self.num_heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def forward(self, query, key, value, key_mask=None, drop=None):
        """``drop``: the training dropout, on the attention probabilities."""
        B, Nq, C = query.shape
        Nk = key.shape[1]
        H = self.num_heads
        hd = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).view(B, Nq, H, hd).transpose(1, 2)
        k = F.linear(key, wk, bk).view(B, Nk, H, hd).transpose(1, 2)
        v = F.linear(value, wv, bv).view(B, Nk, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if key_mask is not None:
            logits = logits.masked_fill(key_mask[:, None, None, :], -1e9)
        attn = logits.softmax(-1)
        out = torch.matmul(attn if drop is None else drop(attn), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, C))


def _identity(x):
    return x


def ffn(x, l1, l2, norm):
    return norm(x + l2(F.relu(l1(x))))


def sine_embed(coords, n, temperature, scale):
    dim_t = torch.arange(n, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / n)
    pos = coords[..., None] * scale / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1).reshape(*coords.shape, n)


def position_encoding_2d(b, h, w, n, temperature, device):
    """Normalized 2D sine embedding of an unpadded map -> (b, h, w, 2n), [y, x]."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[None, :, None].expand(b, h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, None, :].expand(b, h, w)
    y = (y - 0.5) / (h + 1e-6)
    x = (x - 0.5) / (w + 1e-6)
    s = 2 * math.pi
    return torch.cat([sine_embed(y, n, temperature, s), sine_embed(x, n, temperature, s)], -1)


def point_query_pos_embed(pts, d_model, temperature):
    s = 2 * math.pi
    return torch.cat([sine_embed(pts[..., 0], d_model // 2, temperature, s),
                      sine_embed(pts[..., 1], d_model // 2, temperature, s)], -1)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


# ---------------------------------------------------------------------------
# deformable attention with the plain sampler
# ---------------------------------------------------------------------------


def sample(value, shapes: Shapes, loc, attn):
    """value (B, S, M, D); loc (B, Lq, M, L, P, 2) in [0, 1]; attn (B, Lq, M, L, P)
    -> (B, Lq, M*D): per-level ``grid_sample`` taps weighted by ``attn``."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    grids = 2 * loc - 1
    out = value.new_zeros(B * M, D, Lq)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * M, D, h, w)
        start += h * w
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(B * M, Lq, P, 2)
        taps = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * M, 1, Lq, P)
        out = out + (taps * a).sum(-1)
    return out.view(B, M, D, Lq).permute(0, 3, 1, 2).reshape(B, Lq, M * D)


class MSDeformAttn(nn.Module):
    def __init__(self, c=256, levels=4, heads=8, points=4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = levels, heads, points
        self.sampling_offsets = nn.Linear(c, heads * levels * points * 2)
        self.attention_weights = nn.Linear(c, heads * levels * points)
        self.value_proj = nn.Linear(c, c)
        self.output_proj = nn.Linear(c, c)

    def forward(self, query, ref, value_tokens, shapes):
        """ref (B, Lq, L, 2) normalized reference points of each query."""
        B, Lq, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_tokens).view(B, -1, M, C // M)
        off = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        attn = self.attention_weights(query).view(B, Lq, M, L * P).softmax(-1).view(B, Lq, M, L, P)
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
        loc = ref[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
        return self.output_proj(sample(value, shapes, loc, attn))


class EncoderLayer(nn.Module):
    def __init__(self, c, ff, levels, heads, points):
        super().__init__()
        self.self_attn = MSDeformAttn(c, levels, heads, points)
        self.norm1 = nn.LayerNorm(c, eps=1e-5)
        self.linear1 = nn.Linear(c, ff)
        self.linear2 = nn.Linear(ff, c)
        self.norm2 = nn.LayerNorm(c, eps=1e-5)

    def forward(self, src, pos, ref, shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return ffn(src, self.linear1, self.linear2, self.norm2)


class DecoderLayer(nn.Module):
    def __init__(self, c, ff, levels, heads, points):
        super().__init__()
        self.n_levels = levels
        self.attn_intra = MultiHeadAttention(c, heads)
        self.norm_intra = nn.LayerNorm(c, eps=1e-5)
        self.attn_inter = MultiHeadAttention(c, heads)
        self.norm_inter = nn.LayerNorm(c, eps=1e-5)
        self.attn_cross = MSDeformAttn(c, levels, heads, points)
        self.norm_cross = nn.LayerNorm(c, eps=1e-5)
        self.linear1 = nn.Linear(c, ff)
        self.linear2 = nn.Linear(ff, c)
        self.norm3 = nn.LayerNorm(c, eps=1e-5)

    def forward(self, tgt, query_pos, ref, memory, shapes):
        B, nq, npts, C = tgt.shape
        q = (tgt + query_pos).reshape(B * nq, npts, C)
        tgt = self.norm_intra(tgt + self.attn_intra(q, q, tgt.reshape(B * nq, npts, C))
                              .view(B, nq, npts, C))
        t = tgt.transpose(1, 2).reshape(B * npts, nq, C)
        t = self.norm_inter(t + self.attn_inter(t, t, t))
        tgt = t.view(B, npts, nq, C).transpose(1, 2)
        out = self.attn_cross((tgt + query_pos).reshape(B, nq * npts, C),
                              ref.reshape(B, nq * npts, self.n_levels, 2), memory, shapes)
        tgt = self.norm_cross(tgt + out.view(B, nq, npts, C))
        return ffn(tgt, self.linear1, self.linear2, self.norm3)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    def __init__(self, c, ff, levels, heads, enc_points, dec_points, n_enc, n_dec):
        super().__init__()
        self.encoder = _Layers(EncoderLayer(c, ff, levels, heads, enc_points) for _ in range(n_enc))
        self.decoder = _Layers(DecoderLayer(c, ff, levels, heads, dec_points) for _ in range(n_dec))
        self.decoder.ref_point_head = MLP(c, c, c, 2)
        self.level_embed = nn.Parameter(torch.zeros(levels, c))
        self.enc_output = nn.Linear(c, c)
        self.enc_output_norm = nn.LayerNorm(c, eps=1e-5)


def bernstein_matrix(n: int) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)[:, None]
    k = np.arange(4)[None, :]
    return (np.array([1.0, 3.0, 3.0, 1.0])[None] * t**k * (1 - t) ** (3 - k)).astype(np.float32)


def _shared(module, n):
    return nn.ModuleList([module] * n)


class DeepSoloSpotter(nn.Module):
    def __init__(self, channels, c=256, heads=8, n_enc=6, n_dec=6, ff=1024, levels=4,
                 enc_points=4, dec_points=4, num_queries=100, num_points=25, voc_size=37,
                 temperature=10000.0):
        """``channels``: the widths of the trunk's three maps."""
        super().__init__()
        self.d_model, self.levels = c, levels
        self.num_queries, self.num_points = num_queries, num_points
        self.temperature = float(temperature)
        projs = []
        for i in range(levels):
            conv = (nn.Conv2d(channels[i], c, 1) if i < 3
                    else nn.Conv2d(channels[-1], c, 3, stride=2, padding=1))
            projs.append(nn.Sequential(conv, nn.GroupNorm(32, c, eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = Transformer(c, ff, levels, heads, enc_points, dec_points, n_enc, n_dec)
        self.point_embed = nn.Embedding(num_queries * num_points, c)
        self.bezier_proposal_class = nn.Linear(c, 1)
        self.bezier_proposal_coord = MLP(c, c, 8, 3)
        self.ctrl_point_class = _shared(nn.Linear(c, 1), n_dec)
        self.ctrl_point_text = _shared(nn.Linear(c, voc_size + 1), n_dec)
        self.ctrl_point_coord = _shared(MLP(c, c, 2, 3), n_dec)
        self.boundary_offset = _shared(MLP(c, c, 4, 3), n_dec)
        self.transformer.decoder.ctrl_point_coord = self.ctrl_point_coord
        self.transformer.bezier_class_embed = self.bezier_proposal_class
        self.transformer.bezier_coord_embed = self.bezier_proposal_coord
        self.register_buffer("bernstein", torch.tensor(bernstein_matrix(num_points)),
                             persistent=False)


class ReidHead(nn.Module):
    def __init__(self, in_dim, fc_dim, num_fc):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, qf):
        x = qf.flatten(-2)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class MatcherEncoderLayer(nn.Module):
    def __init__(self, d, heads, ff):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, heads)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)

    def forward(self, src, key_mask, drop=None):
        d = _identity if drop is None else drop
        src = src + d(self.self_attn(src, src, src, key_mask, drop))
        return src + d(self.linear2(d(F.relu(self.linear1(src)))))


class MatcherDecoderLayer(nn.Module):
    def __init__(self, d, heads, ff, with_ffn=True):
        super().__init__()
        self.with_ffn = with_ffn
        self.multihead_attn = MultiHeadAttention(d, heads)
        if with_ffn:
            self.linear1 = nn.Linear(d, ff)
            self.linear2 = nn.Linear(ff, d)

    def forward(self, tgt, memory, key_mask, drop=None):
        d = _identity if drop is None else drop
        tgt = tgt + d(self.multihead_attn(tgt, memory, memory, key_mask, drop))
        if self.with_ffn:
            tgt = tgt + d(self.linear2(d(F.relu(self.linear1(tgt)))))
        return tgt


class MatcherTransformer(nn.Module):
    def __init__(self, d, heads, n_enc, n_dec, decoder_ffn=True):
        super().__init__()
        self.encoder = _Layers(MatcherEncoderLayer(d, heads, d) for _ in range(n_enc))
        self.decoder = _Layers(MatcherDecoderLayer(d, heads, d, decoder_ffn) for _ in range(n_dec))

    def forward(self, tokens, valid, drop=None):
        key_mask = ~valid
        memory = tokens
        for layer in self.encoder.layers:
            memory = layer(memory, key_mask, drop)
        tgt = tokens
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, key_mask, drop)
        return tgt, memory


class MatcherHead(nn.Module):
    """reid + rescore + matchers; variant 'lst' (GoMatching) or 'shared' (GoMatching++).
    Identity affinity projections (NUM_WEIGHT_LAYERS 0), no positional embeddings
    (NO_POS_EMB True), as both benchmarked configurations set them."""

    def __init__(self, hidden, points, fc_dim, num_fc, heads, n_enc, n_dec, variant,
                 with_rescore):
        super().__init__()
        self.variant = variant
        self.asso_head = ReidHead(hidden * points, fc_dim, num_fc)
        if with_rescore:
            self.rescoring_head = nn.Linear(hidden, 1)
        if variant == "lst":
            self.long_term_matcher = MatcherTransformer(fc_dim, heads, n_enc, n_dec)
            self.short_term_matcher = MatcherTransformer(fc_dim, heads, n_enc, n_dec)
        else:
            self.shared_matcher = MatcherTransformer(fc_dim, heads, 0, n_dec, decoder_ffn=False)


class ReferenceModel(nn.Module):
    """The whole inference model, f32, plain samplers."""

    def __init__(self, m: Dict):
        super().__init__()
        self.m = dict(m)
        trunk = trunks.of(m)
        self.backbone = nn.Sequential(MaskedBackbone(trunk.build(m)))
        self.detection_transformer = DeepSoloSpotter(
            trunk.channels(m), m["hidden_dim"], m["nheads"], m["enc_layers"], m["dec_layers"],
            m["dim_feedforward"], m["num_feature_levels"], m["enc_n_points"], m["dec_n_points"],
            m["num_queries"], m["num_points"], m["voc_size"], m["temperature"])
        self.roi_heads = MatcherHead(
            m["hidden_dim"], m["num_points"], m["asso_fc_dim"], m["asso_num_fc"],
            m["asso_num_heads"], m["asso_encoder_layers"], m["asso_decoder_layers"],
            m["matcher"], m["with_rescore"])

    # -- stages ------------------------------------------------------------
    def encode(self, images: torch.Tensor) -> Dict:
        """Normalized NHWC frames -> encoder memory and every token's proposal."""
        sp = self.detection_transformer
        t = sp.transformer
        feats = self.backbone[0].backbone(images.permute(0, 3, 1, 2).contiguous())
        srcs, poss, shapes = [], [], []
        prev = None
        for i in range(sp.levels):
            x = sp.input_proj[i](feats[i] if i < 3 else (feats[-1] if i == 3 else prev))
            prev = x
            b, _, h, w = x.shape
            shapes.append((h, w))
            srcs.append(x.flatten(2).transpose(1, 2))
            pos = position_encoding_2d(b, h, w, sp.d_model // 2, sp.temperature, x.device)
            poss.append(pos.reshape(b, h * w, -1) + t.level_embed[i][None, None])
        src, pos = torch.cat(srcs, 1), torch.cat(poss, 1)
        refs = []
        for h, w in shapes:
            ry, rx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=src.device) + 0.5,
                                    torch.arange(w, dtype=torch.float32, device=src.device) + 0.5,
                                    indexing="ij")
            refs.append(torch.stack([rx.reshape(-1) / w, ry.reshape(-1) / h], -1))
        ref = torch.cat(refs, 0)[None, :, None, :].expand(src.shape[0], -1, sp.levels, -1)
        memory = src
        for layer in t.encoder.layers:
            memory = layer(memory, pos, ref, shapes)
        props = []
        for h, w in shapes:
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=src.device),
                                    torch.arange(w, dtype=torch.float32, device=src.device),
                                    indexing="ij")
            grid = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], dtype=torch.float32,
                                                                    device=src.device)
            props.append(grid.repeat(1, 1, 4).reshape(h * w, 8))
        proposals = torch.cat(props, 0)[None].expand(src.shape[0], -1, -1)
        bad = ~((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposals = torch.log(proposals / (1 - proposals)).masked_fill(bad, float("inf"))
        mem = t.enc_output_norm(t.enc_output(memory.masked_fill(bad, 0.0)))
        enc_class = sp.bezier_proposal_class(mem)[..., 0]
        enc_coords = sp.bezier_proposal_coord(mem) + proposals
        return {"memory": memory, "shapes": shapes, "enc_class": enc_class,
                "enc_coords": enc_coords}

    def proposal_points(self, enc_coords: torch.Tensor) -> torch.Tensor:
        """(B, K, 8) proposal coords before the sigmoid -> (B, K, npts, 2) points."""
        sp = self.detection_transformer
        bez = enc_coords.sigmoid().view(*enc_coords.shape[:2], 4, 2)
        return torch.einsum("pk,bqkc->bqpc", sp.bernstein, bez)

    def select(self, enc: Dict, k: Optional[int] = None) -> torch.Tensor:
        """The top-``k`` (default: the queries) proposals' reference points, ties to the
        lower token index."""
        k = k or self.detection_transformer.num_queries
        idx = torch.sort(enc["enc_class"], dim=1, descending=True, stable=True).indices[:, :k]
        coords = torch.gather(enc["enc_coords"], 1, idx[..., None].expand(-1, -1, 8))
        return self.proposal_points(coords)

    def decode_raw(self, enc: Dict, reference_points: torch.Tensor) -> Dict:
        """The decoder from ``reference_points`` (B, nq, npts, 2) and the heads: the
        spotter's raw outputs (normalized points) and the query features."""
        sp = self.detection_transformer
        dec = sp.transformer.decoder
        memory = enc["memory"]
        B = memory.shape[0]
        nq = reference_points.shape[1]
        tgt = sp.point_embed.weight.view(sp.num_queries, sp.num_points, sp.d_model)[:nq]
        tgt = tgt[None].expand(B, -1, -1, -1)
        ref = ref_last = reference_points.float()
        for li, layer in enumerate(dec.layers):
            ref_in = ref[:, :, :, None, :].expand(-1, -1, -1, sp.levels, -1)
            query_pos = dec.ref_point_head(point_query_pos_embed(ref, sp.d_model, sp.temperature))
            tgt = layer(tgt, query_pos, ref_in, memory, enc["shapes"])
            ref_last = ref
            ref = (sp.ctrl_point_coord[li](tgt) + inverse_sigmoid(ref)).sigmoid()
        unact = inverse_sigmoid(ref_last)
        head = self.roi_heads
        return {
            "pred_logits": sp.ctrl_point_class[-1](tgt),
            "pred_text_logits": sp.ctrl_point_text[-1](tgt),
            "pred_ctrl_points": (sp.ctrl_point_coord[-1](tgt) + unact).sigmoid(),
            "pred_bd_points": (sp.boundary_offset[-1](tgt) + unact.repeat(1, 1, 1, 2)).sigmoid(),
            "re_pred_logits": (head.rescoring_head(tgt) if hasattr(head, "rescoring_head")
                               else None),
            "query_features": tgt,
        }

    def decode(self, enc: Dict, reference_points: torch.Tensor, image_hw) -> Dict:
        """``decode_raw``, then score fusion with the rescoring head and the reid
        embedding; points scaled to the frame's (h, w)."""
        raw = self.decode_raw(enc, reference_points)
        scores = raw["pred_logits"].mean(2)[..., 0].sigmoid()
        if raw["re_pred_logits"] is not None:
            scores = torch.maximum(scores, raw["re_pred_logits"].mean(2)[..., 0].sigmoid())
        h, w = image_hw
        wh = torch.tensor([w, h], dtype=torch.float32, device=scores.device)
        return {"scores": scores, "ctrl_points": raw["pred_ctrl_points"] * wh,
                "bd": raw["pred_bd_points"] * torch.cat([wh, wh]),
                "reid": self.roi_heads.asso_head(raw["query_features"])}

    def associate(self, tokens, valid, short_term: bool, drop=None) -> torch.Tensor:
        """(B, N, F) tokens + (B, N) validity -> (B, N, N) affinity logits; ``drop``:
        the training dropout, applied where the reference's ``nn.Dropout`` modules sit
        (attention probabilities, each attention output, inside the FFN and on its
        output)."""
        head = self.roi_heads
        if head.variant == "lst":
            matcher = head.short_term_matcher if short_term else head.long_term_matcher
        else:
            matcher = head.shared_matcher
        tgt, memory = matcher(tokens, valid, drop)
        return torch.matmul(tgt, memory.transpose(-1, -2))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def resize_hw(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge's output size."""
    scale = short / min(h, w)
    newh, neww = (short, scale * w) if h < w else (scale * h, short)
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    return int(newh + 0.5), int(neww + 0.5)


def i420_round_trip(frames_u8: np.ndarray) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) -> the BGR float frames an I420 wire decodes to: cv2's
    BT.601 studio-swing encode, then its inverse with nearest chroma, each chroma term
    one rounding to f32 of an exact float64 multiply-add, rounded to integers."""
    import cv2

    yuv = np.stack([cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_BGR2YUV_I420)
                    for f in frames_u8])
    B, h32, W = yuv.shape
    H = h32 * 2 // 3
    y = yuv[:, :H].astype(np.float64)
    nc = H * W // 4
    chroma = yuv[:, H:].reshape(B, 2 * nc)
    u = chroma[:, :nc].reshape(B, H // 2, W // 2).astype(np.float64)
    v = chroma[:, nc:].reshape(B, H // 2, W // 2).astype(np.float64)
    u = u.repeat(2, 1).repeat(2, 2) - 128.0
    v = v.repeat(2, 1).repeat(2, 2) - 128.0

    def f32(x):
        return np.asarray(x, np.float32).astype(np.float64)

    yf = f32((y - 16.0) * f32(1.1644))
    r = f32(v * f32(1.5960) + yf)
    g = f32(v * f32(-0.8130) + f32(u * f32(-0.3918) + yf))
    b = f32(u * f32(2.0172) + yf)
    out = np.stack([b, g, r], -1).astype(np.float32)
    return torch.from_numpy(np.clip(np.round(out), 0.0, 255.0))


def preprocess(frames_u8: np.ndarray, m: Dict, device) -> torch.Tensor:
    """uint8 BGR frames -> normalized NHWC float32 at the test size: RGB order,
    antialiased bilinear resize, (x - mean) / std. An I420 wire is worked out again."""
    if m["upload_format"] == "yuv420" and frames_u8.shape[1] % 2 == 0 \
            and frames_u8.shape[2] % 2 == 0:
        x = i420_round_trip(frames_u8).to(device)
    else:
        x = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(device).float()
    x = x.flip(-1).permute(0, 3, 1, 2)
    h, w = resize_hw(frames_u8.shape[1], frames_u8.shape[2], m["min_size_test"],
                     m["max_size_test"])
    if (x.shape[2], x.shape[3]) != (h, w):
        x = F.interpolate(x, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    mean = torch.tensor(m["pixel_mean"], dtype=torch.float32, device=device)[None, :, None, None]
    std = torch.tensor(m["pixel_std"], dtype=torch.float32, device=device)[None, :, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)
