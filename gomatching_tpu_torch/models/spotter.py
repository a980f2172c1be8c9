"""DeepSolo spotter: deformable encoder + composite decoder + heads.

Port of ``gomatching_tpu/models/spotter.py`` (reference: ``DeformableTransformer``,
third_party/adet/layers/deformable_transformer.py:22, and the
``DETECTION_TRANSFORMER_WOBACKBONE`` heads, detection_transformer_wobackbone.py:15).

Module names and sharing follow the reference ``state_dict``: the per-layer prediction
heads are ``ModuleList``s repeating ONE module (``ctrl_point_class.{i}``...), and the
decoder / transformer re-register the shared heads (``transformer.decoder.
ctrl_point_coord``, ``transformer.bezier_{class,coord}_embed``), so a reference
checkpoint loads with ``load_state_dict(strict=True)``.

Sampling follows ``TPU.SAMPLING_IMPL`` as JAX ``MSDeformAttn`` does (spotter.py:144-259),
exact everywhere:
  - 'vmem' (the default): without padding masks, encoder self-attention calls the B2
    kernel (``ms_deform_attn_encoder``) on the raw offsets and attention logits; with
    masks, and in the decoder, the layer builds normalized locations and calls the B1
    kernel (``ms_deform_attn_queries``);
  - 'pallas': every call builds normalized locations and softmaxed attention and calls
    B5 (``ms_deform_attn_merged``, the corner-merged table), encoder, masked encoder
    and decoder alike; it has no backward;
  - 'xla' and 'tiled' take the 'vmem' route: in JAX they are XLA versions of the same
    function (the exact gather core, and the halo-limited one-hot encoder), not Pallas
    kernels;
  - any other value raises.
Features are NCHW; token tensors are (B, S, C). Dropout is omitted: every shipped
config sets MODEL.TRANSFORMER.DROPOUT = 0 and the spotter is frozen.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.deform_attn import ms_deform_attn_encoder, ms_deform_attn_queries
from ..ops.deform_attn_merged import ms_deform_attn_merged
from ..utils.misc import inverse_sigmoid
from .layers import MLP, MultiHeadAttention, ffn
from .pos_encoding import point_query_pos_embed, position_encoding_2d

Shapes = Sequence[Tuple[int, int]]
SAMPLING_IMPLS = ("vmem", "pallas", "xla", "tiled")


def bernstein_matrix(num_points: int) -> np.ndarray:
    """(num_points, 4) cubic Bernstein basis evaluated at linspace(0, 1)."""
    t = np.linspace(0.0, 1.0, num_points)[:, None]
    k = np.arange(4)[None, :]
    binom = np.array([1.0, 3.0, 3.0, 1.0])[None, :]
    return (binom * t**k * (1 - t) ** (3 - k)).astype(np.float32)


def offset_grid_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Radial-grid bias of the sampling-offset projection, flattened in (m, l, p, xy)
    order: head h points along angle 2*pi*h/M at L-inf norm 1, times point_index + 1
    (MSDeformAttn._reset_parameters, ms_deform_attn.py:101-109)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid = grid * (np.arange(n_points, dtype=np.float32) + 1)[None, None, :, None]
    return grid.reshape(-1).astype(np.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 to f32, as JAX casts the samplers' inputs; f32, and f64 (a float64 reference
    run of the plain path), as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class MSDeformAttn(nn.Module):
    """Offset/weight projections around the sampler (ms_deform_attn.py:69-156)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4,
                 sampling_impl: str = "vmem"):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        if sampling_impl not in SAMPLING_IMPLS:
            raise ValueError(f"TPU.SAMPLING_IMPL={sampling_impl!r}: expected one of "
                             f"{SAMPLING_IMPLS}")
        self.sampling_impl = sampling_impl
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, value_tokens, spatial_shapes: Shapes,
                token_valid: Optional[torch.Tensor] = None, is_encoder_self_attn: bool = False):
        """query (B, Lq, C); reference_points (B, Lq, L, 2) normalized (unused on the
        encoder kernel path, which derives them); value_tokens (B, S, C);
        token_valid (B, S) True where real."""
        B, Lq, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_tokens)
        if token_valid is not None:
            value = value.masked_fill(~token_valid[..., None], 0.0)
        value = value.view(B, -1, M, C // M)
        offsets = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        logits = self.attention_weights(query).view(B, Lq, M, L * P)
        pallas = self.sampling_impl == "pallas"
        # in bf16 the samplers take the value in the compute dtype and everything else in
        # f32, as JAX's kernels do: the encoder's offsets and logits are cast to f32 and
        # softmaxed there (spotter.py:177-191); elsewhere the softmax runs in the compute
        # dtype and the f32 reference points and level sizes promote the locations to f32
        # (:216-217), the kernel taking the weights as f32 (deform_attn_dec_vmem.py:170)
        if is_encoder_self_attn and token_valid is None and not pallas:
            out = ms_deform_attn_encoder(value, spatial_shapes, _f32(offsets), _f32(logits))
        else:
            attn = logits.softmax(-1).view(B, Lq, M, L, P)
            wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                              device=query.device)
            loc = reference_points[:, :, None, :, None, :] + offsets / wh[None, None, None, :, None, :]
            sampler = ms_deform_attn_merged if pallas else ms_deform_attn_queries
            out = sampler(value, spatial_shapes, loc, _f32(attn))
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    """Deformable self-attention + FFN (deformable_transformer.py:218-278)."""

    def __init__(self, d_model, dim_feedforward, n_levels, n_heads, n_points, sampling_impl):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, sampling_impl)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, token_valid):
        attn = self.self_attn(src + pos, reference_points, src, spatial_shapes, token_valid,
                              is_encoder_self_attn=True)
        src = self.norm1(src + attn)
        return ffn(src, self.linear1, self.linear2, self.norm2)


class DecoderLayer(nn.Module):
    """Intra-point MHA, inter-query MHA, deformable cross-attention, FFN
    (deformable_transformer.py:326-427)."""

    def __init__(self, d_model, dim_feedforward, n_levels, n_heads, n_points, sampling_impl):
        super().__init__()
        self.n_levels = n_levels
        self.attn_intra = MultiHeadAttention(d_model, n_heads)
        self.norm_intra = nn.LayerNorm(d_model, eps=1e-5)
        self.attn_inter = MultiHeadAttention(d_model, n_heads)
        self.norm_inter = nn.LayerNorm(d_model, eps=1e-5)
        self.attn_cross = MSDeformAttn(d_model, n_levels, n_heads, n_points, sampling_impl)
        self.norm_cross = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, memory, spatial_shapes, token_valid):
        B, nq, npts, C = tgt.shape
        # intra-group attention across the point axis
        q = (tgt + query_pos).reshape(B * nq, npts, C)
        out = self.attn_intra(q, q, tgt.reshape(B * nq, npts, C))
        tgt = self.norm_intra(tgt + out.view(B, nq, npts, C))
        # inter-group attention across the query axis
        t = tgt.transpose(1, 2).reshape(B * npts, nq, C)
        t = self.norm_inter(t + self.attn_inter(t, t, t))
        tgt = t.view(B, npts, nq, C).transpose(1, 2)
        # deformable cross-attention into the encoder memory
        out = self.attn_cross(
            (tgt + query_pos).reshape(B, nq * npts, C),
            reference_points.reshape(B, nq * npts, self.n_levels, 2),
            memory, spatial_shapes, token_valid,
        )
        tgt = self.norm_cross(tgt + out.view(B, nq, npts, C))
        return ffn(tgt, self.linear1, self.linear2, self.norm3)


class Encoder(nn.Module):
    def __init__(self, n_layers, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(*layer_args) for _ in range(n_layers))


class Decoder(nn.Module):
    def __init__(self, n_layers, d_model, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d_model, *layer_args) for _ in range(n_layers))
        self.ref_point_head = MLP(d_model, d_model, d_model, 2)


class Transformer(nn.Module):
    def __init__(self, d_model, dim_feedforward, n_levels, n_heads, enc_points, dec_points,
                 n_enc, n_dec, sampling_impl):
        super().__init__()
        self.encoder = Encoder(n_enc, d_model, dim_feedforward, n_levels, n_heads, enc_points,
                               sampling_impl)
        self.decoder = Decoder(n_dec, d_model, dim_feedforward, n_levels, n_heads, dec_points,
                               sampling_impl)
        self.level_embed = nn.Parameter(torch.zeros(n_levels, d_model))
        self.enc_output = nn.Linear(d_model, d_model)
        self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)


def _shared(module: nn.Module, n: int) -> nn.ModuleList:
    """The reference's per-layer head list: n entries of ONE module."""
    return nn.ModuleList([module] * n)


class DeepSoloSpotter(nn.Module):
    """Full spotter over backbone features.

    forward(features NCHW list, pos_embeds (B, H, W, C) list, masks) -> dict with
    pred_logits (B, nq, npts, 1), pred_text_logits (B, nq, npts, voc+1),
    pred_ctrl_points (B, nq, npts, 2), pred_bd_points (B, nq, npts, 4),
    query_features (B, nq, npts, C).
    """

    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=1024, num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 num_queries=100, num_points=25, voc_size=37, temperature=10000.0,
                 in_channels=(512, 1024, 2048), boundary_head=True, sampling_impl="vmem"):
        super().__init__()
        C = d_model
        self.d_model = d_model
        self.num_feature_levels = num_feature_levels
        self.num_queries, self.num_points = num_queries, num_points
        self.temperature = float(temperature)
        self.boundary_head = boundary_head
        projs = []
        for i in range(num_feature_levels):
            if i < len(in_channels):
                conv = nn.Conv2d(in_channels[i], C, kernel_size=1)
            else:
                conv = nn.Conv2d(in_channels[-1], C, kernel_size=3, stride=2, padding=1)
            projs.append(nn.Sequential(conv, nn.GroupNorm(32, C, eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = Transformer(C, dim_feedforward, num_feature_levels, n_heads,
                                       enc_n_points, dec_n_points, num_encoder_layers,
                                       num_decoder_layers, sampling_impl)
        self.point_embed = nn.Embedding(num_queries * num_points, C)
        self.bezier_proposal_class = nn.Linear(C, 1)
        self.bezier_proposal_coord = MLP(C, C, 8, 3)
        n = num_decoder_layers
        self.ctrl_point_class = _shared(nn.Linear(C, 1), n)
        self.ctrl_point_text = _shared(nn.Linear(C, voc_size + 1), n)
        self.ctrl_point_coord = _shared(MLP(C, C, 2, 3), n)
        if boundary_head:
            self.boundary_offset = _shared(MLP(C, C, 4, 3), n)
        # reference aliases of the shared heads
        self.transformer.decoder.ctrl_point_coord = self.ctrl_point_coord
        self.transformer.bezier_class_embed = self.bezier_proposal_class
        self.transformer.bezier_coord_embed = self.bezier_proposal_coord
        self.register_buffer("bernstein", torch.from_numpy(bernstein_matrix(num_points)),
                             persistent=False)

    # ------------------------------------------------------------------
    def _flatten_levels(self, features, pos_embeds, masks):
        """Project levels to d_model, add the extra stride-2 level, flatten to tokens."""
        srcs, poss, valids, shapes, level_masks = [], [], [], [], []
        n_backbone = len(features)
        prev = None
        for i in range(self.num_feature_levels):
            x = features[i] if i < n_backbone else (features[-1] if i == n_backbone else prev)
            x = self.input_proj[i](x)
            prev = x
            b, _, h, w = x.shape
            shapes.append((h, w))
            srcs.append(x.flatten(2).transpose(1, 2))
            if i < n_backbone:
                pos = pos_embeds[i]
                mask_l = None if masks is None else masks[i]
            else:
                # the extra level's mask, F.interpolate(mode='nearest') semantics
                # (index floor(i * in / out); detection_transformer_wobackbone.py:180)
                if masks is None:
                    mask_l = None
                else:
                    m0 = masks[0]
                    h0, w0 = m0.shape[1], m0.shape[2]
                    ridx = torch.arange(h, device=x.device) * h0 // h
                    cidx = torch.arange(w, device=x.device) * w0 // w
                    mask_l = m0[:, ridx][:, :, cidx]
                pos = position_encoding_2d((b, h, w), self.d_model // 2, self.temperature,
                                           mask_l, device=x.device)
            level_masks.append(mask_l)
            poss.append(pos.reshape(b, h * w, -1) + self.transformer.level_embed[i][None, None, :])
            valids.append(
                torch.ones((b, h * w), dtype=torch.bool, device=x.device)
                if mask_l is None else (~mask_l).reshape(b, h * w)
            )
        src = torch.cat(srcs, 1)
        # the extra level's encoding is f32 (JAX casts the whole of it to src's dtype, :474)
        pos = torch.cat(poss, 1).to(src.dtype)
        return src, pos, torch.cat(valids, 1), shapes, level_masks

    @staticmethod
    def _valid_ratios(level_masks, batch: int, device) -> torch.Tensor:
        """(B, L, 2) non-padded fraction of (w, h) per level
        (deformable_transformer.py:141-148)."""
        ratios = []
        for m in level_masks:
            if m is None:
                ratios.append(torch.ones((batch, 2), device=device))
            else:
                valid_h = (~m[:, :, 0]).float().sum(1)
                valid_w = (~m[:, 0, :]).float().sum(1)
                ratios.append(torch.stack([valid_w / m.shape[2], valid_h / m.shape[1]], -1))
        return torch.stack(ratios, 1)

    @staticmethod
    def _encoder_reference_points(shapes: Shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
        """(B, S, L, 2) encoder reference points."""
        refs = []
        for lvl, (h, w) in enumerate(shapes):
            ry, rx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=valid_ratios.device) + 0.5,
                torch.arange(w, dtype=torch.float32, device=valid_ratios.device) + 0.5,
                indexing="ij",
            )
            refs.append(torch.stack(
                [rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w),
                 ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)], -1))
        return torch.cat(refs, 1)[:, :, None, :] * valid_ratios[:, None, :, :]

    def _gen_proposals(self, memory, valid_flat, shapes: Shapes):
        """Two-stage proposal generation (deformable_transformer.py:108-139)."""
        B = memory.shape[0]
        props, offset = [], 0
        for h, w in shapes:
            v = valid_flat[:, offset:offset + h * w].reshape(B, h, w)
            valid_h = v[:, :, 0].float().sum(1)
            valid_w = v[:, 0, :].float().sum(1)
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=memory.device),
                torch.arange(w, dtype=torch.float32, device=memory.device),
                indexing="ij",
            )
            grid = torch.stack([gx, gy], -1)[None]  # (1, h, w, 2)
            scale = torch.stack([valid_w, valid_h], -1)[:, None, None, :]
            grid = (grid + 0.5) / scale
            props.append(grid.repeat(1, 1, 1, 4).reshape(B, h * w, 8))
            offset += h * w
        proposals = torch.cat(props, 1)
        in_range = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposals = torch.log(proposals / (1 - proposals))
        bad = ~valid_flat[..., None] | ~in_range
        proposals = proposals.masked_fill(bad, float("inf"))
        mem = memory.masked_fill(bad, 0.0)
        mem = self.transformer.enc_output_norm(self.transformer.enc_output(mem))
        return mem, proposals

    # ------------------------------------------------------------------
    def encode(self, features: List[torch.Tensor], pos_embeds: List[torch.Tensor],
               masks=None) -> Dict:
        """input_proj + the deformable encoder -> the state the proposals and ``decode``
        read."""
        src, pos, valid, shapes, level_masks = self._flatten_levels(features, pos_embeds, masks)
        valid_ratios = self._valid_ratios(level_masks, src.shape[0], src.device)
        token_valid = None if masks is None else valid
        refs = self._encoder_reference_points(shapes, valid_ratios)
        memory = src
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, pos, refs, shapes, token_valid)
        return {"memory": memory, "valid": valid, "shapes": shapes,
                "valid_ratios": valid_ratios, "token_valid": token_valid}

    def encoder_proposals(self, enc: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-token proposal class logits (B, S) and Bezier coords before the sigmoid
        (B, S, 8): the two-stage heads on the encoder memory."""
        out_mem, out_props = self._gen_proposals(enc["memory"], enc["valid"], enc["shapes"])
        enc_class = self.bezier_proposal_class(out_mem)[..., 0]
        enc_coords = self.bezier_proposal_coord(out_mem) + out_props
        return enc_class, enc_coords

    def select_proposals(self, enc_class: torch.Tensor, enc_coords: torch.Tensor) -> torch.Tensor:
        """Top-k Bezier proposals -> (B, nq, npts, 2) reference points, which carry no
        gradient (JAX stop_gradient, gomatching_tpu/models/spotter.py:554)."""
        # a stable descending sort breaks score ties by lower token index, as
        # jax.lax.top_k does (masked/out-of-range tokens share one score)
        topk_idx = torch.sort(enc_class, dim=1, descending=True, stable=True).indices
        topk_idx = topk_idx[:, : self.num_queries]
        topk_coords = torch.gather(enc_coords, 1, topk_idx[..., None].expand(-1, -1, 8)).detach()
        bez = topk_coords.sigmoid().view(-1, self.num_queries, 4, 2)
        return torch.einsum("pk,bqkc->bqpc", self.bernstein, bez)

    def _heads(self, tgt, ref_unact, pred_ctrl_points) -> Dict[str, torch.Tensor]:
        out = {
            "pred_logits": self.ctrl_point_class[-1](tgt),
            "pred_text_logits": self.ctrl_point_text[-1](tgt),
            "pred_ctrl_points": pred_ctrl_points,
            "pred_bd_points": None,
        }
        if self.boundary_head:
            out["pred_bd_points"] = (
                self.boundary_offset[-1](tgt) + ref_unact.repeat(1, 1, 1, 2)
            ).sigmoid()
        return out

    def decode(self, enc: Dict, reference_points: torch.Tensor,
               aux_outputs: bool = False) -> Dict[str, torch.Tensor]:
        """Composite decoder with iterative point refinement, then the heads.
        ``aux_outputs``: also the heads of every layer but the last, for the
        pretraining losses (gomatching_tpu/models/spotter.py:575-586)."""
        memory, valid_ratios = enc["memory"], enc["valid_ratios"]
        B = memory.shape[0]
        tgt = self.point_embed.weight.view(self.num_queries, self.num_points, self.d_model)
        tgt = tgt[None].expand(B, -1, -1, -1)
        dec = self.transformer.decoder
        ref = ref_in_last = reference_points.detach()
        aux = []
        for li, layer in enumerate(dec.layers):
            ref_input = ref[:, :, :, None, :] * valid_ratios[:, None, None, :, :]
            qp = point_query_pos_embed(ref_input[:, :, :, 0, :], self.d_model, self.temperature)
            # the head runs at the f32 of its input, then goes to tgt's dtype (JAX :571)
            query_pos = dec.ref_point_head(qp).to(tgt.dtype)
            tgt = layer(tgt, query_pos, ref_input, memory, enc["shapes"], enc["token_valid"])
            delta = self.ctrl_point_coord[li](tgt)
            ref_in_last = ref
            r = inverse_sigmoid(ref)
            if aux_outputs and li < len(dec.layers) - 1:
                aux.append(self._heads(tgt, r, (delta + r).sigmoid()))
            # refined references carry no gradient (JAX stop_gradient, spotter.py:587)
            ref = (delta + r).sigmoid().detach()
        ref_unact = inverse_sigmoid(ref_in_last)
        out = self._heads(tgt, ref_unact, (self.ctrl_point_coord[-1](tgt) + ref_unact).sigmoid())
        out["query_features"] = tgt
        if aux_outputs:
            out["aux_outputs"] = aux
        return out

    def forward(self, features: List[torch.Tensor], pos_embeds: List[torch.Tensor], masks=None,
                train_outputs: bool = False):
        """``train_outputs``: also ``aux_outputs`` (every decoder layer but the last),
        ``enc_logits`` (B, S, 1) and ``enc_beziers`` (B, S, 8) sigmoided, as the JAX
        spotter emits them for pretraining (spotter.py:602-606)."""
        enc = self.encode(features, pos_embeds, masks)
        enc_class, enc_coords = self.encoder_proposals(enc)
        out = self.decode(enc, self.select_proposals(enc_class, enc_coords),
                          aux_outputs=train_outputs)
        if train_outputs:
            out["enc_logits"] = enc_class[..., None]
            out["enc_beziers"] = enc_coords.sigmoid()
        return out
