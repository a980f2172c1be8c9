"""LST-Matcher tracker heads (port of gomatching_tpu/models/lst_matcher.py).

Reference: ``LSTMatcher`` (gomatching/modeling/roi_heads/lstmatcher.py:59) -- a reid
embedding (FCHead4Query), a Linear rescoring head, and long/short-term DETR-lite
matcher transformers with identity affinity projections (NUM_WEIGHT_LAYERS=0 in every
shipped config) -- is variant 'lst'. GoMatching++ ``SHA_FFN_CRSATTN``
(shared_ffn_crsattn.py:62) is variant 'shared': ONE matcher with no encoder layers and
decoder layers without FFN serves both terms. With NO_POS_EMB False the keys of every
attention also get the interpolated box embedding, averaged with the temporal one when
WITH_TEMP_EMB (lstmatcher.py:498-532). Names follow the reference ``state_dict``
(``asso_head.fc1``, ``long_term_matcher.encoder.layers.0.self_attn``,
``shared_matcher.decoder.layers.0.multihead_attn``, ``pos_emb.weight``...).

The association pass runs over a padded token axis with a validity mask and decodes
all N rows (the decoder has no self-attention, so rows are independent); the host
tracker slices out the query frame's rows. Every shipped config sets ASSO_HEAD.NORM
False, so the norms are identity and do not appear here.

ASSO_HEAD.DROPOUT (0.1 by default) acts in training, where the reference's
``nn.Dropout`` modules sit (roi_heads/transformer.py:166-258; JAX lst_matcher.py:72-74,
:108): on the attention probabilities, on each attention output (``dropout1``), inside
the FFN and on its output (``dropout2``). It is active only in an ``associate(...,
train=True)`` call of a head in ``train()`` mode, adds no parameter, and draws its masks
from the head's own ``torch.Generator`` seeded with ``dropout_seed``; inference stays
deterministic. The masks are not JAX's (its bits come from ``jax.random``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import MLP, MultiHeadAttention

# interpolation bins of the box and temporal embedding tables: JAX's learn_pos_emb_num
# and learn_temp_emb_num (lst_matcher.py:204-205), which no config key sets
EMB_BINS = 16

Dropout = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _drop(x: torch.Tensor, drop: Dropout) -> torch.Tensor:
    return x if drop is None else drop(x)


class ReidHead(nn.Module):
    """FCHead4Query (association_head.py:100-122): flatten (.., npts, C) ->
    num_fc x [Linear + relu]."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, num_fc: int = 2):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, query_features):
        x = query_features.flatten(-2)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class AffinityHead(nn.Module):
    """ATTWeightHead (association_head.py:35-57): q/k projections + bmm; identity
    projections when num_layers == 0."""

    def __init__(self, feature_dim: int, num_layers: int = 0):
        super().__init__()
        self.num_layers = num_layers
        if num_layers > 0:
            self.q_proj = MLP(feature_dim, feature_dim, feature_dim, num_layers)
            self.k_proj = MLP(feature_dim, feature_dim, feature_dim, num_layers)

    def forward(self, query, key):
        if self.num_layers > 0:
            query, key = self.q_proj(query), self.k_proj(key)
        return torch.matmul(query, key.transpose(-1, -2))


class MatcherEncoderLayer(nn.Module):
    """Self-attention + FFN with residuals (roi_heads/transformer.py:191-207)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, num_heads)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d)

    def forward(self, src, key_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, drop: Dropout = None):
        qk = src if pos is None else src + pos  # with_pos_embed, transformer.py:196
        src = src + _drop(self.self_attn(qk, qk, src, key_mask, drop), drop)
        return src + _drop(self.linear2(_drop(F.relu(self.linear1(src)), drop)), drop)


class MatcherDecoderLayer(nn.Module):
    """Cross-attention (+ FFN unless ``with_ffn`` is False, as GoMatching++'s), no
    self-attention (NO_DECODER_SELF_ATT=True; roi_heads/transformer.py:264-287)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int, with_ffn: bool = True):
        super().__init__()
        self.with_ffn = with_ffn
        self.multihead_attn = MultiHeadAttention(d, num_heads)
        if with_ffn:
            self.linear1 = nn.Linear(d, dim_feedforward)
            self.linear2 = nn.Linear(dim_feedforward, d)

    def forward(self, tgt, memory, key_mask: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, drop: Dropout = None):
        # the queries carry no pos (query_pos is None in the matchers); the keys do
        # (transformer.py:277-279)
        keys = memory if pos is None else memory + pos
        tgt = tgt + _drop(self.multihead_attn(tgt, keys, memory, key_mask, drop), drop)
        if self.with_ffn:
            tgt = tgt + _drop(self.linear2(_drop(F.relu(self.linear1(tgt)), drop)), drop)
        return tgt


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class MatcherTransformer(nn.Module):
    """DETR-lite matcher trunk: (B, N, F) tokens -> (decoded tokens, memory)."""

    def __init__(self, feature_dim=1024, num_heads=8, num_encoder_layers=1, num_decoder_layers=1,
                 decoder_ffn=True):
        super().__init__()
        self.encoder = _Layers(MatcherEncoderLayer(feature_dim, num_heads, feature_dim)
                               for _ in range(num_encoder_layers))
        self.decoder = _Layers(MatcherDecoderLayer(feature_dim, num_heads, feature_dim, decoder_ffn)
                               for _ in range(num_decoder_layers))

    def forward(self, tokens, valid: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None, drop: Dropout = None):
        key_mask = None if valid is None else ~valid
        memory = tokens
        for layer in self.encoder.layers:
            memory = layer(memory, key_mask, pos, drop)
        # decoder targets are the RAW input rows (transformer.py:80-84)
        tgt = tokens
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, key_mask, pos, drop)
        return tgt, memory


class LSTMatcherHead(nn.Module):
    """The GoMatching tracker head: reid + rescore + the matchers.

    variant "lst"    = GoMatching   (ROI_HEADS.NAME LSTMatcher): long/short matchers
    variant "shared" = GoMatching++ (ROI_HEADS.NAME SHA_FFN_CRSATTN): one shared
                       decoder-only matcher without FFN (JAX lst_matcher.py:230-240)
    """

    def __init__(self, hidden_dim=256, num_points=25, feature_dim=1024, num_fc=2, num_heads=8,
                 num_encoder_layers=1, num_decoder_layers=1, num_weight_layers=0,
                 variant="lst", with_rescore=True, no_pos_emb=True, with_temp_emb=False,
                 dropout=0.0, dropout_seed=0):
        super().__init__()
        self.variant = variant
        self.dropout, self.dropout_seed = float(dropout), int(dropout_seed)
        self.dropout_generator: Optional[torch.Generator] = None  # made at first use
        self.with_rescore = with_rescore
        self.no_pos_emb, self.with_temp_emb = no_pos_emb, with_temp_emb
        self.asso_head = ReidHead(hidden_dim * num_points, feature_dim, num_fc)
        if with_rescore:
            self.rescoring_head = nn.Linear(hidden_dim, 1)
        if variant == "lst":
            self.long_term_matcher = MatcherTransformer(feature_dim, num_heads,
                                                        num_encoder_layers, num_decoder_layers)
            self.short_term_matcher = MatcherTransformer(feature_dim, num_heads,
                                                         num_encoder_layers, num_decoder_layers)
        elif variant == "shared":
            self.shared_matcher = MatcherTransformer(feature_dim, num_heads, 0,
                                                     num_decoder_layers, decoder_ffn=False)
        else:
            raise ValueError(f"unknown matcher variant: {variant}")
        if not no_pos_emb:
            # EMB_BINS x (x, y, w, h) rows of feature_dim // 4 (JAX :243-254)
            self.pos_emb = nn.Embedding(EMB_BINS * 4, feature_dim // 4)
            if with_temp_emb:
                self.temp_emb = nn.Embedding(EMB_BINS, feature_dim)
        self.asso_predictor = AffinityHead(feature_dim, num_weight_layers)
        self.local_asso_predictor = AffinityHead(feature_dim, num_weight_layers)

    def rescore(self, query_features):
        """Linear rescoring over per-point query features (lstmatcher.py:185-186)."""
        return self.rescoring_head(query_features)

    def reid(self, query_features):
        """(.., npts, C) -> (.., feature_dim) reid embedding."""
        return self.asso_head(query_features)

    def box_pe(self, boxes):
        """Bilinearly interpolated learned box embedding (lstmatcher.py:498-518; JAX
        lst_matcher.py:270). ``boxes`` (..., 4) xyxy normalized to [0, 1] -> (..., F)."""
        T = EMB_BINS
        xywh = torch.cat([(boxes[..., 2:] + boxes[..., :2]) / 2,
                          boxes[..., 2:] - boxes[..., :2]], -1) * T
        lo = xywh.floor().clamp(0, T - 1).long()
        hi = (lo + 1).clamp(0, T - 1)
        w_hi = xywh - lo.to(xywh.dtype)
        table = self.pos_emb.weight.view(T, 4, -1)  # (T, 4, F//4)
        four = torch.arange(4, device=boxes.device)
        out = w_hi[..., None] * table[hi, four] + (1.0 - w_hi[..., None]) * table[lo, four]
        return out.reshape(*boxes.shape[:-1], -1)

    def temp_pe(self, times):
        """Interpolated temporal embedding (lstmatcher.py:521-532; JAX :289). ``times``
        (...,) in [0, 1] (frame index / window length) -> (..., F)."""
        T = EMB_BINS
        t = times * T
        lo = t.floor().clamp(0, T - 1).long()
        hi = (lo + 1).clamp(0, T - 1)
        w_hi = (t - lo.to(t.dtype))[..., None]
        return w_hi * self.temp_emb.weight[hi] + (1.0 - w_hi) * self.temp_emb.weight[lo]

    def _dropout_fn(self, device: torch.device) -> Dropout:
        """Inverted dropout at rate ``dropout`` with masks from the head's generator
        (on ``device``, seeded with ``dropout_seed`` when first made)."""
        gen = self.dropout_generator
        if gen is None or gen.device != device:
            gen = torch.Generator(device=device).manual_seed(self.dropout_seed)
            self.dropout_generator = gen
        keep = 1.0 - self.dropout

        def drop(x: torch.Tensor) -> torch.Tensor:
            mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
            return x * mask / keep

        return drop

    def associate(self, reid_tokens, valid, short_term: bool, boxes=None, times=None,
                  train: bool = False):
        """(B, N, F) padded reid tokens + (B, N) validity -> (B, N, N) affinity logits.
        With NO_POS_EMB False, ``boxes`` (B, N, 4 normalized xyxy) and, with
        WITH_TEMP_EMB, ``times`` (B, N in [0, 1]) feed the interpolated embeddings
        (_forward_transformer, lstmatcher.py:338-346; JAX lst_matcher.py:299-319).
        ``train``: apply ASSO_HEAD.DROPOUT when the head is in ``train()`` mode."""
        drop = (self._dropout_fn(reid_tokens.device)
                if train and self.training and self.dropout > 0 else None)
        pos = None
        if not self.no_pos_emb and boxes is not None:
            pos = self.box_pe(boxes)
            if self.with_temp_emb and times is not None:
                pos = (pos + self.temp_pe(times)) / 2.0
        if self.variant == "lst":
            matcher = self.short_term_matcher if short_term else self.long_term_matcher
        else:
            matcher = self.shared_matcher
        tgt, memory = matcher(reid_tokens, valid, pos, drop)
        predictor = self.local_asso_predictor if short_term else self.asso_predictor
        return predictor(tgt, memory)
