"""LST-Matcher tracker head (port of gomatching_tpu/models/lst_matcher.py, variant 'lst').

Reference: ``LSTMatcher`` (gomatching/modeling/roi_heads/lstmatcher.py:59) -- a reid
embedding (FCHead4Query), a Linear rescoring head, and long/short-term DETR-lite
matcher transformers with identity affinity projections (NUM_WEIGHT_LAYERS=0 in every
shipped config). Names follow the reference ``state_dict`` (``asso_head.fc1``,
``long_term_matcher.encoder.layers.0.self_attn``, ``...decoder.layers.0.
multihead_attn``...).

The association pass runs over a padded token axis with a validity mask and decodes
all N rows (the decoder has no self-attention, so rows are independent); the host
tracker slices out the query frame's rows. Every shipped config sets ASSO_HEAD.NORM
False (norms are identity) and inference is deterministic, so neither norms nor
dropout appear here. GoMatching++ (variant 'shared') and the interpolated
positional embeddings are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import MLP, MultiHeadAttention


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

    def forward(self, src, key_mask: Optional[torch.Tensor] = None):
        src = src + self.self_attn(src, src, src, key_mask)
        return src + self.linear2(F.relu(self.linear1(src)))


class MatcherDecoderLayer(nn.Module):
    """Cross-attention + FFN, no self-attention (NO_DECODER_SELF_ATT=True;
    roi_heads/transformer.py:264-287)."""

    def __init__(self, d: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(d, num_heads)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d)

    def forward(self, tgt, memory, key_mask: Optional[torch.Tensor] = None):
        tgt = tgt + self.multihead_attn(tgt, memory, memory, key_mask)
        return tgt + self.linear2(F.relu(self.linear1(tgt)))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class MatcherTransformer(nn.Module):
    """DETR-lite matcher trunk: (B, N, F) tokens -> (decoded tokens, memory)."""

    def __init__(self, feature_dim=1024, num_heads=8, num_encoder_layers=1, num_decoder_layers=1):
        super().__init__()
        self.encoder = _Layers(MatcherEncoderLayer(feature_dim, num_heads, feature_dim)
                               for _ in range(num_encoder_layers))
        self.decoder = _Layers(MatcherDecoderLayer(feature_dim, num_heads, feature_dim)
                               for _ in range(num_decoder_layers))

    def forward(self, tokens, valid: Optional[torch.Tensor] = None):
        key_mask = None if valid is None else ~valid
        memory = tokens
        for layer in self.encoder.layers:
            memory = layer(memory, key_mask)
        # decoder targets are the RAW input rows (transformer.py:80-84)
        tgt = tokens
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, key_mask)
        return tgt, memory


class LSTMatcherHead(nn.Module):
    """The GoMatching tracker head: reid + rescore + long/short matchers."""

    def __init__(self, hidden_dim=256, num_points=25, feature_dim=1024, num_fc=2, num_heads=8,
                 num_encoder_layers=1, num_decoder_layers=1, num_weight_layers=0,
                 with_rescore=True):
        super().__init__()
        self.with_rescore = with_rescore
        self.asso_head = ReidHead(hidden_dim * num_points, feature_dim, num_fc)
        if with_rescore:
            self.rescoring_head = nn.Linear(hidden_dim, 1)
        self.long_term_matcher = MatcherTransformer(feature_dim, num_heads, num_encoder_layers,
                                                    num_decoder_layers)
        self.short_term_matcher = MatcherTransformer(feature_dim, num_heads, num_encoder_layers,
                                                     num_decoder_layers)
        self.asso_predictor = AffinityHead(feature_dim, num_weight_layers)
        self.local_asso_predictor = AffinityHead(feature_dim, num_weight_layers)

    def rescore(self, query_features):
        """Linear rescoring over per-point query features (lstmatcher.py:185-186)."""
        return self.rescoring_head(query_features)

    def reid(self, query_features):
        """(.., npts, C) -> (.., feature_dim) reid embedding."""
        return self.asso_head(query_features)

    def associate(self, reid_tokens, valid, short_term: bool):
        """(B, N, F) padded reid tokens + (B, N) validity -> (B, N, N) affinity logits."""
        matcher = self.short_term_matcher if short_term else self.long_term_matcher
        tgt, memory = matcher(reid_tokens, valid)
        predictor = self.local_asso_predictor if short_term else self.asso_predictor
        return predictor(tgt, memory)
