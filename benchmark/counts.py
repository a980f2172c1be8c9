"""Operations and bytes of the work, worked out from the configuration's shapes and
dtypes, never from what a kernel does: the same work reads the same whatever
implements it.

A multiply-add counts two operations. ``dense`` counts are the matrix products and
convolutions (what ``torch.utils.flop_counter.FlopCounterMode`` counts on the plain
reference); ``taps`` counts the deformable samplers' bilinear taps: per sample and
channel four corner multiply-adds and one attention multiply-add (10 operations).
Normalisations, activations, softmax, NMS and resizing are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .reference import trunks

TAP_FLOPS = 10  # 4 corner multiply-adds + the attention multiply-add, per channel
BYTES = {"float32": 4, "bfloat16": 2}


def level_shapes(h: int, w: int, m: Dict) -> Sequence[Tuple[int, int]]:
    """The encoder's (h, w) per level at an (h, w) input: the trunk's three maps, then
    each further level a stride-2 3x3 convolution of the last."""
    sizes = list(trunks.of(m).flops(h, w, m)[1])
    for _ in range(m["num_feature_levels"] - 3):
        hh, ww = sizes[-1]
        sizes.append((trunks.conv_out(hh, 3, 2, 1), trunks.conv_out(ww, 3, 2, 1)))
    return sizes


def spot_flops(h: int, w: int, m: Dict) -> Dict[str, int]:
    """Operations of one frame's spot at the model input (h, w): the trunk (its file's
    ``flops``), input projections, encoder, proposals, decoder, heads, rescoring and
    reid."""
    C, F_, M = m["hidden_dim"], m["dim_feedforward"], m["nheads"]
    L, Pe, Pd = m["num_feature_levels"], m["enc_n_points"], m["dec_n_points"]
    nq, npts, voc = m["num_queries"], m["num_points"], m["voc_size"]
    D = C // M
    trunk = trunks.of(m)
    trunk_ops = trunk.flops(h, w, m)[0]
    shapes = level_shapes(h, w, m)
    S = sum(a * b for a, b in shapes)
    chans = trunk.channels(m)
    proj = sum(2 * a * b * chans[i] * C for i, (a, b) in enumerate(shapes[:3]))
    for a, b in shapes[3:]:
        proj += 2 * a * b * chans[-1] * C * 9
    enc_lin = C * C + C * M * L * Pe * 2 + C * M * L * Pe + C * C + 2 * C * F_
    enc_dense = m["enc_layers"] * 2 * S * enc_lin
    enc_taps = m["enc_layers"] * S * M * L * Pe * D * TAP_FLOPS
    proposals = 2 * S * (C * C + C + C * C + C * C + C * 8)
    Q = nq * npts
    mha = lambda groups, seq: 2 * groups * seq * 4 * C * C + 4 * groups * seq * seq * C  # noqa: E731
    dec_layer = (2 * Q * 2 * C * C  # ref_point_head
                 + mha(nq, npts) + mha(npts, nq)
                 + 2 * S * C * C  # cross-attention value projection of the memory
                 + 2 * Q * (C * M * L * Pd * 2 + C * M * L * Pd + C * C)
                 + 2 * Q * 2 * C * F_
                 + 2 * Q * (2 * C * C + 2 * C))  # the point refinement head
    dec_dense = m["dec_layers"] * dec_layer + 2 * nq * npts * 4 * 2  # + Bernstein
    dec_taps = m["dec_layers"] * Q * M * L * Pd * D * TAP_FLOPS
    heads = 2 * Q * (C + C * (voc + 1) + 2 * C * C + 2 * C + 2 * C * C + 4 * C)
    if m["with_rescore"]:
        heads += 2 * Q * C
    fc = m["asso_fc_dim"]
    reid = 2 * nq * (npts * C * fc + (m["asso_num_fc"] - 1) * fc * fc)
    dense = trunk_ops + proj + enc_dense + proposals + dec_dense + heads + reid
    return {"dense": dense, "taps": enc_taps + dec_taps, "total": dense + enc_taps + dec_taps,
            "tokens": S}


def matcher_flops(n: int, m: Dict, short_term: bool) -> int:
    """Operations of one association pass over ``n`` tokens: GoMatching's matcher
    (encoder + decoder layers with FFN) or GoMatching++'s shared decoder-only one
    (no FFN), then the identity-projection affinity."""
    F_ = m["asso_fc_dim"]
    attn = 2 * n * 4 * F_ * F_ + 4 * n * n * F_
    ffn = 2 * n * 2 * F_ * F_
    if m["matcher"] == "lst":
        total = m["asso_encoder_layers"] * (attn + ffn) + m["asso_decoder_layers"] * (attn + ffn)
    else:
        total = m["asso_decoder_layers"] * attn
    return total + 2 * n * n * F_


def encoder_sampler_bytes(batch: int, S: int, m: Dict, value_dtype: str) -> int:
    """Bytes the encoder sampler must move at Lq = S: the value, the f32 offsets and
    attention logits read once and the output written once."""
    C, M = m["hidden_dim"], m["nheads"]
    LP = m["num_feature_levels"] * m["enc_n_points"]
    vb = BYTES[value_dtype]
    value = batch * S * C * vb
    offsets = batch * S * M * LP * 2 * 4
    logits = batch * S * M * LP * 4
    out = batch * S * C * vb
    return value + offsets + logits + out


def encoder_sampler_bound_s(batch: int, S: int, m: Dict, value_dtype: str,
                            mem_bw: float, peak_flops: float) -> float:
    """The least time one encoder sampler call could take: the larger of its bytes over
    the memory rate and its tap operations over the peak."""
    taps = batch * S * m["nheads"] * m["num_feature_levels"] * m["enc_n_points"] * \
        (m["hidden_dim"] // m["nheads"]) * TAP_FLOPS
    return max(encoder_sampler_bytes(batch, S, m, value_dtype) / mem_bw, taps / peak_flops)
