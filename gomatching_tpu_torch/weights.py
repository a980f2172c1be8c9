"""Weights: the reference key map, JAX params -> port state_dict, and seeded init.

The port's parameter names ARE the reference torch ``state_dict`` keys, so a
reference checkpoint loads with ``load_state_dict``. This module keeps its own copy
of the key map of ``tools/convert_torch_weights.py`` (``build_key_map``: torch key ->
(transform, JAX params path)) and runs it backwards in ``params_from_jax``, which
turns a JAX parameter tree (nested dict of arrays) into the port's state_dict -- the
inverse of that tool's ``convert``. ``init_state_dict`` draws random weights from a
``torch.Generator`` with the reference init scheme. ``pretrain=True`` selects the
spotter-pretraining model (``SpotterPretrainModel``): the same keys without
``roi_heads.*``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .models.gomatching import build_model, build_pretrain_model
from .models.layers import MultiHeadAttention
from .models.lst_matcher import LSTMatcherHead
from .models.spotter import DeepSoloSpotter, MSDeformAttn, offset_grid_bias

PRIOR_PROB = 0.01


# ---------------------------------------------------------------------------
# key map (copy of tools/convert_torch_weights.py:28-231; ResNet backbone only)
# ---------------------------------------------------------------------------


def _linear(out, prefix_t, node, name):
    out[f"{prefix_t}.weight"] = ("linear_w", (node, name, "kernel"))
    out[f"{prefix_t}.bias"] = ("copy", (node, name, "bias"))


def _mlp(out, prefix_t, node, name, n_layers):
    for i in range(n_layers):
        _linear(out, f"{prefix_t}.layers.{i}", node, f"{name}/layers_{i}")


def _mha(out, prefix_t, node, name):
    out[f"{prefix_t}.in_proj_weight"] = ("mha_in_w", (node, name))
    out[f"{prefix_t}.in_proj_bias"] = ("mha_in_b", (node, name))
    _linear(out, f"{prefix_t}.out_proj", node, f"{name}/out_proj")


def _ms_deform_attn(out, prefix_t, node, name):
    for sub in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        _linear(out, f"{prefix_t}.{sub}", node, f"{name}/{sub}")


def _layernorm(out, prefix_t, node, name):
    out[f"{prefix_t}.weight"] = ("copy", (node, name, "scale"))
    out[f"{prefix_t}.bias"] = ("copy", (node, name, "bias"))


def _frozen_bn(out, prefix_t, node, name):
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"{prefix_t}.{k}"] = ("copy", (node, name, k))


def _conv(out, prefix_t, node, name, bias=False):
    out[f"{prefix_t}.weight"] = ("conv_w", (node, name, "kernel"))
    if bias:
        out[f"{prefix_t}.bias"] = ("copy", (node, name, "bias"))


def build_key_map(cfg, pretrain: bool = False) -> Dict[str, tuple]:
    """torch key -> (transform, (JAX node, JAX path...)); ``pretrain``: the
    pretraining model's keys (no ``roi_heads``)."""
    t = cfg.MODEL.TRANSFORMER
    m: Dict[str, tuple] = {}

    bb = "backbone.0.backbone"
    if cfg.MODEL.BACKBONE.NAME != "build_resnet_backbone":
        raise NotImplementedError(f"backbone {cfg.MODEL.BACKBONE.NAME} is not ported yet")
    _conv(m, f"{bb}.stem.conv1", "backbone", "stem_conv1")
    _frozen_bn(m, f"{bb}.stem.conv1.norm", "backbone", "stem_norm1")
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[cfg.MODEL.RESNETS.DEPTH]
    for si, nb in enumerate(blocks):
        stage = f"res{si + 2}"
        for b in range(nb):
            tb = f"{bb}.{stage}.{b}"
            ob = f"{stage}_{b}"
            if b == 0:
                _conv(m, f"{tb}.shortcut", "backbone", f"{ob}/shortcut")
                _frozen_bn(m, f"{tb}.shortcut.norm", "backbone", f"{ob}/shortcut_norm")
            for ci in (1, 2, 3):
                _conv(m, f"{tb}.conv{ci}", "backbone", f"{ob}/conv{ci}")
                _frozen_bn(m, f"{tb}.conv{ci}.norm", "backbone", f"{ob}/norm{ci}")

    # ---- spotter ----
    dt = o = "detection_transformer"
    m[f"{dt}.point_embed.weight"] = ("point_embed", (o, "point_embed"))
    m[f"{dt}.transformer.level_embed"] = ("copy", (o, "level_embed"))
    for i in range(t.NUM_FEATURE_LEVELS):
        _conv(m, f"{dt}.input_proj.{i}.0", o, f"input_proj_{i}_conv", bias=True)
        m[f"{dt}.input_proj.{i}.1.weight"] = ("copy", (o, f"input_proj_{i}_gn", "scale"))
        m[f"{dt}.input_proj.{i}.1.bias"] = ("copy", (o, f"input_proj_{i}_gn", "bias"))
    for i in range(t.ENC_LAYERS):
        te = f"{dt}.transformer.encoder.layers.{i}"
        oe = f"encoder_layer_{i}"
        _ms_deform_attn(m, f"{te}.self_attn", o, f"{oe}/self_attn")
        _layernorm(m, f"{te}.norm1", o, f"{oe}/norm1")
        _linear(m, f"{te}.linear1", o, f"{oe}/ffn/linear1")
        _linear(m, f"{te}.linear2", o, f"{oe}/ffn/linear2")
        _layernorm(m, f"{te}.norm2", o, f"{oe}/ffn/norm")
    for i in range(t.DEC_LAYERS):
        td = f"{dt}.transformer.decoder.layers.{i}"
        od = f"decoder_layer_{i}"
        _mha(m, f"{td}.attn_intra", o, f"{od}/attn_intra")
        _layernorm(m, f"{td}.norm_intra", o, f"{od}/norm_intra")
        _mha(m, f"{td}.attn_inter", o, f"{od}/attn_inter")
        _layernorm(m, f"{td}.norm_inter", o, f"{od}/norm_inter")
        _ms_deform_attn(m, f"{td}.attn_cross", o, f"{od}/attn_cross")
        _layernorm(m, f"{td}.norm_cross", o, f"{od}/norm_cross")
        _linear(m, f"{td}.linear1", o, f"{od}/ffn/linear1")
        _linear(m, f"{td}.linear2", o, f"{od}/ffn/linear2")
        _layernorm(m, f"{td}.norm3", o, f"{od}/ffn/norm")
    _mlp(m, f"{dt}.transformer.decoder.ref_point_head", o, "ref_point_head", 2)
    _linear(m, f"{dt}.transformer.enc_output", o, "enc_output")
    _layernorm(m, f"{dt}.transformer.enc_output_norm", o, "enc_output_norm")
    # shared prediction heads: canonical (index 0) names only; see ``canonical_key``
    _linear(m, f"{dt}.bezier_proposal_class", o, "bezier_proposal_class")
    _mlp(m, f"{dt}.bezier_proposal_coord", o, "bezier_proposal_coord", 3)
    _linear(m, f"{dt}.ctrl_point_class.0", o, "ctrl_point_class")
    _linear(m, f"{dt}.ctrl_point_text.0", o, "ctrl_point_text")
    _mlp(m, f"{dt}.ctrl_point_coord.0", o, "ctrl_point_coord", 3)
    if t.BOUNDARY_HEAD:
        _mlp(m, f"{dt}.boundary_offset.0", o, "boundary_offset", 3)

    if pretrain:
        return m
    # ---- roi_heads (tracker) ----
    r = "roi_heads"
    a = cfg.MODEL.ASSO_HEAD
    for i in range(a.NUM_FC):
        _linear(m, f"{r}.asso_head.fc{i + 1}", r, f"asso_head/fc{i + 1}")
    if cfg.MODEL.ROI_HEADS.WITH_RESR:
        _linear(m, f"{r}.rescoring_head", r, "rescoring_head")
    if not a.NO_POS_EMB:
        m[f"{r}.pos_emb.weight"] = ("copy", (r, "pos_emb"))
        if a.WITH_TEMP_EMB:
            m[f"{r}.temp_emb.weight"] = ("copy", (r, "temp_emb"))
    if a.NUM_WEIGHT_LAYERS > 0:
        for pred in ("asso_predictor", "local_asso_predictor"):
            _mlp(m, f"{r}.{pred}.q_proj", r, f"{pred}/q_proj", a.NUM_WEIGHT_LAYERS)
            _mlp(m, f"{r}.{pred}.k_proj", r, f"{pred}/k_proj", a.NUM_WEIGHT_LAYERS)

    def matcher_keys(name, n_enc, dec_ffn):
        for i in range(n_enc):
            te, oe = f"{r}.{name}.encoder.layers.{i}", f"{name}/enc_{i}"
            _mha(m, f"{te}.self_attn", r, f"{oe}/self_attn")
            _linear(m, f"{te}.linear1", r, f"{oe}/linear1")
            _linear(m, f"{te}.linear2", r, f"{oe}/linear2")
        for i in range(a.NUM_DECODER_LAYERS):
            td, od = f"{r}.{name}.decoder.layers.{i}", f"{name}/dec_{i}"
            _mha(m, f"{td}.multihead_attn", r, f"{od}/cross_attn")
            if dec_ffn:
                _linear(m, f"{td}.linear1", r, f"{od}/linear1")
                _linear(m, f"{td}.linear2", r, f"{od}/linear2")

    if cfg.MODEL.ROI_HEADS.NAME == "SHA_FFN_CRSATTN":  # GoMatching++
        matcher_keys("shared_matcher", 0, dec_ffn=False)
    else:
        for name in ("long_term_matcher", "short_term_matcher"):
            matcher_keys(name, a.NUM_ENCODER_LAYERS, dec_ffn=True)
    return m


# ---------------------------------------------------------------------------
# JAX params -> port state_dict
# ---------------------------------------------------------------------------


def _get(tree: Mapping, node: str, path: str) -> np.ndarray:
    cur = tree[node]
    for p in path.split("/"):
        cur = cur[p]
    return np.asarray(cur)


def params_from_jax(tree: Mapping, cfg, pretrain: bool = False) -> Dict[str, np.ndarray]:
    """JAX params ({'params': {...}} or the inner dict of numpy-convertible arrays)
    -> {canonical torch key: array}. Inverse of tools/convert_torch_weights.convert.
    A tree of gradients converts the same way."""
    if "params" in tree:
        tree = tree["params"]
    t = cfg.MODEL.TRANSFORMER
    sd: Dict[str, np.ndarray] = {}
    for tk, (kind, target) in build_key_map(cfg, pretrain).items():
        node, *path = target
        path = "/".join(path)
        if kind in ("mha_in_w", "mha_in_b"):
            leaf = "kernel" if kind == "mha_in_w" else "bias"
            parts = [_get(tree, node, f"{path}/{p}/{leaf}") for p in ("q_proj", "k_proj", "v_proj")]
            sd[tk] = np.concatenate([p.T for p in parts] if leaf == "kernel" else parts, 0)
            continue
        x = _get(tree, node, path)
        if kind == "linear_w":
            x = x.T
        elif kind == "conv_w":
            x = x.transpose(3, 2, 0, 1)
        elif kind == "point_embed":
            x = x.reshape(t.NUM_QUERIES * t.NUM_POINTS, t.HIDDEN_DIM)
        elif kind != "copy":
            raise ValueError(kind)
        sd[tk] = np.ascontiguousarray(x, dtype=np.float32)
    return sd


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

_HEAD_LIST = re.compile(r"(ctrl_point_class|ctrl_point_text|ctrl_point_coord|boundary_offset)\.\d+")


def canonical_key(key: str) -> str:
    """The name the key map uses for an alias of a shared reference module
    (detection_transformer_wobackbone.py:128-129, :141-155)."""
    key = key.replace("transformer.decoder.ctrl_point_coord", "ctrl_point_coord")
    key = key.replace("transformer.bezier_coord_embed", "bezier_proposal_coord")
    key = key.replace("transformer.bezier_class_embed", "bezier_proposal_class")
    return _HEAD_LIST.sub(r"\1.0", key)


def load_weights(model: nn.Module, state_dict: Mapping) -> None:
    """Strictly load a reference-keyed state_dict into a port module. Keys of the
    reference's raw DeepSolo layout are renamed to the decoupled one
    (``detection_transformer.backbone.`` -> ``backbone.``), and aliases of shared
    heads missing from ``state_dict`` are filled from their canonical key."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("detection_transformer.backbone.0.backbone."):
            k = k.replace("detection_transformer.backbone.", "backbone.", 1)
        sd[k] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    for k in model.state_dict():
        if k not in sd and canonical_key(k) in sd:
            sd[k] = sd[canonical_key(k)]
    model.load_state_dict(sd, strict=True)


# ---------------------------------------------------------------------------
# seeded random init
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference init scheme, drawn from ``generator``: linear/conv kernels
    N(0, 1/fan_in) with zero biases, norms at identity, the sampling-offset grid
    bias and zero offset/attention kernels (spotter.py:54, ms_deform_attn.py:101-109),
    N(0, 1) level/point embeddings, and the prior-probability class bias
    (spotter.py:427), and N(0, 1) tables of the matcher's positional embeddings."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.normal_(0.0, mod.weight[0].numel() ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, MultiHeadAttention):
            mod.in_proj_weight.normal_(0.0, mod.in_proj_weight.shape[1] ** -0.5, generator=generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    bias_prior = -float(np.log((1 - PRIOR_PROB) / PRIOR_PROB))
    for mod in model.modules():
        if isinstance(mod, MSDeformAttn):
            mod.sampling_offsets.weight.zero_()
            mod.sampling_offsets.bias.copy_(torch.from_numpy(
                offset_grid_bias(mod.n_heads, mod.n_levels, mod.n_points)))
            mod.attention_weights.weight.zero_()
            mod.attention_weights.bias.zero_()
        elif isinstance(mod, DeepSoloSpotter):
            mod.transformer.level_embed.normal_(0.0, 1.0, generator=generator)
            mod.point_embed.weight.normal_(0.0, 1.0, generator=generator)
            for head in (mod.bezier_proposal_class, mod.ctrl_point_class[0],
                         mod.ctrl_point_text[0]):
                head.bias.fill_(bias_prior)
        elif isinstance(mod, LSTMatcherHead):
            # the matcher's box / temporal embedding tables (JAX lst_matcher.py:243-254)
            for name in ("pos_emb", "temp_emb"):
                if hasattr(mod, name):
                    getattr(mod, name).weight.normal_(0.0, 1.0, generator=generator)
    return model


def init_state_dict(cfg, generator: torch.Generator,
                    pretrain: bool = False) -> Dict[str, torch.Tensor]:
    """Seeded random weights for the model ``cfg`` describes (CPU tensors)."""
    model = build_pretrain_model(cfg) if pretrain else build_model(cfg)
    return init_weights_(model, generator).state_dict()
