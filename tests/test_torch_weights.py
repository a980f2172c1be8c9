"""The port's weights module: JAX params -> port state_dict is the exact inverse of
tools/convert_torch_weights.convert, the port's parameter names are the reference
key map's, and the seeded init follows the reference scheme."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")

# the tiny-config recipe of tests/test_inference_e2e.py
TINY_OPTS = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "2",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.WEIGHTS", "''",
]


@pytest.fixture(scope="module")
def cfgs():
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_eval_cfg as port_cfg

    return jax_cfg(CONFIG, list(TINY_OPTS)), port_cfg(CONFIG, list(TINY_OPTS))


def test_params_from_jax_roundtrips_through_convert(cfgs):
    from convert_torch_weights import convert

    from gomatching_tpu.models.gomatching import build_model
    from gomatching_tpu_torch.weights import params_from_jax

    jcfg, tcfg = cfgs
    params = jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.asarray, params)
    sd = params_from_jax(params, tcfg)
    back, missing, unused = convert(sd, jcfg)
    assert not missing and not unused
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("variant", ["shared", "pos_emb"])
def test_matcher_variant_keys_roundtrip(variant):
    """GoMatching++ (configs/GoMatching_PP_ICDAR15.yaml: the shared decoder-only matcher
    without FFN) and the positional-embedding matcher (pos_emb / temp_emb tables):
    params_from_jax inverts convert, the converted weights load strictly into the
    port's model, and the port's names are the key map's. The JAX params are seeded
    numbers in the shapes of ``jax.eval_shape`` of the model's init."""
    from convert_torch_weights import convert

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg as port_cfg
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import (
        build_key_map,
        canonical_key,
        init_state_dict,
        load_weights,
        params_from_jax,
    )

    config, opts = CONFIG, list(TINY_OPTS)
    if variant == "shared":
        config = os.path.join(ROOT, "configs", "GoMatching_PP_ICDAR15.yaml")
    else:
        opts += ["MODEL.ASSO_HEAD.NO_POS_EMB", "False", "MODEL.ASSO_HEAD.WITH_TEMP_EMB", "True"]
    jcfg, tcfg = jax_cfg(config, list(opts)), port_cfg(config, list(opts))
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda x: rng.randn(*x.shape).astype(x.dtype), shapes)
    sd = params_from_jax(params, tcfg)
    want_keys = {"shared": "roi_heads.shared_matcher.decoder.layers.0.multihead_attn.in_proj_weight",
                 "pos_emb": "roi_heads.temp_emb.weight"}[variant]
    assert want_keys in sd
    assert any("long_term_matcher" in k for k in sd) == (variant != "shared")
    back, missing, unused = convert(sd, jcfg)
    assert not missing and not unused
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    load_weights(build_model(tcfg), sd)
    port = init_state_dict(tcfg, torch.Generator().manual_seed(0))
    assert {canonical_key(k) for k in port} == set(build_key_map(tcfg))


def test_port_names_are_the_reference_key_map(cfgs):
    """Every port state_dict key is a key-map key or an alias of a shared head that
    holds the same tensor, and the key map names nothing the port lacks."""
    from gomatching_tpu_torch.weights import build_key_map, canonical_key, init_state_dict

    _, tcfg = cfgs
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(0))
    key_map = build_key_map(tcfg)
    assert {canonical_key(k) for k in sd} == set(key_map)
    for k, v in sd.items():
        if k not in key_map:
            assert v.data_ptr() == sd[canonical_key(k)].data_ptr(), k


def test_init_is_seeded_and_follows_the_reference_scheme(cfgs):
    from gomatching_tpu_torch.models.spotter import offset_grid_bias
    from gomatching_tpu_torch.weights import PRIOR_PROB, init_state_dict

    _, tcfg = cfgs
    a = init_state_dict(tcfg, torch.Generator().manual_seed(3))
    b = init_state_dict(tcfg, torch.Generator().manual_seed(3))
    c = init_state_dict(tcfg, torch.Generator().manual_seed(4))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    key = "detection_transformer.point_embed.weight"
    assert not torch.equal(a[key], c[key])
    p = "detection_transformer.transformer.encoder.layers.0.self_attn."
    np.testing.assert_array_equal(a[p + "sampling_offsets.bias"].numpy(), offset_grid_bias(4, 4, 4))
    assert not a[p + "sampling_offsets.weight"].any()
    assert not a[p + "attention_weights.weight"].any()
    prior = -np.log((1 - PRIOR_PROB) / PRIOR_PROB)
    for head in ("bezier_proposal_class", "ctrl_point_class.0", "ctrl_point_text.0"):
        np.testing.assert_allclose(a[f"detection_transformer.{head}.bias"].numpy(), prior,
                                   rtol=1e-6)
    bn = "backbone.0.backbone.res2.0.conv1.norm."
    assert torch.equal(a[bn + "running_var"], torch.ones(64))


def test_offset_grid_bias_matches_jax_init():
    from gomatching_tpu.models.spotter import _offset_grid_init
    from gomatching_tpu_torch.models.spotter import offset_grid_bias

    want = np.asarray(_offset_grid_init(8, 4, 4)(None, (8 * 4 * 4 * 2,)))
    np.testing.assert_array_equal(offset_grid_bias(8, 4, 4), want)


def test_predictor_loads_a_reference_checkpoint(cfgs, tmp_path):
    """MODEL.WEIGHTS in the reference's raw DeepSolo layout (backbone under
    detection_transformer, shared-head aliases absent) loads strictly."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.weights import build_key_map, init_state_dict

    _, tcfg = cfgs
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(5))
    raw = {}
    for k in build_key_map(tcfg):
        name = k.replace("backbone.0.backbone.", "detection_transformer.backbone.0.backbone.")
        raw[name] = sd[k].clone()
    path = tmp_path / "ckpt.pth"
    torch.save({"model": raw}, path)
    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["MODEL.WEIGHTS", str(path)])
    pred = VideoPredictor(cfg, device="cpu")
    got = pred.model.state_dict()
    assert set(got) == set(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["missing", "npz"])
def test_predictor_refuses_weights_it_cannot_load(tmp_path, kind):
    """Random weights only for MODEL.WEIGHTS ''; a missing file, or an .npz that does not
    hold the config's JAX params, raises."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    path = tmp_path / "deepsolo_ic15.npz"
    if kind == "npz":
        np.savez(path, w=np.zeros(3, np.float32))
    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["MODEL.WEIGHTS", str(path)])
    err = FileNotFoundError if kind == "missing" else ValueError
    with pytest.raises(err, match="MODEL.WEIGHTS"):
        VideoPredictor(cfg, device="cpu")


@pytest.mark.parametrize("name", ["ICDAR15", "DSText", "BOVText", "ArTVideo"])
def test_gomatching_pp_configs_build_the_shared_matcher(name):
    """Every configs/GoMatching_PP_*.yaml parses in the port and builds GoMatching++."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.models.gomatching import build_model

    cfg = setup_eval_cfg(os.path.join(ROOT, "configs", f"GoMatching_PP_{name}.yaml"),
                         list(TINY_OPTS) + ["TPU.SAMPLING_IMPL", "pallas"])
    assert cfg.MODEL.ROI_HEADS.NAME == "SHA_FFN_CRSATTN"
    model = build_model(cfg)
    assert model.roi_heads.variant == "shared" and not hasattr(model.roi_heads,
                                                               "long_term_matcher")
    assert {m.sampling_impl for m in model.modules() if hasattr(m, "sampling_impl")} == {"pallas"}
