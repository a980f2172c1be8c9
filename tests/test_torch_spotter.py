"""The port's spotter against the reference goldens and against the JAX package.

- tests/golden/data/spotter_tiny.npz holds the reference DETECTION_TRANSFORMER's
  state_dict and outputs; the port loads the 174 ``sd.detection_transformer.*``
  arrays with ``load_state_dict(strict=True)`` and must reproduce ``sq.out.*`` and
  ``pad.out.*`` at the tolerance of tests/test_golden_spotter.py (rtol 1e-4,
  atol 2e-4).
- On the same ``params_from_jax`` weights, the port's ResNet + position encodings
  and its spotter match JAX's (spotter with SAMPLING_IMPL=xla, the exact sampler).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "golden", "data", "spotter_tiny.npz")
CONFIG = os.path.join(os.path.dirname(ROOT), "configs", "GoMatching_ICDAR15.yaml")
OUT_KEYS = ["pred_logits", "pred_text_logits", "pred_ctrl_points", "pred_bd_points",
            "query_features"]
TINY_OPTS = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "2",
    "MODEL.TRANSFORMER.DEC_LAYERS", "2",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.TRANSFORMER.VOC_SIZE", "10",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.WEIGHTS", "''",
    "TPU.SAMPLING_IMPL", "xla",
]


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _golden_inputs(golden, case):
    from gomatching_tpu_torch.models.pos_encoding import position_encoding_2d

    feats = [torch.from_numpy(golden[f"{case}.feat{l}"]) for l in range(3)]
    masks = [torch.from_numpy(golden[f"{case}.mask{l}"]) for l in range(3)]
    if not any(bool(m.any()) for m in masks):
        masks = None
    pos = [
        position_encoding_2d((f.shape[0], f.shape[2], f.shape[3]), 32, 10000.0,
                             None if masks is None else masks[i])
        for i, f in enumerate(feats)
    ]
    return feats, pos, masks


@pytest.mark.parametrize("case", ["sq", "pad"])
def test_spotter_matches_reference_golden(golden, case):
    from gomatching_tpu_torch.models.spotter import DeepSoloSpotter

    spotter = DeepSoloSpotter(d_model=64, n_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=64, num_queries=8, num_points=5, voc_size=10)
    prefix = "sd.detection_transformer."
    sd = {k[len(prefix):]: torch.from_numpy(golden[k]) for k in golden.files
          if k.startswith(prefix)}
    assert len(sd) == 174
    spotter.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = spotter(*_golden_inputs(golden, case))
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].numpy(), golden[f"{case}.out.{k}"], rtol=1e-4,
                                   atol=2e-4, err_msg=f"{case}.{k}")


@pytest.fixture(scope="module")
def shared_models():
    """The JAX GoMatchingModel (random init) and the port's on the same weights."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg as port_cfg
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import load_weights, params_from_jax

    jcfg, tcfg = jax_cfg(CONFIG, list(TINY_OPTS)), port_cfg(CONFIG, list(TINY_OPTS))
    jmodel = jax_build(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.asarray, params)
    model = build_model(tcfg).eval()
    load_weights(model, params_from_jax(params, tcfg))
    return jmodel, params, model


def test_backbone_and_position_encoding_match_jax(shared_models):
    jmodel, params, model = shared_models
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply(p, x, method=lambda m, y: m.backbone(y)))(
        params, jnp.asarray(img))
    with torch.no_grad():
        feats, pos = model.features(torch.from_numpy(img))
    from gomatching_tpu.models.pos_encoding import position_encoding_2d as jax_pos

    for f, p, name in zip(feats, pos, ("res3", "res4", "res5")):
        w = np.asarray(want[name])
        got = f.permute(0, 2, 3, 1).numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5 * scale, err_msg=name)
        wp = np.asarray(jax_pos((w.shape[0], w.shape[1], w.shape[2]), 32, 10000.0, None))
        np.testing.assert_allclose(p.numpy(), wp, atol=1e-5, err_msg=f"pos {name}")


def test_masked_position_encodings_match_jax():
    from gomatching_tpu.models.pos_encoding import point_query_pos_embed as jax_pts
    from gomatching_tpu.models.pos_encoding import position_encoding_2d as jax_pos
    from gomatching_tpu_torch.models.pos_encoding import (
        point_query_pos_embed,
        position_encoding_2d,
    )

    rng = np.random.RandomState(1)
    mask = np.zeros((2, 5, 7), bool)
    mask[0, 3:] = True
    mask[1, :, 4:] = True
    got = position_encoding_2d((2, 5, 7), 16, 10000.0, torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_pos((2, 5, 7), 16, 10000.0, jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    pts = rng.rand(3, 4, 2).astype(np.float32)
    np.testing.assert_allclose(point_query_pos_embed(torch.from_numpy(pts), 32, 10000.0).numpy(),
                               np.asarray(jax_pts(jnp.asarray(pts), 32, 10000.0)), atol=1e-5)


@pytest.mark.parametrize("padded", [False, True])
def test_spotter_matches_jax_xla_sampler(shared_models, padded):
    """Without masks the port's encoder runs the B2 op (the JAX side: the exact
    gather core); with masks both run the masked-token path. Tolerance as the
    golden test: rtol 1e-4, atol 2e-4."""
    from gomatching_tpu.models.pos_encoding import position_encoding_2d as jax_pos
    from gomatching_tpu_torch.models.pos_encoding import position_encoding_2d

    jmodel, params, model = shared_models
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, c, h, w).astype(np.float32)
             for c, h, w in ((512, 24, 32), (1024, 12, 16), (2048, 6, 8))]
    masks = None
    if padded:
        masks = []
        for h, w in ((24, 32), (12, 16), (6, 8)):
            m = np.zeros((1, h, w), bool)
            m[:, (3 * h) // 4:] = True
            m[:, :, (5 * w) // 8:] = True
            masks.append(m)
    jfeats = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats]
    jmasks = None if masks is None else [jnp.asarray(m) for m in masks]
    jpos = [jax_pos((1, f.shape[1], f.shape[2]), 32, 10000.0, None if jmasks is None else jmasks[i])
            for i, f in enumerate(jfeats)]
    want = jax.jit(lambda p, f, q, k: jmodel.apply(p, f, q, k, method=lambda m, *a: m.spotter(*a)))(
        params, jfeats, jpos, jmasks)
    tmasks = None if masks is None else [torch.from_numpy(m) for m in masks]
    tpos = [position_encoding_2d((1, f.shape[2], f.shape[3]), 32, 10000.0,
                                 None if tmasks is None else tmasks[i])
            for i, f in enumerate(feats)]
    with torch.no_grad():
        got = model.detection_transformer([torch.from_numpy(f) for f in feats], tpos, tmasks)
    for k in OUT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["sq", "pad"])
def test_spotter_pallas_sampler_matches_jax(golden, case, monkeypatch):
    """SAMPLING_IMPL='pallas' sends every deformable-attention call of the port's
    spotter (encoder, masked encoder, decoder) to B5's op, whose plain version runs
    here, and nothing to B1/B2. It is held against the JAX spotter on the same
    spotter_tiny.npz weights through the production converter, at the tolerance of
    the golden test (rtol 1e-4, atol 2e-4), and against the golden outputs. The JAX
    side runs 'xla': its spotter calls ms_deform_attn_pallas without interpret
    (gomatching_tpu/models/spotter.py:229), so 'pallas' cannot run there on the CPU;
    'xla' is the same function, and tests/test_deform_attn_pallas.py holds the two
    equal."""
    import sys

    import gomatching_tpu_torch.models.spotter as spotter_mod
    from gomatching_tpu_torch.models.spotter import DeepSoloSpotter

    sys.path.insert(0, os.path.join(os.path.dirname(ROOT), "tools"))
    sys.path.insert(0, os.path.join(ROOT, "golden"))
    from convert_torch_weights import convert
    from ref_loader import tiny_cfg

    from gomatching_tpu.models.pos_encoding import position_encoding_2d as jax_pos
    from gomatching_tpu.models.spotter import DeepSoloSpotter as JaxSpotter

    calls = []
    merged = spotter_mod.ms_deform_attn_merged

    def counted(*args):
        calls.append(args[2].shape[1])
        return merged(*args)

    def refused(*args):
        raise AssertionError("the 'pallas' route reached B1/B2")

    monkeypatch.setattr(spotter_mod, "ms_deform_attn_merged", counted)
    monkeypatch.setattr(spotter_mod, "ms_deform_attn_queries", refused)
    monkeypatch.setattr(spotter_mod, "ms_deform_attn_encoder", refused)
    spotter = DeepSoloSpotter(d_model=64, n_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                              dim_feedforward=64, num_queries=8, num_points=5, voc_size=10,
                              sampling_impl="pallas")
    prefix = "sd.detection_transformer."
    sd = {k[len(prefix):]: torch.from_numpy(golden[k]) for k in golden.files
          if k.startswith(prefix)}
    spotter.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = spotter(*_golden_inputs(golden, case))
    assert len(calls) == 4  # 2 encoder + 2 decoder layers

    cfg = tiny_cfg()
    tree, _, _ = convert({k[len("sd."):]: golden[k] for k in golden.files if k.startswith("sd.")},
                         cfg)
    t = cfg.MODEL.TRANSFORMER
    jspot = JaxSpotter(d_model=t.HIDDEN_DIM, n_heads=t.NHEADS, num_encoder_layers=t.ENC_LAYERS,
                       num_decoder_layers=t.DEC_LAYERS, dim_feedforward=t.DIM_FEEDFORWARD,
                       num_queries=t.NUM_QUERIES, num_points=t.NUM_POINTS, voc_size=t.VOC_SIZE,
                       in_channels=(512, 1024, 2048), boundary_head=t.BOUNDARY_HEAD,
                       sampling_impl="xla")
    feats = [jnp.asarray(golden[f"{case}.feat{l}"].transpose(0, 2, 3, 1)) for l in range(3)]
    masks = [jnp.asarray(golden[f"{case}.mask{l}"]) for l in range(3)]
    masks = masks if any(bool(m.any()) for m in masks) else None
    pos = [jax_pos((f.shape[0], f.shape[1], f.shape[2]), 32, 10000.0,
                   None if masks is None else masks[i]) for i, f in enumerate(feats)]
    want = jax.jit(lambda p, f, q, k: jspot.apply(p, f, q, k))(
        {"params": tree["params"]["detection_transformer"]}, feats, pos, masks)
    for k in OUT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=2e-4,
                                   err_msg=f"{case}.{k} vs JAX")
        np.testing.assert_allclose(got[k].numpy(), golden[f"{case}.out.{k}"], rtol=1e-4,
                                   atol=2e-4, err_msg=f"{case}.{k} vs golden")
