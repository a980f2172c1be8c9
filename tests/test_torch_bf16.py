"""The production precision path of the port (``MODEL.PRECISION`` bfloat16 and
``TPU.ASSOC_PRECISION``) against the JAX package's: which tensors are cast, the gate of
the bf16 matcher, the association logits' drift and the bf16 spot outputs.
tests/test_torch_bf16_chain.py holds the production chain end to end;
tests/test_torch_train_precision.py the bf16 tracker step and a repair (pretraining runs
f32 whatever ``MODEL.PRECISION`` says); tests/test_torch_train_i420.py the tracker step on
the I420 wire; tests/test_torch_config_guards.py the refusal of B5 in bf16 and the other
repair (the tracker trainer reads neither of the inference keys).

Tolerances: the association logits within tests/test_assoc_bf16.py:73's bound of the
f32 matcher (0.05 (1 + max |f32 logit|)); each bf16 spot output within twice JAX's own
bf16-vs-f32 drift of JAX's bf16 output, with a floor of 1e-2 of the output's largest
magnitude (the two frameworks round bf16 at other places)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_train_tracker import FAST_COMPILE, TINY, _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
CONFIG_PP = os.path.join(ROOT, "configs", "GoMatching_PP_ICDAR15.yaml")
BF16 = ["MODEL.PRECISION", "bfloat16"]
SPOT_KEYS = ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points",
             "pred_text_logits", "query_features")


def _eval_cfg(config, *opts):
    from gomatching_tpu_torch.config import setup_eval_cfg

    return setup_eval_cfg(config, list(TINY) + list(opts))


def _predictor(config, *opts):
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    return VideoPredictor(_eval_cfg(config, *opts), device="cpu")


@pytest.mark.parametrize("config", [CONFIG, CONFIG_PP], ids=["lst", "shared"])
def test_cast_tensors_are_jax_cast_subtrees(config):
    """Under MODEL.PRECISION bfloat16 the port's bf16 tensors are exactly the leaves that
    JAX's cast_frozen_params and cast_assoc_params cast (tests/test_assoc_bf16.py:41-55):
    backbone, detection_transformer (FrozenBN statistics included) and the matchers; reid
    (asso_head) and rescore stay f32, and so does the Bernstein basis, a constant of the
    computation."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import cast_assoc_params, cast_frozen_params
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.weights import canonical_key, params_from_jax

    opts = list(TINY) + BF16
    jcfg = jax_cfg(config, opts)
    tree = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    cast = cast_assoc_params(cast_frozen_params(tree, "bfloat16"), "bfloat16")
    # 1 where JAX casts a leaf, carried to the port's names by the weights' own mapping
    marks = params_from_jax(jax.tree.map(lambda x: np.full(x.shape, x.dtype == jnp.bfloat16,
                                                           np.float32), cast),
                            _eval_cfg(config, *BF16))
    want = {k for k, v in marks.items() if bool(torch.as_tensor(v).bool().all())}
    assert not any(bool(torch.as_tensor(v).bool().any()) for k, v in marks.items()
                   if k not in want)
    model = _predictor(config, *BF16).model
    # the shared heads' aliases under their canonical names
    sd = {canonical_key(k): v for k, v in model.state_dict().items()}
    assert set(sd) == set(marks)
    got = {k for k, v in sd.items() if v.dtype == torch.bfloat16}
    assert got == want
    assert all(sd[k].dtype == torch.float32 for k in sd if k not in got)
    assert any(k.startswith("roi_heads.") for k in got)
    assert not any(k.startswith(("roi_heads.asso_head.", "roi_heads.rescoring_head."))
                   for k in got)
    assert model.detection_transformer.bernstein.dtype == torch.float32


@pytest.mark.parametrize("precision,assoc,no_pos_emb,want", [
    ("bfloat16", "", True, torch.bfloat16),
    ("bfloat16", "", False, torch.float32),
    ("bfloat16", "float32", True, torch.float32),
    ("float32", "bfloat16", True, torch.bfloat16),
])
def test_assoc_precision_follows_jax(precision, assoc, no_pos_emb, want):
    """The matcher's dtype: TPU.ASSOC_PRECISION, '' following MODEL.PRECISION, and f32
    whenever NO_POS_EMB is False (JAX predictor.py:146-147); the spotter follows
    MODEL.PRECISION alone."""
    p = _predictor(CONFIG, "MODEL.PRECISION", precision, "TPU.ASSOC_PRECISION", f"'{assoc}'",
                   "MODEL.ASSO_HEAD.NO_POS_EMB", str(no_pos_emb))
    assert p.assoc_dtype == want
    assert all(t.dtype == want for t in p.model.roi_heads.long_term_matcher.parameters())
    spot = p.model.backbone[0].backbone.stem.conv1.weight.dtype
    assert spot == (torch.bfloat16 if precision == "bfloat16" else torch.float32)


def test_association_logits_bf16_drift_bound():
    """The bf16 matcher's logits come back f32 within 0.05 (1 + max |a|) of the f32
    matcher's on the same weights, short and long term (tests/test_assoc_bf16.py:63-74)."""
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    f32 = _predictor(CONFIG)
    bf16 = VideoPredictor(_eval_cfg(CONFIG, "TPU.ASSOC_PRECISION", "bfloat16"),
                          state_dict=f32.model.state_dict(), device="cpu")
    assert bf16.assoc_dtype == torch.bfloat16
    rng = np.random.RandomState(0)
    toks = rng.randn(2, 16, f32.cfg.MODEL.ASSO_HEAD.FC_DIM).astype(np.float32)
    valid = np.zeros((2, 16), bool)
    valid[:, :11] = True
    for short in (True, False):
        a = f32.associate(toks, valid, short)
        b = bf16.associate(toks, valid, short)
        assert b.dtype == np.float32 and np.abs(a - b).max() > 0
        assert np.abs(a - b).max() <= 0.05 * (1.0 + np.abs(a).max()), (short, np.abs(a - b).max())


def test_spot_outputs_bf16_match_jax_bf16():
    """The bf16 spot (seeded weights, a 2-frame 64x96 clip) against JAX's bf16 spot with
    SAMPLING_IMPL 'xla': for each output, max |port_bf16 - jax_bf16| <= max(2 max
    |jax_bf16 - jax_f32|, 1e-2 max |jax_f32|). The port's f32 spot agrees with JAX's f32
    one within 1e-4 (the sampler route is exact on both sides). JAX compiles with XLA:CPU's
    cheap options."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import cast_frozen_params
    from gomatching_tpu.models.gomatching import GoMatchingModel, build_model as jax_build
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import load_weights, params_from_jax

    images = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    outs = {}
    for prec in ("float32", "bfloat16"):
        opts = list(TINY) + ["MODEL.PRECISION", prec, "TPU.SAMPLING_IMPL", "xla"]
        jcfg = jax_cfg(CONFIG, opts)
        jmodel = jax_build(jcfg)
        params = _seeded_params(jmodel, np.random.RandomState(1), hw=(64, 96))
        jp = cast_frozen_params(params, prec)
        fn = lambda p, x: jmodel.apply(p, x, None, method=GoMatchingModel.spot)
        jout = jax.jit(fn).lower(jp, images).compile(FAST_COMPILE)(jp, images)
        tcfg = _eval_cfg(CONFIG, "MODEL.PRECISION", prec)
        model = build_model(tcfg)
        load_weights(model, params_from_jax(params, tcfg))
        model.eval().cast_frozen_(torch.bfloat16 if prec == "bfloat16" else torch.float32)
        with torch.no_grad():
            tout = model.spot(torch.from_numpy(images))
        outs[prec] = ({k: np.asarray(jout[k].astype(jnp.float32)) for k in SPOT_KEYS},
                      {k: tout[k].float().numpy() for k in SPOT_KEYS})
    (j32, t32), (j16, t16) = outs["float32"], outs["bfloat16"]
    for k in SPOT_KEYS:
        np.testing.assert_allclose(t32[k], j32[k], rtol=1e-4, atol=1e-4, err_msg=k)
        drift = np.abs(j16[k] - j32[k]).max()
        err = np.abs(t16[k] - j16[k]).max()
        bound = max(2 * drift, 1e-2 * np.abs(j32[k]).max())
        assert drift > 0 and err <= bound, (k, err, drift, bound)


def test_eval_cli_runs_the_production_configuration(tmp_path, monkeypatch):
    """``python -m gomatching_tpu_torch.eval --cpu`` with MODEL.PRECISION bfloat16,
    TPU.ASSOC_PRECISION bfloat16 and TPU.UPLOAD_FORMAT yuv420: every frame batch goes as
    I420 through the bf16 spotter and matcher, and the XML/JSON tree is written."""
    import cv2

    import gomatching_tpu_torch.engine.predictor as predictor_mod
    from gomatching_tpu_torch import eval as port_eval
    from test_torch_e2e import TINY_OPTS, _frames

    video = tmp_path / "videos" / "Video_1_1_1"
    video.mkdir(parents=True)
    for i, f in enumerate(_frames(6)):
        cv2.imwrite(str(video / f"{i + 1}.jpg"), f)
    seen = []
    decode = predictor_mod.decode_i420
    monkeypatch.setattr(predictor_mod, "decode_i420", lambda x: seen.append(x.shape) or decode(x))
    spot = predictor_mod.VideoPredictor.spot_batch_packed

    def spot_batch(self, frames, hw):
        seen.append((self.model.compute_dtype, self.assoc_dtype))
        return spot(self, frames, hw)

    monkeypatch.setattr(predictor_mod.VideoPredictor, "spot_batch_packed", spot_batch)
    opts = [o for o in TINY_OPTS if o not in ("TPU.SAMPLING_IMPL", "xla")]
    port_eval.main(["--config-file", CONFIG, "--cpu", "--input", str(tmp_path / "videos"),
                    "--output", str(tmp_path / "out"), "--opts", *opts, *BF16,
                    "TPU.ASSOC_PRECISION", "bfloat16", "TPU.UPLOAD_FORMAT", "yuv420"])
    assert seen == [(torch.bfloat16, torch.bfloat16), (2, 144, 128)] * 3
    out = tmp_path / "out"
    assert (out / "preds" / "res_Video_1_1_1.xml").exists()
    assert (out / "jsons" / "Video_1_1_1.json").exists()
