"""Every shipped YAML config in the port at its real widths (the port's counterpart of
tests/test_configs_matrix.py): the port's ``setup_eval_cfg``/``setup_train_cfg`` give
JAX's config tree with its derived rules, ``build_model`` gives the expected variant,
``num_queries``, ``voc_size`` and rescoring head at full width, and the port's
state_dict keys and shapes are ``params_from_jax`` over JAX's full-width parameter tree
(its shapes from ``jax.eval_shape``, never ``init_params``), which loads strictly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs")) if f.endswith(".yaml"))


def test_all_eight_shipped_configs_are_covered():
    assert len(CONFIGS) == 8
    assert {c.replace("PP_", "") for c in CONFIGS} == {
        f"GoMatching_{d}.yaml" for d in ("ICDAR15", "DSText", "BOVText", "ArTVideo")}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_the_full_width_model(name):
    from gomatching_tpu.config import setup_eval_cfg as jax_eval_cfg
    from gomatching_tpu.config import setup_train_cfg as jax_train_cfg
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg, setup_train_cfg
    from gomatching_tpu_torch.models.gomatching import build_model, build_pretrain_model
    from gomatching_tpu_torch.weights import canonical_key, load_weights, params_from_jax

    path = os.path.join(ROOT, "configs", name)
    opts = ["MODEL.WEIGHTS", "''"]
    cfg = setup_eval_cfg(path, list(opts))
    assert cfg == jax_eval_cfg(path, list(opts))
    # derived rule: eval forces ASSO_THRESH_TEST := INFERENCE_TH_TEST (eval.py:220)
    assert cfg.MODEL.ASSO_HEAD.ASSO_THRESH_TEST == cfg.MODEL.TRANSFORMER.INFERENCE_TH_TEST
    tcfg = setup_train_cfg(path, list(opts))
    assert tcfg == jax_train_cfg(path, list(opts))
    # derived rule: train forces TH_TEST := TH_TRAIN (train_net.py:167)
    assert tcfg.MODEL.TRANSFORMER.INFERENCE_TH_TEST == tcfg.MODEL.TRANSFORMER.INFERENCE_TH_TRAIN

    t = cfg.MODEL.TRANSFORMER
    model = build_model(cfg)
    spotter = model.detection_transformer
    assert spotter.num_queries == t.NUM_QUERIES == (300 if "DSText" in name else 100)
    voc = spotter.ctrl_point_text[0].out_features - 1
    assert voc == t.VOC_SIZE == (5462 if "BOVText" in name else 37)
    if "BOVText" in name:
        assert t.CUSTOM_DICT == "./chn_cls_list"
    assert model.roi_heads.variant == ("shared" if "_PP_" in name else "lst")
    assert model.with_rescore == cfg.MODEL.ROI_HEADS.WITH_RESR
    assert (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST) == {
        "ICDAR15": (1000, 3000), "DSText": (1280, 3000), "BOVText": (1000, 2400),
        "ArTVideo": (1280, 3000)}[name.split("_")[-1][:-5]]
    build_pretrain_model(tcfg)  # the pretraining meta-arch constructs too

    # JAX's full-width parameter tree, traced on the exact 'xla' sampler (the sampler
    # holds no parameters) at a 128x128 input: enough tokens for 300 queries
    jcfg = jax_eval_cfg(path, opts + ["TPU.SAMPLING_IMPL", "xla"])
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    sd = params_from_jax(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes), cfg)
    port = model.state_dict()
    assert {canonical_key(k) for k in port} == set(sd)
    for k, v in port.items():
        assert tuple(v.shape) == tuple(sd[canonical_key(k)].shape), k
    load_weights(model, sd)
    assert not any(v.any() for v in model.state_dict().values())


def test_unknown_config_key_rejected():
    from gomatching_tpu_torch.config import setup_eval_cfg, setup_train_cfg

    for setup in (setup_eval_cfg, setup_train_cfg):
        with pytest.raises(Exception, match="NO_SUCH_KEY"):
            setup(os.path.join(ROOT, "configs", "GoMatching_BOVText.yaml"),
                  ["MODEL.NO_SUCH_KEY", "1"])
