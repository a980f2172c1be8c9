"""GoMatching++ in the production configuration on ``TPU.SAMPLING_IMPL 'pallas'`` (bf16
frozen spotter, its deformable attention through B5 and its table on bf16 value), as the
CPU runs it (B5's plain bf16 version), against the JAX package's, and the sampler
benchmark in JAX's dtype. JAX's spotter calls its Pallas kernel without ``interpret``, so
the JAX side runs 'xla', the function its 'pallas' computes (the exact gather core; its B5
differs from it only in the order of the f32 sums).

Tolerances:
  - the bf16 spot (a 2-frame 64x96 clip, seeded weights): each output within twice JAX's
    own bf16-vs-f32 drift of JAX's bf16 output, with a floor of 1e-2 of the output's
    largest magnitude (tests/test_torch_bf16.py's: the two frameworks round bf16 at other
    places); the f32 spot on 'pallas' within 1e-4 of JAX's f32 one;
  - the production clip (tests/test_production_parity.py's moving rectangles, bf16 and
    I420 on both sides, JAX's own init): tests/test_production_parity.py:176-182's bounds,
    as tests/test_torch_bf16_chain.py holds the default sampler's chain (>= 15 matched
    pairs, coverage >= 0.5, id consistency >= 0.8 over all pairs and >= 0.85 over tight
    ones);
  - the benchmark on the CPU: each sampler's bf16 output within one rounding of the exact
    f32 gather (2**-8 |exact| + 3e-5)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_production_parity import TINY as PARITY_TINY, _clip, track_agreement
from test_torch_bf16 import SPOT_KEYS
from test_torch_train_tracker import FAST_COMPILE, TINY, _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PP = os.path.join(ROOT, "configs", "GoMatching_PP_ICDAR15.yaml")
PALLAS = ["TPU.SAMPLING_IMPL", "pallas"]
PRODUCTION = ["MODEL.PRECISION", "bfloat16", "TPU.UPLOAD_FORMAT", "yuv420"]
# the cheap XLA:CPU options without fusion emitters (tests/test_torch_bf16_chain.py's)
FAST_NO_EMITTERS = {**FAST_COMPILE, "xla_cpu_use_fusion_emitters": False}


def test_pallas_bf16_spot_matches_jax_bf16():
    """The GoMatching++ bf16 spot on 'pallas' (seeded weights, a 2-frame 64x96 clip)
    against JAX's bf16 spot on 'xla': for each output, max |port_bf16 - jax_bf16| <= max(2
    max |jax_bf16 - jax_f32|, 1e-2 max |jax_f32|); on f32 the port's 'pallas' spot within
    1e-4 of JAX's. Every deformable-attention call of the port's spot is B5's."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import cast_frozen_params
    from gomatching_tpu.models.gomatching import GoMatchingModel, build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.models import spotter as spotter_mod
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import load_weights, params_from_jax

    images = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    outs = {}
    for prec in ("float32", "bfloat16"):
        jcfg = jax_cfg(CONFIG_PP, list(TINY) + ["MODEL.PRECISION", prec, "TPU.SAMPLING_IMPL", "xla"])
        jmodel = jax_build(jcfg)
        params = _seeded_params(jmodel, np.random.RandomState(1), hw=(64, 96))
        jp = cast_frozen_params(params, prec)
        fn = lambda p, x: jmodel.apply(p, x, None, method=GoMatchingModel.spot)
        jout = jax.jit(fn).lower(jp, images).compile(FAST_COMPILE)(jp, images)
        tcfg = setup_eval_cfg(CONFIG_PP, list(TINY) + ["MODEL.PRECISION", prec, *PALLAS])
        model = build_model(tcfg)
        load_weights(model, params_from_jax(params, tcfg))
        model.eval().cast_frozen_(torch.bfloat16 if prec == "bfloat16" else torch.float32)
        calls = []
        merged = spotter_mod.ms_deform_attn_merged

        def counted(value, *args):
            calls.append(value.dtype)
            return merged(value, *args)

        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(spotter_mod, "ms_deform_attn_merged", counted)
            tout = model.spot(torch.from_numpy(images))
        want = torch.bfloat16 if prec == "bfloat16" else torch.float32
        assert calls == [want] * 2  # one encoder and one decoder layer, both on B5
        outs[prec] = ({k: np.asarray(jout[k].astype(jnp.float32)) for k in SPOT_KEYS},
                      {k: tout[k].float().numpy() for k in SPOT_KEYS})
    (j32, t32), (j16, t16) = outs["float32"], outs["bfloat16"]
    for k in SPOT_KEYS:
        np.testing.assert_allclose(t32[k], j32[k], rtol=1e-4, atol=1e-4, err_msg=k)
        drift = np.abs(j16[k] - j32[k]).max()
        err = np.abs(t16[k] - j16[k]).max()
        bound = max(2 * drift, 1e-2 * np.abs(j32[k]).max())
        assert drift > 0 and err <= bound, (k, err, drift, bound)


def test_pallas_production_clip_matches_jax_production_chain():
    """tests/test_production_parity.py's moving-rectangles clip through the port's
    GoMatching++ production chain on 'pallas' (bf16, I420) and through JAX's on 'xla' (bf16,
    I420), on JAX's own init (``model.init`` at PRNGKey(0), carried to the port): at least
    15 IoU-matched detections, coverage >= 0.5, id consistency >= 0.8 over all pairs and
    >= 0.85 over tight ones. JAX's programs compile with XLA:CPU's cheap options."""
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import VideoPredictor as JaxPredictor
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.weights import params_from_jax

    frames = _clip()
    tcfg = setup_eval_cfg(CONFIG_PP, PARITY_TINY + PRODUCTION + PALLAS)
    jcfg = jax_cfg(CONFIG_PP, PARITY_TINY + PRODUCTION + ["TPU.SAMPLING_IMPL", "xla"])
    key, x = jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))  # init_params' key and canvas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_NO_EMITTERS))
        params = jax.tree.map(np.asarray, jax.jit(jax_build(jcfg).init)(key, x))
        ref = JaxPredictor(jcfg, params=params).process_video([f.copy() for f in frames])
    predictor = VideoPredictor(tcfg, state_dict=params_from_jax(params, tcfg), device="cpu")
    assert predictor.model.compute_dtype == torch.bfloat16
    assert predictor.upload_format == "yuv420" and predictor.model.roi_heads.variant == "shared"
    prod = predictor.process_video([f.copy() for f in frames])
    assert len(ref) == len(prod) and sum(len(f) for f in ref) > 0
    cov, cons_all, cons_tight, n_pairs = track_agreement(ref, prod)
    print(f"\nport GoMatching++ production chain on 'pallas' vs JAX's on 'xla': coverage="
          f"{cov:.3f} consistency all={cons_all:.3f} tight={cons_tight:.3f} over {n_pairs} pairs")
    assert n_pairs >= 15
    assert cov >= 0.5 and cons_all >= 0.8 and cons_tight >= 0.85, (cov, cons_all, cons_tight)


def test_bench_tool_bf16_on_cpu():
    """The port's sampler benchmark in JAX's dtype (its default), on the CPU: every sampler
    returns bf16 and stays within one rounding of the exact f32 gather."""
    from gomatching_tpu_torch.tools import bench_deform_attn as bench

    res = bench.main(["--cpu", "--size", "48x64", "--batch", "1", "--iters", "1",
                      "--halo", "2", "--tilesets", "8x16,8x16,8x16,8x16;8x8,8x8,8x8,8x8"])
    assert res["dtype"] == "bfloat16"
    impls = [r["impl"] for r in res["results"]]
    assert impls == ["gather", "encoder", "merged", "vmem", "vmem", "vmem_tm", "vmem_tm",
                     "vmem_v3", "vmem_v3", "fused"]
    for r in res["results"]:
        assert r["dtype"] == "bfloat16" and 0 < r["max_abs_err"] and r["round_excess"] <= 0, r
