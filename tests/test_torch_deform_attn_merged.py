"""The port's corner-merged sampler (B5's plain version, as the CPU runs it) against the
JAX package: the table and slot weights against ``_merged_corner_table`` /
``_merged_indices_and_slot_weights`` (atol 1e-6), the sampler against
``ms_deform_attn_pallas`` in interpret mode and the gather core ``ms_deform_attn_core``
(rtol 1e-4, atol 1e-5, as tests/test_deform_attn_pallas.py), and against the port's
B1 plain version (``grid_sample``, atol 1e-5). Cases: the encoder (Lq = S), the decoder
(Lq != S), and 1-wide / 1-tall levels; locations in [-0.2, 1.2]."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_merged as dam

CASES = {
    "encoder": dict(shapes=((8, 10), (4, 5), (2, 3)), B=2, M=2, D=8, P=2, Lq=None),
    "decoder": dict(shapes=((6, 8), (3, 4)), B=1, M=4, D=8, P=3, Lq=17),
    "degenerate": dict(shapes=((1, 7), (5, 1), (1, 1), (3, 4)), B=1, M=2, D=4, P=3, Lq=13),
}


def _inputs(case, seed=0):
    c = CASES[case]
    shapes, B, M, D, P = c["shapes"], c["B"], c["M"], c["D"], c["P"]
    S = sum(h * w for h, w in shapes)
    Lq = S if c["Lq"] is None else c["Lq"]
    L = len(shapes)
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Lq, M, L, P, 2)).astype(np.float32)
    w = rng.rand(B, Lq, M, L * P).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return value, list(shapes), loc, w.reshape(B, Lq, M, L, P)


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_and_slot_weights_match_jax(case):
    from gomatching_tpu.ops.deform_attn import (
        _merged_corner_table,
        _merged_indices_and_slot_weights,
    )

    value, shapes, loc, attn = _inputs(case)
    vbm = np.ascontiguousarray(value.transpose(0, 2, 1, 3))
    got = dam.merged_corner_table(torch.from_numpy(value).permute(0, 2, 1, 3), shapes).numpy()
    np.testing.assert_allclose(got, np.asarray(_merged_corner_table(jnp.asarray(vbm), shapes)),
                               rtol=0, atol=1e-6)
    # the table entry the CUDA path launches as a kernel runs this plain version here
    np.testing.assert_array_equal(dam.merged_table(torch.from_numpy(value), shapes).numpy(), got)
    idx, slot_w = dam.merged_indices_and_slot_weights(torch.from_numpy(loc),
                                                      torch.from_numpy(attn), shapes)
    want_idx, want_w = _merged_indices_and_slot_weights(jnp.asarray(loc), jnp.asarray(attn), shapes)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(slot_w.numpy(), np.asarray(want_w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_core_and_grid_sample(case):
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas

    value, shapes, loc, attn = _inputs(case, seed=1)
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    got = dam.ms_deform_attn_merged(*args).numpy()
    B, Lq, M = loc.shape[:3]
    assert got.shape == (B, Lq, M * value.shape[-1])
    jargs = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    np.testing.assert_allclose(got, np.asarray(ms_deform_attn_pallas(*jargs, interpret=True)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ms_deform_attn_core(*jargs)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, da.ms_deform_attn_queries_plain(*args).numpy(), atol=1e-5)


def test_wrapper_raises_under_autograd_and_counts_no_cpu_launch():
    value, shapes, loc, attn = _inputs("decoder", seed=2)
    v = torch.from_numpy(value).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        dam.ms_deform_attn_merged(v, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    before = dict(da.launch_counts)
    with torch.no_grad():
        out = dam.ms_deform_attn_merged(v, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
    assert out.shape == (1, 17, 4 * 8) and da.launch_counts == before
    # the kernel entry on a prebuilt table takes CUDA tensors only
    table = dam.merged_corner_table(v.detach().permute(0, 2, 1, 3), shapes)
    with pytest.raises(ValueError, match="CUDA"):
        dam.merged_sample(table, shapes, torch.from_numpy(loc), torch.from_numpy(attn))


def test_unknown_sampling_impl_raises():
    import os

    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.models.spotter import DeepSoloSpotter, MSDeformAttn

    with pytest.raises(ValueError, match="SAMPLING_IMPL"):
        MSDeformAttn(32, 2, 2, 2, sampling_impl="gather")
    with pytest.raises(ValueError, match="SAMPLING_IMPL"):
        DeepSoloSpotter(d_model=32, n_heads=2, num_encoder_layers=1, num_decoder_layers=1,
                        dim_feedforward=32, num_queries=2, num_points=2, sampling_impl="")
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "GoMatching_PP_ICDAR15.yaml")
    cfg = setup_eval_cfg(config, ["MODEL.TRANSFORMER.ENC_LAYERS", "1",
                                  "MODEL.TRANSFORMER.DEC_LAYERS", "1",
                                  "TPU.SAMPLING_IMPL", "grid_sample"])
    with pytest.raises(ValueError, match="SAMPLING_IMPL"):
        build_model(cfg)
