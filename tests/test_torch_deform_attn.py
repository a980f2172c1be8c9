"""The port's deformable-attention ops (plain versions, as the CPU runs them) against
the JAX package: the decoder kernel B1 (``ms_deform_attn_queries_vmem``, interpret
mode), the encoder kernel B2 (``ms_deform_attn_encoder_vmem_v2``, interpret mode,
offsets inside its halo) and the exact gather core (offsets beyond the halo)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gomatching_tpu_torch.ops import deform_attn as da

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3)]
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 4, 8, 4, 4
TILES = (8, 8, 4, 2)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _grid_refs():
    refs = []
    for h, w in SHAPES:
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        refs.append(np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1))
    return np.concatenate(refs, 0)  # (S, 2)


def test_queries_plain_matches_jax_kernel_and_core():
    """B1 with out-of-range locations and Lq not a query-block multiple;
    atol 3e-5 as tests/test_deform_attn_vmem.py::test_decoder_queries_vmem_exact."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_dec_vmem import ms_deform_attn_queries_vmem

    rng = np.random.RandomState(0)
    Lq = 37
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = _softmax(rng.randn(B, Lq, M, L * P).astype(np.float32)).reshape(B, Lq, M, L, P)
    got = da.ms_deform_attn_queries(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc), torch.from_numpy(attn)
    ).numpy()
    want_core = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                               jnp.asarray(attn), query_chunk=0))
    want_vmem = np.asarray(ms_deform_attn_queries_vmem(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn), query_block=16,
        interpret=True))
    assert got.shape == (B, Lq, M * D)
    np.testing.assert_allclose(got, want_core, atol=3e-5)
    np.testing.assert_allclose(got, want_vmem, atol=3e-5)


def _encoder_inputs(seed, offset_cells):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D).astype(np.float32)
    off = rng.uniform(-offset_cells, offset_cells, (B, S, M, L, P, 2)).astype(np.float32)
    logits = rng.randn(B, S, M, L * P).astype(np.float32)
    return value, off, logits


def _port_encoder(value, off, logits):
    return da.ms_deform_attn_encoder(
        torch.from_numpy(value), SHAPES, torch.from_numpy(off), torch.from_numpy(logits)
    ).numpy()


def test_encoder_plain_matches_jax_vmem_v2_inside_halo():
    """B2 against the TPU kernel where the kernel is exact: offsets within its halo
    (pattern: tests/test_deform_attn_vmem.py:74-117); atol 3e-5."""
    from gomatching_tpu.ops.deform_attn_vmem import (
        ms_deform_attn_encoder_vmem_v2,
        tile_major_inverse,
        tile_major_perm,
    )

    value, off, logits = _encoder_inputs(seed=2, offset_cells=1.5)
    attn = _softmax(logits).reshape(B, S, M, L, P)
    perm, _ = tile_major_perm(SHAPES, TILES)
    offT = np.transpose(off[:, perm], (0, 3, 5, 2, 4, 1)).reshape(B, L * 2 * M * P, -1)
    attnT = np.transpose(attn[:, perm], (0, 3, 2, 4, 1)).reshape(B, L * M * P, -1)
    got_tm = ms_deform_attn_encoder_vmem_v2(
        jnp.asarray(value), SHAPES, jnp.asarray(offT), jnp.asarray(attnT), halo=2,
        tile_sizes=TILES, interpret=True,
    )
    want = np.asarray(jnp.take(got_tm, jnp.asarray(tile_major_inverse(SHAPES, TILES)), axis=1))
    np.testing.assert_allclose(_port_encoder(value, off, logits), want, atol=3e-5)


@pytest.mark.parametrize("offset_cells", [1.5, 20.0])
def test_encoder_plain_is_exact_beyond_halo(offset_cells):
    """B2 equals the exact gather core on reference points + offsets, also where
    offsets reach far beyond TPU.TILED_HALO (the TPU kernel drops that mass);
    atol 3e-5."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    value, off, logits = _encoder_inputs(seed=3, offset_cells=offset_cells)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    loc = _grid_refs()[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
    attn = _softmax(logits).reshape(B, S, M, L, P)
    want = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                          jnp.asarray(attn), query_chunk=0))
    np.testing.assert_allclose(_port_encoder(value, off, logits), want, atol=3e-5)


def test_encoder_reference_points_match_spotter_grid():
    """The plain B2's reference points are the spotter's encoder reference points
    with valid_ratios = 1 (what the CUDA kernel derives from the token index)."""
    from gomatching_tpu_torch.models.spotter import DeepSoloSpotter

    refs = da.encoder_reference_points(SHAPES)
    np.testing.assert_array_equal(refs.numpy(), _grid_refs())
    spot = DeepSoloSpotter._encoder_reference_points(SHAPES, torch.ones(1, L, 2))
    np.testing.assert_array_equal(spot[0, :, 0].numpy(), _grid_refs())


def test_cpu_wrappers_run_plain_versions_without_counting_launches():
    value, off, logits = _encoder_inputs(seed=4, offset_cells=3.0)
    before = dict(da.launch_counts)
    v, o, lg = torch.from_numpy(value), torch.from_numpy(off), torch.from_numpy(logits)
    torch.testing.assert_close(da.ms_deform_attn_encoder(v, SHAPES, o, lg),
                               da.ms_deform_attn_encoder_plain(v, SHAPES, o, lg),
                               rtol=0, atol=0)
    assert da.launch_counts == before
