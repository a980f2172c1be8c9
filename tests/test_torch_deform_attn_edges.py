"""The decoder sampler B1 and the encoder backward B4, as the CPU runs them (their plain
versions), against the JAX package at the small shapes where the lane-layout kernels
have tails: L*P = 12 (a batch of 8 samples half full), one level, and levels one cell
wide and one tall. ``chip_smoke.py`` phases 2 and 6 hold the kernels against the same
plain versions at these shapes on the card, so the chain kernel -> plain -> JAX stays
closed there. Also the pre-launch guard ``check_lane_layout`` of B1, B2 and B4.

Tolerances: B1 atol 3e-5 against the interpret-mode TPU kernel (as
tests/test_torch_deform_attn.py); B4 rtol 1e-4, atol 1e-5 against the TPU kernel's VJP and
the exact gather core's grads (as tests/test_torch_deform_attn_grads.py): f32 sums in
another order."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gomatching_tpu_torch.ops import deform_attn as da

RTOL, ATOL = 1e-4, 1e-5
ATOL_B1 = 3e-5
M, D = 2, 8
# (name, level shapes, P); B = 1 here, B * M > 1 with B > 1 is in the files named above
CASES = [
    ("L*P=12", [(6, 9), (3, 5), (2, 3), (1, 2)], 3),
    ("L=1", [(7, 5)], 4),
    ("1-wide and 1-tall levels", [(5, 1), (1, 6)], 4),
]
IDS = [c[0] for c in CASES]


def _compiled(fn, *args):
    """``fn`` as one XLA:CPU program compiled without LLVM's expensive passes (much
    faster to build here than eager dispatch of an interpret-mode kernel)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    args = [jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(opts)(*args)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("name,shapes,P", CASES, ids=IDS)
def test_queries_plain_matches_jax_kernel_at_edge_shapes(name, shapes, P):
    """B1's plain version against ms_deform_attn_queries_vmem in interpret mode, 13
    queries (not a multiple of the kernel's 8 warps a block), locations partly outside
    [0, 1]."""
    from gomatching_tpu.ops.deform_attn_dec_vmem import ms_deform_attn_queries_vmem

    rng = np.random.RandomState(10)
    L, S, Lq = len(shapes), sum(h * w for h, w in shapes), 13
    value = rng.randn(1, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (1, Lq, M, L, P, 2)).astype(np.float32)
    attn = _softmax(rng.randn(1, Lq, M, L * P).astype(np.float32)).reshape(1, Lq, M, L, P)
    want = _compiled(lambda v, lo, a: ms_deform_attn_queries_vmem(
        v, shapes, lo, a, query_block=16, interpret=True), value, loc, attn)
    got = da.ms_deform_attn_queries(*_t(value), shapes, *_t(loc, attn))
    assert got.shape == (1, Lq, M * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_B1)


def _encoder_inputs(shapes, P, offset_cells, seed, m=M):
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = rng.randn(1, S, m, D).astype(np.float32)
    off = rng.uniform(-offset_cells, offset_cells, (1, S, m, L, P, 2)).astype(np.float32)
    logits = rng.randn(1, S, m, L * P).astype(np.float32)
    cot = rng.randn(1, S, m * D).astype(np.float32)
    return value, off, logits, cot


def _check(got, want):
    for g, w, name in zip(got, want, ("value", "offsets", "logits")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("name,shapes,P", CASES, ids=IDS)
def test_encoder_backward_matches_jax_vmem_v2_vjp_inside_halo(name, shapes, P):
    """B4's plain version (autograd through ms_deform_attn_encoder_plain) against
    jax.grad through ms_deform_attn_encoder_vmem_v2's custom VJP, JAX's softmax chained
    in front, offsets within the kernel's halo (and partly beyond the small maps). One
    head: the interpret-mode kernel unrolls over levels, points and heads, and one head
    keeps its compile within seconds."""
    from gomatching_tpu.ops.deform_attn_vmem import (
        ms_deform_attn_encoder_vmem_v2,
        tile_major_inverse,
        tile_major_perm,
    )

    L, S, m = len(shapes), sum(h * w for h, w in shapes), 1
    tiles = tuple(8 for _ in shapes)
    value, off, logits, cot = _encoder_inputs(shapes, P, offset_cells=1.5, seed=11, m=m)
    perm = jnp.asarray(tile_major_perm(shapes, tiles)[0])
    inv = jnp.asarray(tile_major_inverse(shapes, tiles))

    def loss(v, oc, lg):
        a = jax.nn.softmax(lg, axis=-1).reshape(1, S, m, L, P)
        offT = jnp.take(oc, perm, axis=1).transpose(0, 3, 5, 2, 4, 1).reshape(1, L * 2 * m * P, -1)
        attnT = jnp.take(a, perm, axis=1).transpose(0, 3, 2, 4, 1).reshape(1, L * m * P, -1)
        out_tm = ms_deform_attn_encoder_vmem_v2(v, shapes, offT, attnT, halo=2,
                                                tile_sizes=tiles, interpret=True)
        return jnp.sum(jnp.take(out_tm, inv, axis=1) * cot)

    want = _compiled(jax.grad(loss, argnums=(0, 1, 2)), value, off, logits)
    _check(da.ms_deform_attn_encoder_plain_backward(*_t(value), shapes, *_t(off, logits, cot)),
           want)


@pytest.mark.parametrize("name,shapes,P", CASES, ids=IDS)
def test_encoder_backward_is_exact_beyond_halo_at_edge_shapes(name, shapes, P):
    """B4's plain version against the grads of JAX's exact gather core on reference
    points + offsets reaching far beyond the TPU kernel's halo and the maps."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    L, S = len(shapes), sum(h * w for h, w in shapes)
    value, off, logits, cot = _encoder_inputs(shapes, P, offset_cells=12.0, seed=12)
    ref = jnp.asarray(da.encoder_reference_points(shapes).numpy())
    wh = jnp.asarray(np.array([[w, h] for h, w in shapes], np.float32))

    def loss(v, oc, lg):
        loc = ref[None, :, None, None, None, :] + oc / wh[None, None, None, :, None, :]
        a = jax.nn.softmax(lg, axis=-1).reshape(1, S, M, L, P)
        return jnp.sum(ms_deform_attn_core(v, shapes, loc, a, query_chunk=0) * cot)

    want = _compiled(jax.grad(loss, argnums=(0, 1, 2)), value, off, logits)
    _check(da.ms_deform_attn_encoder_plain_backward(*_t(value), shapes, *_t(off, logits, cot)),
           want)


@pytest.mark.parametrize("dims,limit", [
    (dict(D=16), "D == 32"),
    (dict(L=4, P=17), "L\\*P <= 64"),
    (dict(P=0), "1 <= P"),
    (dict(B=8193, M=8), "B\\*M <= 65535"),
    (dict(S=2**28, M=8), "S\\*M\\*8"),
])
def test_lane_layout_guard_names_each_limit(dims, limit):
    """check_lane_layout raises ValueError naming the limit the kernels' C entries
    refuse, and passes the shipped shapes (ICDAR15 inference and pretraining)."""
    args = {**dict(B=1, S=37171, M=8, D=32, L=4, P=4), **dims}
    with pytest.raises(ValueError, match=limit):
        da.check_lane_layout("B1", **args)
    da.check_lane_layout("B1", B=3, S=37171, M=8, D=32, L=4, P=4)
    da.check_lane_layout("B4", B=1, S=34000, M=8, D=32, L=4, P=4)
