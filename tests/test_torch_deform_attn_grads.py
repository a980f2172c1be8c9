"""The backward kernels' plain versions (B3: B1's VJP, B4: B2's VJP, as the CPU runs
them: autograd through ``grid_sample``) against the JAX package's custom VJPs, with the
JAX side in interpret mode as tests/test_deform_attn_grads.py runs it, and against the
exact gather core's grads beyond the TPU encoder kernel's halo. Tolerance: rtol 1e-4,
atol 1e-5 (f32, sums in another order)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gomatching_tpu_torch.ops import deform_attn as da

RTOL, ATOL = 1e-4, 1e-5


def _grads(loss, *args):
    """jax.grad of ``loss`` in all its arguments, as one XLA:CPU program compiled
    without LLVM's expensive passes (much faster to build here than eager dispatch)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    args = [jnp.asarray(a) for a in args]
    fn = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))
    return fn.lower(*args).compile(opts)(*args)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("loc_range", [(0.05, 0.95), (-0.15, 1.15)])
def test_queries_backward_matches_jax_vmem_vjp(loc_range):
    """B3: (dValue, dLoc, dAttn) against jax.grad through ms_deform_attn_queries_vmem,
    with locations inside and outside [0, 1]."""
    from gomatching_tpu.ops.deform_attn_dec_vmem import ms_deform_attn_queries_vmem

    rng = np.random.RandomState(0)
    shapes = [(6, 8), (3, 4)]
    S = sum(h * w for h, w in shapes)
    B, M, D, L, Lq, P = 2, 2, 8, 2, 10, 3
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(*loc_range, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = _softmax(rng.randn(B, Lq, M, L * P).astype(np.float32)).reshape(B, Lq, M, L, P)
    cot = rng.randn(B, Lq, M * D).astype(np.float32)

    def loss(v, lo, a):
        out = ms_deform_attn_queries_vmem(v, shapes, lo, a, query_block=8, interpret=True)
        return jnp.sum(out * cot)

    want = _grads(loss, value, loc, attn)
    got = da.ms_deform_attn_queries_plain_backward(*_t(value), shapes, *_t(loc, attn, cot))
    _check(got, want, ("value", "loc", "attn"))


SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3)]
TILES = (8, 8, 4, 2)
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 4, 8, 4, 4


def _encoder_inputs(seed, offset_cells, b=B, s=S, m=M, n_levels=L):
    rng = np.random.RandomState(seed)
    value = rng.randn(b, s, m, D).astype(np.float32)
    off = rng.uniform(-offset_cells, offset_cells, (b, s, m, n_levels, P, 2)).astype(np.float32)
    logits = rng.randn(b, s, m, n_levels * P).astype(np.float32)
    cot = rng.randn(b, s, m * D).astype(np.float32)
    return value, off, logits, cot


def test_encoder_backward_matches_jax_vmem_v2_vjp_inside_halo():
    """B4: (dValue, dOffsets, dLogits) against jax.grad through
    ms_deform_attn_encoder_vmem_v2 (its custom VJP) with JAX's softmax chained in
    front, offsets within the kernel's halo (pattern: tests/test_deform_attn_grads.py:94)."""
    from gomatching_tpu.ops.deform_attn_vmem import (
        ms_deform_attn_encoder_vmem_v2,
        tile_major_inverse,
        tile_major_perm,
    )

    # two levels of one tile each keep the interpret-mode kernel small enough to compile
    # in seconds (its body unrolls over levels, points and heads)
    shapes, tiles = [(8, 8), (4, 4)], (8, 4)
    b, m, s, n = 1, 2, sum(h * w for h, w in shapes), len(shapes)
    value, off, logits, cot = _encoder_inputs(seed=3, offset_cells=1.5, b=b, s=s, m=m,
                                              n_levels=n)
    perm = jnp.asarray(tile_major_perm(shapes, tiles)[0])
    inv = jnp.asarray(tile_major_inverse(shapes, tiles))

    def loss(v, oc, lg):
        a = jax.nn.softmax(lg, axis=-1).reshape(b, s, m, n, P)
        offT = jnp.take(oc, perm, axis=1).transpose(0, 3, 5, 2, 4, 1).reshape(b, n * 2 * m * P, -1)
        attnT = jnp.take(a, perm, axis=1).transpose(0, 3, 2, 4, 1).reshape(b, n * m * P, -1)
        out_tm = ms_deform_attn_encoder_vmem_v2(v, shapes, offT, attnT, halo=2,
                                                tile_sizes=tiles, interpret=True)
        return jnp.sum(jnp.take(out_tm, inv, axis=1) * cot)

    want = _grads(loss, value, off, logits)
    got = da.ms_deform_attn_encoder_plain_backward(*_t(value), shapes, *_t(off, logits, cot))
    _check(got, want, ("value", "offsets", "logits"))


@pytest.mark.parametrize("offset_cells", [1.5, 20.0])
def test_encoder_backward_is_exact_beyond_halo(offset_cells):
    """B4 against the grads of JAX's exact gather core on reference points + offsets,
    also where the offsets reach far beyond the TPU kernel's halo."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    value, off, logits, cot = _encoder_inputs(seed=4, offset_cells=offset_cells)
    ref = jnp.asarray(da.encoder_reference_points(SHAPES).numpy())
    wh = jnp.asarray(np.array([[w, h] for h, w in SHAPES], np.float32))

    def loss(v, oc, lg):
        loc = ref[None, :, None, None, None, :] + oc / wh[None, None, None, :, None, :]
        a = jax.nn.softmax(lg, axis=-1).reshape(B, S, M, L, P)
        return jnp.sum(ms_deform_attn_core(v, SHAPES, loc, a, query_chunk=0) * cot)

    want = _grads(loss, value, off, logits)
    got = da.ms_deform_attn_encoder_plain_backward(*_t(value), SHAPES, *_t(off, logits, cot))
    _check(got, want, ("value", "offsets", "logits"))


def test_cpu_autograd_runs_plain_versions_without_counting_launches():
    """On CPU tensors the wrappers differentiate the plain forwards, which gives the
    plain backwards; the backward kernels' entry points refuse CPU tensors; no kernel
    launch is counted."""
    value, off, logits, cot = _encoder_inputs(seed=5, offset_cells=3.0)
    before = dict(da.launch_counts)
    v, o, lg, c = (t.requires_grad_(i < 3) for i, t in enumerate(_t(value, off, logits, cot)))
    out = da.ms_deform_attn_encoder(v, SHAPES, o, lg)
    got = torch.autograd.grad(out, (v, o, lg), c)
    args = (v.detach(), SHAPES, o.detach(), lg.detach(), c)
    want = da.ms_deform_attn_encoder_plain_backward(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        da.ms_deform_attn_encoder_backward(*args)
    assert da.launch_counts == before
