"""B1 and B2 on bf16 value (the production precision path), as the CPU runs them (their
plain bf16 versions: the value widened to f32, the plain sampler, the output rounded to
bf16), against the JAX package's interpret-mode kernels on the same bf16 value
(``ms_deform_attn_queries_vmem``; ``ms_deform_attn_encoder_vmem_v2`` with offsets
inside its halo) and against the exact f32 gather core. ``chip_smoke.py`` phase 17 holds
the CUDA kernels to one bf16 ulp of these plain versions on the card.

Tolerances, elementwise, from what each side rounds:
  - against the f32 core on the same (bf16-valued) inputs: the plain bf16 version rounds
    the f32 result once to nearest, at most half an ulp, 2**-8 of its magnitude, plus
    3e-5 for f32 sums in another order;
  - against JAX's bf16 kernels: JAX rounds each one-hot weight G (bilinear weight x
    attention, summed over the taps of a cell) to bf16 before its product, which the port
    keeps f32 (a difference by design, ROADMAP section C): at most 2**-8 of
    sum |G| |v|, which is the plain sampler run on |value| (the weights are positive);
    each side then rounds its output, 2**-8 of |out| each; plus 1e-5.
The same comparisons run at the edge shapes at which phase 17 holds the kernels (L*P = 12
and 64, one level, 1-wide and 1-tall levels, B = 2 with M = 3, 13 queries), with the same
tolerances; B2 also against the exact core with offsets far beyond the halo and the maps.
Also: the wrappers dispatch bf16 value to these plain versions on the CPU without counting
a launch, and the kernel entries refuse CPU tensors, every dtype but bf16 value with f32
locations, offsets and weights, and a value not aligned to the 16-byte words the kernels
read it in (``check_aligned``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gomatching_tpu_torch.ops import deform_attn as da

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3)]
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 2, 8, 4, 4
TILES = (8, 8, 4, 2)
HALF_ULP = 2.0**-8


def _compiled(fn, *args):
    """``fn`` as one XLA:CPU program compiled with the cheap options of
    tests/test_torch_deform_attn_edges.py."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False}
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(opts)(*args).astype(jnp.float32))


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return e / e.sum(axis, keepdims=True)


def _bf16_values(rng, shape):
    """randn values that bf16 holds exactly (the value both sides sample)."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16().float().numpy()


def _grid_refs():
    refs = []
    for h, w in SHAPES:
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        refs.append(np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1))
    return np.concatenate(refs, 0)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _check_against_jax(got, want, abs_out):
    """|got - want| <= 2**-8 (sum |G||v| + |got| + |want|) + 1e-5, elementwise."""
    tol = HALF_ULP * (abs_out + np.abs(got) + np.abs(want)) + 1e-5
    excess = np.abs(got - want) - tol
    assert excess.max() <= 0, f"max excess {excess.max()} (max |diff| {np.abs(got - want).max()})"


def _check_against_core(got, core):
    """One rounding of the f32 result: |got - core| <= 2**-8 |core| + 3e-5."""
    excess = np.abs(got - core) - (HALF_ULP * np.abs(core) + 3e-5)
    assert excess.max() <= 0, f"max excess {excess.max()}"


def _queries_inputs(seed=0, Lq=37):
    rng = np.random.RandomState(seed)
    value = _bf16_values(rng, (B, S, M, D))
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    attn = _softmax(rng.randn(B, Lq, M, L * P).astype(np.float32)).reshape(B, Lq, M, L, P)
    return value, loc, attn


def test_queries_bf16_plain_matches_jax_kernel_and_core():
    """B1 on bf16 value against interpret-mode ms_deform_attn_queries_vmem on the same
    bf16 value (G in bf16, a bf16 output) and against the f32 gather core; 37 queries,
    locations partly outside [0, 1]."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_dec_vmem import ms_deform_attn_queries_vmem

    value, loc, attn = _queries_inputs()
    got_t = da.ms_deform_attn_queries(_t(value, torch.bfloat16), SHAPES, _t(loc), _t(attn))
    assert got_t.dtype == torch.bfloat16 and got_t.shape == (B, 37, M * D)
    got = got_t.float().numpy()
    want = _compiled(lambda v, lo, a: ms_deform_attn_queries_vmem(
        v.astype(jnp.bfloat16), SHAPES, lo, a, query_block=16, interpret=True),
        value, loc, attn)
    abs_out = da.ms_deform_attn_queries_plain(_t(np.abs(value)), SHAPES, _t(loc),
                                              _t(attn)).numpy()
    _check_against_jax(got, want, abs_out)
    core = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                          jnp.asarray(attn), query_chunk=0))
    _check_against_core(got, core)


def _encoder_inputs(seed, offset_cells):
    rng = np.random.RandomState(seed)
    value = _bf16_values(rng, (B, S, M, D))
    off = rng.uniform(-offset_cells, offset_cells, (B, S, M, L, P, 2)).astype(np.float32)
    logits = rng.randn(B, S, M, L * P).astype(np.float32)
    return value, off, logits


def test_encoder_bf16_plain_matches_jax_vmem_v2_inside_halo():
    """B2 on bf16 value against interpret-mode ms_deform_attn_encoder_vmem_v2 on the same
    bf16 value, offsets within its halo, and against the f32 gather core on reference
    points + offsets."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_vmem import (
        ms_deform_attn_encoder_vmem_v2,
        tile_major_inverse,
        tile_major_perm,
    )

    value, off, logits = _encoder_inputs(seed=2, offset_cells=1.5)
    got_t = da.ms_deform_attn_encoder(_t(value, torch.bfloat16), SHAPES, _t(off), _t(logits))
    assert got_t.dtype == torch.bfloat16 and got_t.shape == (B, S, M * D)
    got = got_t.float().numpy()
    attn = _softmax(logits).reshape(B, S, M, L, P)
    perm, _ = tile_major_perm(SHAPES, TILES)
    inv = jnp.asarray(tile_major_inverse(SHAPES, TILES))
    offT = np.transpose(off[:, perm], (0, 3, 5, 2, 4, 1)).reshape(B, L * 2 * M * P, -1)
    attnT = np.transpose(attn[:, perm], (0, 3, 2, 4, 1)).reshape(B, L * M * P, -1)
    want = _compiled(lambda v, o, a: jnp.take(ms_deform_attn_encoder_vmem_v2(
        v.astype(jnp.bfloat16), SHAPES, o, a, halo=2, tile_sizes=TILES, interpret=True),
        inv, axis=1), value, offT, attnT)
    abs_out = da.ms_deform_attn_encoder_plain(_t(np.abs(value)), SHAPES, _t(off),
                                              _t(logits)).numpy()
    _check_against_jax(got, want, abs_out)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    loc = _grid_refs()[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
    core = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                          jnp.asarray(attn), query_chunk=0))
    _check_against_core(got, core)


def test_cpu_wrappers_dispatch_bf16_to_plain_versions_without_counting_launches():
    value, loc, attn = _queries_inputs(seed=3)
    ev, off, logits = _encoder_inputs(seed=4, offset_cells=20.0)
    before = dict(da.launch_counts)
    vb = _t(value, torch.bfloat16)
    got = da.ms_deform_attn_queries(vb, SHAPES, _t(loc), _t(attn))
    want = da.ms_deform_attn_queries_plain(vb.float(), SHAPES, _t(loc), _t(attn))
    assert torch.equal(got, want.bfloat16())
    evb = _t(ev, torch.bfloat16)
    got = da.ms_deform_attn_encoder(evb, SHAPES, _t(off), _t(logits))
    assert torch.equal(got, da.ms_deform_attn_encoder_plain_bf16(evb, SHAPES, _t(off),
                                                                 _t(logits)))
    assert da.launch_counts == before


@pytest.mark.parametrize("which", ["queries", "encoder"])
@pytest.mark.parametrize("bad", [None, "value", "geometry", "weights"])
def test_bf16_kernels_refuse_cpu_tensors_and_other_dtypes(which, bad):
    """The bf16 kernel entries take bf16 value and f32 locations (offsets) and weights
    (logits): another dtype of any input raises TypeError, before anything is built; with
    the right dtypes, CPU tensors raise ValueError."""
    rng = np.random.RandomState(5)
    Lq = 9 if which == "queries" else S
    value = _bf16_values(rng, (1, S, M, da.KERNEL_D))
    loc = rng.uniform(-0.1, 1.1, (1, Lq, M, L, P, 2)).astype(np.float32)
    attn = rng.rand(1, Lq, M, L, P).astype(np.float32)
    if which == "encoder":
        attn = attn.reshape(1, S, M, L * P)
    dtypes = {"value": torch.bfloat16, "geometry": torch.float32, "weights": torch.float32}
    if bad is not None:
        dtypes[bad] = torch.float32 if bad == "value" else torch.bfloat16
    args = (_t(value, dtypes["value"]), SHAPES, _t(loc, dtypes["geometry"]),
            _t(attn, dtypes["weights"]))
    fn = da.ms_deform_attn_queries_bf16 if which == "queries" else da.ms_deform_attn_encoder_bf16
    before = dict(da.launch_counts)
    with pytest.raises(TypeError if bad else ValueError,
                       match="must be" if bad else "CUDA tensors"):
        fn(*args)
    assert da.launch_counts == before


# The edge shapes chip_smoke.py phase 17 holds the CUDA kernels to one bf16 ulp of these
# plain versions at (its EDGE_CASES; D = 8 here, the plain versions take any width):
# (name, B, M, level shapes, P). L*P = 64 with one head: the interpret-mode kernels unroll
# over points and heads. The tolerances are _check_against_jax's and _check_against_core's.
EDGE_LEVELS = [(6, 9), (3, 5), (2, 3), (1, 2)]
EDGE_CASES = [
    ("L*P=12", 1, 2, EDGE_LEVELS, 3),
    ("L*P=64", 1, 1, EDGE_LEVELS, 16),
    ("L=1", 1, 2, [(7, 5)], 4),
    ("1-wide and 1-tall levels", 1, 2, [(5, 1), (1, 6), (3, 3)], 4),
    ("B=2 M=3", 2, 3, EDGE_LEVELS, 4),
]
EDGE_IDS = [c[0] for c in EDGE_CASES]
EDGE_LQ = 13  # not a multiple of the kernels' 8 warps a block


@pytest.mark.parametrize("name,b,m,shapes,p", EDGE_CASES, ids=EDGE_IDS)
def test_queries_bf16_plain_matches_jax_kernel_at_edge_shapes(name, b, m, shapes, p):
    """B1's plain bf16 version against interpret-mode ms_deform_attn_queries_vmem on the same
    bf16 value (G rounded to bf16 there), EDGE_LQ queries, locations partly outside [0, 1]."""
    from gomatching_tpu.ops.deform_attn_dec_vmem import ms_deform_attn_queries_vmem

    rng = np.random.RandomState(20)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = _bf16_values(rng, (b, S, m, D))
    loc = rng.uniform(-0.15, 1.15, (b, EDGE_LQ, m, L, p, 2)).astype(np.float32)
    attn = _softmax(rng.randn(b, EDGE_LQ, m, L * p).astype(np.float32)).reshape(
        b, EDGE_LQ, m, L, p)
    got_t = da.ms_deform_attn_queries(_t(value, torch.bfloat16), shapes, _t(loc), _t(attn))
    assert got_t.dtype == torch.bfloat16 and got_t.shape == (b, EDGE_LQ, m * D)
    want = _compiled(lambda v, lo, a: ms_deform_attn_queries_vmem(
        v.astype(jnp.bfloat16), shapes, lo, a, query_block=16, interpret=True),
        value, loc, attn)
    abs_out = da.ms_deform_attn_queries_plain(_t(np.abs(value)), shapes, _t(loc),
                                              _t(attn)).numpy()
    _check_against_jax(got_t.float().numpy(), want, abs_out)


def _edge_encoder_inputs(b, m, shapes, p, offset_cells, seed):
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = _bf16_values(rng, (b, S, m, D))
    off = rng.uniform(-offset_cells, offset_cells, (b, S, m, L, p, 2)).astype(np.float32)
    logits = rng.randn(b, S, m, L * p).astype(np.float32)
    return value, off, logits


@pytest.mark.parametrize("name,b,m,shapes,p", EDGE_CASES, ids=EDGE_IDS)
def test_encoder_bf16_plain_matches_jax_vmem_v2_at_edge_shapes(name, b, m, shapes, p):
    """B2's plain bf16 version against interpret-mode ms_deform_attn_encoder_vmem_v2 on the
    same bf16 value, offsets within its halo (2 cells; partly beyond the small maps)."""
    from gomatching_tpu.ops.deform_attn_vmem import (
        ms_deform_attn_encoder_vmem_v2,
        tile_major_inverse,
        tile_major_perm,
    )

    L, S = len(shapes), sum(h * w for h, w in shapes)
    value, off, logits = _edge_encoder_inputs(b, m, shapes, p, 1.5, seed=21)
    got_t = da.ms_deform_attn_encoder(_t(value, torch.bfloat16), shapes, _t(off), _t(logits))
    assert got_t.dtype == torch.bfloat16 and got_t.shape == (b, S, m * D)
    tiles = tuple(8 for _ in shapes)
    perm = jnp.asarray(tile_major_perm(shapes, tiles)[0])
    inv = jnp.asarray(tile_major_inverse(shapes, tiles))

    def jax_b2(v, oc, lg):
        a = jax.nn.softmax(lg, axis=-1).reshape(b, S, m, L, p)
        offT = jnp.take(oc, perm, axis=1).transpose(0, 3, 5, 2, 4, 1).reshape(b, L * 2 * m * p, -1)
        attnT = jnp.take(a, perm, axis=1).transpose(0, 3, 2, 4, 1).reshape(b, L * m * p, -1)
        out_tm = ms_deform_attn_encoder_vmem_v2(v.astype(jnp.bfloat16), shapes, offT, attnT,
                                                halo=2, tile_sizes=tiles, interpret=True)
        return jnp.take(out_tm, inv, axis=1)

    want = _compiled(jax_b2, value, off, logits)
    abs_out = da.ms_deform_attn_encoder_plain(_t(np.abs(value)), shapes, _t(off),
                                              _t(logits)).numpy()
    _check_against_jax(got_t.float().numpy(), want, abs_out)


@pytest.mark.parametrize("name,b,m,shapes,p", EDGE_CASES, ids=EDGE_IDS)
def test_encoder_bf16_plain_is_exact_beyond_halo_at_edge_shapes(name, b, m, shapes, p):
    """B2's plain bf16 version against JAX's exact f32 gather core on reference points +
    offsets reaching far beyond the TPU kernel's halo and the maps: one rounding."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    L = len(shapes)
    value, off, logits = _edge_encoder_inputs(b, m, shapes, p, 12.0, seed=22)
    got = da.ms_deform_attn_encoder(_t(value, torch.bfloat16), shapes, _t(off),
                                    _t(logits)).float().numpy()
    ref = da.encoder_reference_points(shapes).numpy()
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
    attn = _softmax(logits).reshape(b, -1, m, L, p)
    core = _compiled(lambda v, lo, a: ms_deform_attn_core(v, shapes, lo, a, query_chunk=0),
                     value, loc, attn)
    _check_against_core(got, core)


@pytest.mark.parametrize("width", [4, 8, 16])
def test_check_aligned_names_the_input_and_the_width(width):
    """The pre-launch guard raises ValueError for an address that is not a multiple of the
    width the kernel reads the input in, naming both, and passes aligned addresses."""
    da.check_aligned("value", 0x7f0000001000, width)
    da.check_aligned("value", 0x7f0000001000 + 3 * width, width)
    for bad in range(1, width):
        with pytest.raises(ValueError, match=f"value at address .* {width}-byte"):
            da.check_aligned("value", 0x7f0000001000 + bad, width)


@pytest.mark.parametrize("which", ["queries", "encoder"])
def test_bf16_kernels_refuse_misaligned_value_before_launching(which):
    """A contiguous bf16 value view that starts 2 bytes into its storage (an odd element)
    would fault in the kernels' 16-byte loads: the wrapper refuses it with ValueError
    naming the input, before any build or launch (here on CPU tensors, whose refusal as
    such comes after this check)."""
    rng = np.random.RandomState(6)
    Lq = 9 if which == "queries" else S
    store = _t(_bf16_values(rng, (S * M * da.KERNEL_D + 1,)), torch.bfloat16)
    value = store[1:].view(1, S, M, da.KERNEL_D)
    assert value.is_contiguous() and value.data_ptr() % 16 == 2
    loc = _t(rng.uniform(-0.1, 1.1, (1, Lq, M, L, P, 2)).astype(np.float32))
    attn = _t(rng.rand(1, Lq, M, L, P).astype(np.float32))
    if which == "encoder":
        attn = attn.reshape(1, S, M, L * P)
    fn = da.ms_deform_attn_queries_bf16 if which == "queries" else da.ms_deform_attn_encoder_bf16
    before = dict(da.launch_counts)
    with pytest.raises(ValueError, match="value at address .* 16-byte"):
        fn(value, SHAPES, loc, attn)
    assert da.launch_counts == before
    aligned = value.clone()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(aligned, SHAPES, loc, attn)
