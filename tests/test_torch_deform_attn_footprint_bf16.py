"""The footprint entries B6a-c on bf16 value (``ms_deform_attn_encoder_vmem``, ``_vmem_tm``,
``_vmem_v3`` and ``ms_deform_attn_encoder_fused``), as the CPU runs them (their plain bf16
versions: the value widened to f32, the exact sampler, the output rounded to bf16 once),
against the JAX package's interpret-mode entries on the same bf16 value within the halo,
and against the exact f32 gather core beyond it. ``chip_smoke.py`` phase 20 holds the CUDA
kernel to these plain versions on the card (one bf16 ulp).

Tolerances, elementwise, from what each side rounds (tests/test_torch_deform_attn_bf16.py's
for B1/B2):
  - against JAX's entries, offsets within the halo: JAX rounds each one-hot weight G
    (bilinear weight x attention) to bf16 before its product (deform_attn_vmem.py:918-919),
    which the port keeps f32 (a difference by design, ROADMAP section C): at most 2**-8 of
    sum |G| |v|, the exact sampler run on |value| (the weights are positive); each side
    then rounds its output, 2**-8 of |out| each; plus 1e-5;
  - against the f32 core, offsets of up to 6 cells at halo 2 and locations outside the
    maps (where JAX's kernels drop mass and the port does not): one rounding, 2**-8 of the
    magnitude, plus 3e-5.
Also: bf16 value on the CPU counts no launch, and the kernel path refuses every dtype mix
but bf16 (or f32) value with f32 locations and attention."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_fused as daf
from gomatching_tpu_torch.ops import deform_attn_vmem as dav

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3)]
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 2, 8, 4, 2
TILES = (8, 8, 4, 2)
HALO = 2
HALF_ULP = 2.0**-8
ENTRIES = ("vmem", "vmem_tm", "vmem_v3", "fused")


def _compiled(fn, *args):
    """``fn`` as one XLA:CPU program compiled with the cheap options of
    tests/test_torch_deform_attn_edges.py."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False}
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(opts)(*args).astype(jnp.float32))


def _inputs(seed, offset_cells, far=0.0):
    """bf16-valued value (as f32), offsets in cells, normalized locations and attention
    (numpy); a share ``far`` of the offsets is 10x larger (locations outside the maps)."""
    rng = np.random.RandomState(seed)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).bfloat16().float().numpy()
    refs = []
    for h, w in SHAPES:
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        refs.append(np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    off = rng.uniform(-offset_cells, offset_cells, (B, S, M, L, P, 2)).astype(np.float32)
    off = np.where(rng.rand(*off.shape) < far, off * 10, off).astype(np.float32)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    loc = (ref + off / wh[None, None, None, :, None, :]).astype(np.float32)
    attn = rng.rand(B, S, M, L, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return value, off, loc, attn


def _layout(entry, off, loc, attn):
    """The entry's inputs from natural offsets/locations/attention (numpy)."""
    if entry in ("vmem", "fused"):
        return loc, attn
    perm, _ = dav.tile_major_perm(SHAPES, TILES)
    if entry == "vmem_tm":
        return (np.ascontiguousarray(loc[:, perm].transpose(0, 2, 3, 4, 5, 1)),
                np.ascontiguousarray(attn[:, perm].transpose(0, 2, 3, 4, 1)))
    offT = off[:, perm].transpose(0, 3, 5, 2, 4, 1).reshape(B, 2 * L * M * P, -1)
    attnT = attn[:, perm].transpose(0, 3, 2, 4, 1).reshape(B, L * M * P, -1)
    return np.ascontiguousarray(offT), np.ascontiguousarray(attnT)


def _port(entry, value, a, b, dtype=torch.bfloat16):
    """The port's entry on ``value`` in ``dtype``, as f32 numpy, natural token order."""
    fn = {"vmem": dav.ms_deform_attn_encoder_vmem, "vmem_tm": dav.ms_deform_attn_encoder_vmem_tm,
          "vmem_v3": dav.ms_deform_attn_encoder_vmem_v3,
          "fused": daf.ms_deform_attn_encoder_fused}[entry]
    out = fn(torch.from_numpy(value).to(dtype), SHAPES, torch.from_numpy(a), torch.from_numpy(b),
             halo=HALO, tile_sizes=TILES)
    assert out.dtype == dtype
    out = out.float().numpy()
    if entry == "vmem_v3":  # tile-major: its real tokens
        out = out[:, dav.tile_major_inverse(SHAPES, TILES)]
    return out


@pytest.mark.parametrize("entry", ENTRIES)
def test_bf16_plain_matches_jax_interpret_within_halo(entry):
    """The plain bf16 entry against JAX's interpret-mode entry on the same bf16 value,
    offsets within the halo: |diff| <= 2**-8 (sum |G||v| + |port| + |jax|) + 1e-5."""
    from gomatching_tpu.ops import deform_attn_fused as jf
    from gomatching_tpu.ops import deform_attn_vmem as jv

    value, off, loc, attn = _inputs(0, offset_cells=1.5)
    a, b = _layout(entry, off, loc, attn)
    jfn = {"vmem": jv.ms_deform_attn_encoder_vmem, "vmem_tm": jv.ms_deform_attn_encoder_vmem_tm,
           "vmem_v3": jv.ms_deform_attn_encoder_vmem_v3,
           "fused": jf.ms_deform_attn_encoder_fused}[entry]
    want = _compiled(lambda v, x, y: jfn(v.astype(jnp.bfloat16), SHAPES, x, y, halo=HALO,
                                         tile_sizes=TILES, interpret=True), value, a, b)
    if entry == "vmem_v3":
        want = want[:, jv.tile_major_inverse(SHAPES, TILES)]
    before = dict(da.launch_counts)
    got = _port(entry, value, a, b)
    assert da.launch_counts == before  # CPU tensors run the plain version
    abs_out = da.ms_deform_attn_queries_plain(torch.from_numpy(np.abs(value)), SHAPES,
                                              torch.from_numpy(loc), torch.from_numpy(attn)).numpy()
    tol = HALF_ULP * (abs_out + np.abs(got) + np.abs(want)) + 1e-5
    excess = np.abs(got - want) - tol
    assert excess.max() <= 0, f"max excess {excess.max()} (max |diff| {np.abs(got - want).max()})"


@pytest.mark.parametrize("entry", ENTRIES)
def test_bf16_plain_exact_beyond_halo(entry):
    """Offsets of up to 6 cells at halo 2, 5% of them 10x (outside the maps): the plain bf16
    entry within one rounding of the exact f32 core, and equal to its f32 entry rounded."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    value, off, loc, attn = _inputs(1, offset_cells=6.0, far=0.05)
    assert (loc < 0).any() and (loc > 1).any()
    a, b = _layout(entry, off, loc, attn)
    got = _port(entry, value, a, b)
    core = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                          jnp.asarray(attn)))
    excess = np.abs(got - core) - (HALF_ULP * np.abs(core) + 3e-5)
    assert excess.max() <= 0, f"max excess {excess.max()}"
    f32 = torch.from_numpy(_port(entry, value, a, b, torch.float32))
    np.testing.assert_array_equal(got, f32.bfloat16().float().numpy())


@pytest.mark.parametrize("bad", ["value", "locations", "attention"])
def test_kernel_path_refuses_other_dtype_mixes(bad):
    """The footprint kernel's launch takes bf16 (or f32) value with f32 locations and
    attention: any other mix raises ValueError naming the dtypes, before anything is built
    or counted."""
    _, _, loc, attn = _inputs(2, offset_cells=1.0)
    value = np.random.RandomState(2).randn(B, S, M, da.KERNEL_D).astype(np.float32)
    dtypes = {"value": torch.bfloat16, "locations": torch.float32, "attention": torch.float32}
    dtypes[bad] = torch.float16
    v = torch.from_numpy(value).to(dtypes["value"])
    lo = torch.from_numpy(loc).to(dtypes["locations"])
    at = torch.from_numpy(attn).to(dtypes["attention"])
    fp = dav.vmem_footprints(da.VMEM, SHAPES, P, HALO, 8, TILES, elem_bytes=2)
    before = dict(da.launch_counts)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dav._launch(da.VMEM, fp, v, lo, at, (B, S, M * da.KERNEL_D), P, S)
    assert da.launch_counts == before


def test_bf16_footprints_stage_twice_the_cells():
    """Footprints sized for 2-byte values: each staged footprint takes half the bytes
    (rounded up to 128), so under the shipped budget at the ICDAR15 inference shapes at
    least as many (source, target) pairs are staged as in f32, every buffer a multiple of
    128 bytes, and the launch refuses footprints sized for the other dtype."""
    prod = [(125, 223), (63, 112), (32, 56), (16, 28)]
    for fp_of in (lambda eb: dav.vmem_footprints(da.VMEM, prod, 4, 5, elem_bytes=eb),
                  lambda eb: daf.fused_footprints(prod, 4, 5, elem_bytes=eb)):
        f32, bf16 = fp_of(4), fp_of(2)
        assert (f32.elem_bytes, bf16.elem_bytes) == (4, 2)
        n32, n16 = (sum(st for row in fp.pairs for *_, st in row) for fp in (f32, bf16))
        assert n16 >= n32 and bf16.fp_bytes % 128 == 0 and bf16.smem_bytes <= dav.SMEM_MAX_BYTES
        for row32, row16 in zip(f32.pairs, bf16.pairs):
            for p32, p16 in zip(row32, row16):
                assert p32[2:4] == p16[2:4] and (not p32[4] or p16[4])  # same extents
    _, _, loc, attn = _inputs(3, offset_cells=1.0)
    value = torch.randn(B, S, M, da.KERNEL_D, generator=torch.Generator().manual_seed(3))
    fp = dav.vmem_footprints(da.VMEM, SHAPES, P, HALO, 8, TILES)  # f32-sized
    with pytest.raises(ValueError, match="footprints sized for 4-byte"):
        dav._launch(da.VMEM, fp, value.bfloat16(), torch.from_numpy(loc),
                    torch.from_numpy(attn), (B, S, M * da.KERNEL_D), P, S)
