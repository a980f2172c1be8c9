"""The port's footprint entries B6a/B6b (``ops/deform_attn_vmem.py``; their plain
versions, as the CPU runs them) against the JAX package.

(a) the geometry copies (``tile_major_perm``/``_inverse``, the column perms,
``_footprint_bounds``, ``_tile_queries``/``_untile_queries``) equal JAX's exactly, at the
test shapes and at the ICDAR15 inference shapes with default and explicit tiles, and so do
the kernel's block tables built from them (``footprints``, under three shared-memory budgets);
(b) ``ms_deform_attn_encoder_vmem``, ``_vmem_tm`` and ``_vmem_v3`` against the JAX entries
in interpret mode, offsets within the halo, atol 3e-5 (test_deform_attn_vmem.py's);
(c) the same entries with offsets of up to 6 cells at halo 2 and locations outside the
maps against JAX's exact gather core, atol 1e-5, while the footprints miss some of the
corners (the mass JAX's kernels drop); (d) the v3 route fed from a port
``MSDeformAttn``'s own projections through the column perms equals the B2 route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_vmem as dav

SHAPES = [(16, 24), (8, 12), (4, 6), (2, 3)]
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 2, 8, 4, 2
TILES = (8, 8, 4, 2)
HALO = 2
PROD = [(125, 223), (63, 112), (32, 56), (16, 28)]  # 1000x1778 at strides 8..64
ENTRIES = ("vmem", "vmem_tm", "vmem_v3")


def _jit(f, *args):
    """``f`` on numpy ``args`` as one XLA:CPU program built without LLVM's expensive
    passes (the interpret-mode kernels compile much faster so)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(f).lower(*args).compile(opts)(*args))


def _inputs(seed, offset_cells, far=0.0):
    """value, offsets in cells, normalized locations and attention (numpy); a share
    ``far`` of the offsets is 10x larger (locations outside the maps)."""
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D).astype(np.float32)
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
    if entry == "vmem":
        return loc, attn
    perm, _ = dav.tile_major_perm(SHAPES, TILES)
    if entry == "vmem_tm":
        return (np.ascontiguousarray(loc[:, perm].transpose(0, 2, 3, 4, 5, 1)),
                np.ascontiguousarray(attn[:, perm].transpose(0, 2, 3, 4, 1)))
    offT = off[:, perm].transpose(0, 3, 5, 2, 4, 1).reshape(B, 2 * L * M * P, -1)
    attnT = attn[:, perm].transpose(0, 3, 2, 4, 1).reshape(B, L * M * P, -1)
    return np.ascontiguousarray(offT), np.ascontiguousarray(attnT)


def _port(entry, value, a, b, halo=HALO):
    fn = {"vmem": dav.ms_deform_attn_encoder_vmem, "vmem_tm": dav.ms_deform_attn_encoder_vmem_tm,
          "vmem_v3": dav.ms_deform_attn_encoder_vmem_v3}[entry]
    out = fn(torch.from_numpy(value), SHAPES, torch.from_numpy(a), torch.from_numpy(b),
             halo=halo, tile_sizes=TILES).numpy()
    if entry == "vmem_v3":  # tile-major: its real tokens, as test_deform_attn_vmem.py:113
        out = out[:, dav.tile_major_inverse(SHAPES, TILES)]
    return out


@pytest.mark.parametrize("shapes,tiles", [
    (SHAPES, TILES), (PROD, None), (PROD, ((16, 32), (16, 32), (16, 32), (16, 16))),
    ([(12, 12), (6, 5), (1, 7)], (8, 8, 8)),
])
def test_geometry_matches_jax(shapes, tiles):
    from gomatching_tpu.ops import deform_attn_tiled as jt
    from gomatching_tpu.ops import deform_attn_vmem as jv

    perm, info = dav.tile_major_perm(shapes, tiles)
    want_perm, want_info = jv.tile_major_perm(shapes, tiles)
    np.testing.assert_array_equal(perm, want_perm)
    assert info == want_info
    np.testing.assert_array_equal(dav.tile_major_inverse(shapes, tiles),
                                  jv.tile_major_inverse(shapes, tiles))
    for m, l, p in ((8, 4, 4), (2, 3, 5)):
        np.testing.assert_array_equal(dav.offset_column_perm(m, l, p),
                                      jv.offset_column_perm(m, l, p))
        np.testing.assert_array_equal(dav.attn_column_perm(m, l, p), jv.attn_column_perm(m, l, p))
    assert dav._norm_tiles(tiles, len(shapes)) == jv._norm_tiles(tiles, len(shapes))
    assert (dav._DEFAULT_TILES, dav._VMEM_TILES) == (jt._DEFAULT_TILES, jv._VMEM_TILES)
    assert dav._level_starts(shapes) == jt._level_starts(shapes)
    for (h1, w1), (ty, tx) in zip(shapes, dav._norm_tiles(tiles, len(shapes))):
        for h2, w2 in shapes:
            for halo, block in ((5, 8), (2, 4), (8, 1)):
                args_y = (h1, ty, -(-h1 // ty), h2, -(-h2 // block) * block, halo, 1)
                args_x = (w1, tx, -(-w1 // tx), w2, -(-w2 // block) * block, halo, block)
                for a in (args_y, args_x):
                    assert dav._footprint_bounds(*a) == jt._footprint_bounds(*a), a
    # the query tiling, with ragged edge tiles
    h, w = shapes[0]
    ty, tx = dav._norm_tiles(tiles, len(shapes))[0]
    x = np.random.RandomState(0).randn(2, h * w, 3).astype(np.float32)
    got, nty, ntx = dav._tile_queries(torch.from_numpy(x), h, w, ty, tx)
    want, *n = jt._tile_queries(jnp.asarray(x), h, w, ty, tx)
    assert [nty, ntx] == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dav._untile_queries(got, nty, ntx, h, w, ty, tx).numpy(), x)


@pytest.mark.parametrize("shapes,tiles", [
    (SHAPES, TILES), (PROD, None), (PROD, ((16, 32), (16, 32), (16, 32), (16, 16))),
    ([(12, 12), (6, 5), (1, 7)], (8, 8, 8)),
])
def test_footprint_records_match_jax_bounds(shapes, tiles):
    """The kernel's block table (``footprints``): per block, the source level, tile
    origin, width, query chunk (at most QCHUNK queries) and first slot, and per target
    level the footprint origin and extent from JAX's ``_footprint_bounds``, or zeros where
    the footprint does not fit a buffer under each shared-memory budget (or a TMA box):
    the shipped one, 64 KB and 0 (every pair direct); the tensor-map boxes and the buffer
    and block sizes."""
    from gomatching_tpu.ops import deform_attn_tiled as jt
    from gomatching_tpu.ops import deform_attn_vmem as jv

    L, P_, halo = len(shapes), 4, 5
    starts = dav._level_starts(shapes)[0]
    S_tm = sum(T * Q for _, T, Q, *_ in jv.tile_major_perm(shapes, tiles)[1])
    shipped = dav.SMEM_BLOCK_BYTES
    try:
        for cap in (shipped, 64 * 1024, 0):
            dav.SMEM_BLOCK_BYTES = cap
            dav.footprints.cache_clear()
            budget = (cap - dav.smem_bytes(0, L, P_)) // dav.NBUF
            for name in (da.VMEM, da.VMEM_TM):
                fp = dav.vmem_footprints(name, shapes, P_, halo, 8, tiles,
                                         None if name == da.VMEM else S_tm)
                if name == da.VMEM:
                    want_tiles = [(0, -(-h // min(ty, h)) * -(-w // min(tx, w)),
                                   min(ty, h) * min(tx, w), min(ty, h), min(tx, w),
                                   -(-h // min(ty, h)), -(-w // min(tx, w)))
                                  for (h, w), (ty, tx) in zip(shapes, jv._norm_tiles(tiles, L))]
                else:
                    want_tiles = [tuple(i) for i in jv.tile_major_perm(shapes, tiles)[1]]
                assert [tuple(t) for t in fp.tiles] == want_tiles
                np.testing.assert_array_equal(
                    fp.table[:4 * L].reshape(L, 4),
                    [[h, w, s0, 0] for (h, w), s0 in zip(shapes, starts)])
                recs, boxes, fp_bytes = [], np.zeros((L, L, 2), np.int32), 0
                for l1, (H1, W1) in enumerate(shapes):
                    pos, T, Q, ty, tx, nty, ntx = want_tiles[l1]
                    per_l2 = []
                    for l2, (H2, W2) in enumerate(shapes):
                        oys, Fh = jt._footprint_bounds(H1, ty, nty, H2, -(-H2 // 8) * 8, halo, 1)
                        oxs, Fw = jt._footprint_bounds(W1, tx, ntx, W2, -(-W2 // 8) * 8, halo, 8)
                        staged = Fh * Fw * 128 <= budget and max(Fh, Fw) <= 256
                        if staged:
                            boxes[l1, l2] = (Fh, Fw)
                            fp_bytes = max(fp_bytes, Fh * Fw * 128)
                        per_l2.append((oys, oxs, Fh, Fw, staged))
                    for q0 in range(0, Q, dav.QCHUNK):
                        for t in range(T):
                            rec = [l1, (t // ntx) * ty, (t % ntx) * tx, tx, q0,
                                   min(dav.QCHUNK, Q - q0), pos + t * Q, 0]
                            for oys, oxs, Fh, Fw, staged in per_l2:
                                rec += [oys[t // ntx], oxs[t % ntx], Fh, Fw] if staged else [0] * 4
                            recs.append(rec)
                assert fp.n_items == len(recs)
                np.testing.assert_array_equal(fp.table[4 * L:].reshape(len(recs), -1), recs)
                np.testing.assert_array_equal(fp.boxes, boxes)
                assert fp.fp_bytes == fp_bytes
                assert fp.smem_bytes == dav.smem_bytes(fp_bytes, L, P_)
                assert fp_bytes == 0 or fp.smem_bytes <= cap
    finally:
        dav.SMEM_BLOCK_BYTES = shipped
        dav.footprints.cache_clear()


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_matches_jax_interpret_within_halo(entry):
    from gomatching_tpu.ops import deform_attn_vmem as jv

    value, off, loc, attn = _inputs(0, offset_cells=1.5)
    a, b = _layout(entry, off, loc, attn)
    jfn = {"vmem": jv.ms_deform_attn_encoder_vmem, "vmem_tm": jv.ms_deform_attn_encoder_vmem_tm,
           "vmem_v3": jv.ms_deform_attn_encoder_vmem_v3}[entry]
    want = _jit(lambda v, x, y: jfn(v, SHAPES, x, y, halo=HALO, tile_sizes=TILES, interpret=True),
                value, a, b)
    if entry == "vmem_v3":
        want = want[:, jv.tile_major_inverse(SHAPES, TILES)]
    before = dict(da.launch_counts)
    np.testing.assert_allclose(_port(entry, value, a, b), want, atol=3e-5)
    assert da.launch_counts == before  # CPU tensors run the plain version


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_exact_beyond_halo(entry):
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core

    value, off, loc, attn = _inputs(1, offset_cells=6.0, far=0.05)
    assert (loc < 0).any() and (loc > 1).any()
    a, b = _layout(entry, off, loc, attn)
    want = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                          jnp.asarray(attn)))
    np.testing.assert_allclose(_port(entry, value, a, b), want, atol=1e-5)
    # every footprint is staged at these shapes, yet some in-map corners lie beyond
    # them: the mass the TPU kernels drop, which the port reads from device memory
    name = {"vmem": da.VMEM, "vmem_tm": da.VMEM_TM, "vmem_v3": da.VMEM_V3}[entry]
    S_tm = None if entry == "vmem" else a.shape[-1]
    fp = dav.vmem_footprints(name, SHAPES, P, HALO, 8, TILES, S_tm)
    assert all(pair[4] for pairs in fp.pairs for pair in pairs)
    if entry == "vmem":
        q_loc = torch.from_numpy(loc)
    elif entry == "vmem_tm":
        q_loc = torch.from_numpy(loc[:, dav.tile_major_perm(SHAPES, TILES)[0]])
    else:
        q_loc = dav.v3_locations(SHAPES, torch.from_numpy(a), torch.from_numpy(b), M, TILES)[0]
    share = dav.staged_share(fp, SHAPES, q_loc)
    smem, taps = (sum(v[k] for v in share.values()) for k in (0, 1))
    assert 0 < smem < taps


def test_v3_route_from_msdeformattn_projections_matches_b2():
    """The tile-major route as a model would feed it: the port MSDeformAttn's own
    offset and attention projections, their columns permuted by offset_column_perm /
    attn_column_perm and the tokens by tile_major_perm, through the v3 entry equal the
    B2 entry on the natural projections."""
    from gomatching_tpu_torch.models.spotter import MSDeformAttn

    torch.manual_seed(0)
    C = M * D
    attn_mod = MSDeformAttn(C, L, M, P)
    with torch.no_grad():
        attn_mod.sampling_offsets.weight.normal_(0, 0.3)
        attn_mod.sampling_offsets.bias.normal_(0, 1.0)
        attn_mod.attention_weights.weight.normal_(0, 0.3)
    rng = np.random.RandomState(2)
    query = torch.from_numpy(rng.randn(B, S, C).astype(np.float32))
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32))
    perm = torch.from_numpy(dav.tile_major_perm(SHAPES, TILES)[0].astype(np.int64))
    inv = torch.from_numpy(dav.tile_major_inverse(SHAPES, TILES).astype(np.int64))
    ocp = torch.from_numpy(dav.offset_column_perm(M, L, P).astype(np.int64))
    acp = torch.from_numpy(dav.attn_column_perm(M, L, P).astype(np.int64))
    with torch.no_grad():
        off = attn_mod.sampling_offsets(query)
        logits = attn_mod.attention_weights(query)
        want = da.ms_deform_attn_encoder(value, SHAPES, off.view(B, S, M, L, P, 2),
                                         logits.view(B, S, M, L * P))
        q_tm = query[:, perm]
        offT = torch.nn.functional.linear(q_tm, attn_mod.sampling_offsets.weight[ocp],
                                          attn_mod.sampling_offsets.bias[ocp]).transpose(1, 2)
        a_tm = attn_mod.attention_weights(q_tm).view(B, -1, M, L * P).softmax(-1)
        attnT = a_tm.reshape(B, -1, M * L * P)[..., acp].transpose(1, 2)
        got = dav.ms_deform_attn_encoder_vmem_v3(value, SHAPES, offT.contiguous(),
                                                 attnT.contiguous(), halo=HALO, tile_sizes=TILES)
    np.testing.assert_allclose(got[:, inv].numpy(), want.numpy(), atol=1e-5)


def test_entries_refuse_grad_and_wrong_shapes():
    value, off, loc, attn = _inputs(3, offset_cells=1.0)
    v = torch.from_numpy(value).requires_grad_(True)
    for entry in ENTRIES:
        a, b = _layout(entry, off, loc, attn)
        fn = {"vmem": dav.ms_deform_attn_encoder_vmem,
              "vmem_tm": dav.ms_deform_attn_encoder_vmem_tm,
              "vmem_v3": dav.ms_deform_attn_encoder_vmem_v3}[entry]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(v, SHAPES, torch.from_numpy(a), torch.from_numpy(b), tile_sizes=TILES)
    with pytest.raises(ValueError, match="Lq == S"):
        dav.ms_deform_attn_encoder_vmem(torch.from_numpy(value), SHAPES,
                                        torch.from_numpy(loc[:, :-1]),
                                        torch.from_numpy(attn[:, :-1]))
    a, b = _layout("vmem_v3", off, loc, attn)
    with pytest.raises(ValueError, match="slots"):  # another tiling's token axis
        dav.ms_deform_attn_encoder_vmem_v3(torch.from_numpy(value), SHAPES, torch.from_numpy(a),
                                           torch.from_numpy(b), tile_sizes=(16, 16, 16, 16))


def test_bench_tool_on_cpu():
    from gomatching_tpu_torch.tools import bench_deform_attn as bench

    res = bench.main(["--cpu", "--size", "48x64", "--batch", "1", "--iters", "1",
                      "--halo", "2", "--tilesets", "8x16,8x16,8x16,8x16;8x8,8x8,8x8,8x8"])
    impls = [r["impl"] for r in res["results"]]
    assert impls == ["gather", "encoder", "merged", "vmem", "vmem", "vmem_tm", "vmem_tm",
                     "vmem_v3", "vmem_v3", "fused"]
    for r in res["results"]:
        assert r["max_abs_err"] <= 1e-5, r
        assert ("staged_share" in r) == (r["impl"] in ("vmem", "vmem_tm", "vmem_v3", "fused"))
