"""The port's probe kernels' plain versions (T1 ``ops/gather_probe.py``, T2
``ops/onehot_g.py``, as the CPU runs them) against the JAX probes' Pallas kernels in
interpret mode, and the port's two probe tools on the CPU.

T2: ``onehot_g_plain`` against ``tools/probe_bf16_g.py:_g_kernel`` at that tool's
shape, coordinates uniform in (-2, F + 1) so that taps fall off both edges: f32 within
1e-6, the two bf16-output variants bit for bit. T1: ``gather_rows_sum_plain`` against
a copy of ``tools/bench_pallas_gather.py``'s kernel body (:49-54 and :82-87, the second
with the bf16 upcast) in that tool's ``pallas_call`` (VMEM in, SMEM out), and against
its XLA formula on f32 tables: exact on integer-valued tables, rtol 1e-5 on randn.

The kernels' own orders, ahead of any card: a model of T2's sparse-tile order (a zeroed
tile, the <= 4 taps of each (p, q) added in p order) equals ``onehot_g_plain`` in all
three variants; T1's slice plan puts every table row in exactly one slice within the
shared-memory budget, and its constants and scratch sizes are those of
``csrc/probes.cu``."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gomatching_tpu_torch.ops import gather_probe as gp
from gomatching_tpu_torch.ops import onehot_g as og

# XLA:CPU's cheap LLVM options: the interpret-mode kernels compile in a fraction of the time
OPTS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
VARIANTS = {"f32": (jnp.float32, jnp.float32), "bf16": (jnp.bfloat16, jnp.bfloat16),
            "f32_bf16_out": (jnp.float32, jnp.bfloat16)}
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _compiled(fn, *args):
    return np.asarray(jax.jit(fn).lower(*args).compile(OPTS)(*args).astype(jnp.float32))


def _g_inputs(seed=0):
    from tools.probe_bf16_g import FH, FW, P, Q

    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, FW + 1, (P, Q)).astype(np.float32)
    y = rng.uniform(-2, FH + 1, (P, Q)).astype(np.float32)
    a = rng.uniform(0, 1, (P, Q)).astype(np.float32)
    return x, y, a


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_onehot_g_plain_matches_jax_interpret(variant):
    from tools.probe_bf16_g import FH, FW, _g_kernel

    dtype, out_dtype = VARIANTS[variant]
    x, y, a = _g_inputs()
    assert (x < 0).any() and (x >= FW - 1).any() and (y < 0).any() and (y >= FH - 1).any()
    fn = pl.pallas_call(functools.partial(_g_kernel, dtype=dtype),
                        out_shape=jax.ShapeDtypeStruct((FH, FW, x.shape[1]), out_dtype),
                        interpret=True)
    want = _compiled(fn, *(jnp.asarray(t) for t in (x, y, a)))
    got = og.onehot_g_plain(*(torch.from_numpy(t) for t in (x, y, a)), FH, FW,
                            TORCH[dtype], TORCH[out_dtype])
    assert got.shape == (FH, FW, x.shape[1]) and got.dtype == TORCH[out_dtype]
    if out_dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        assert torch.equal(got.float(), torch.from_numpy(want.copy()))


def test_onehot_g_wrapper_runs_plain_on_cpu():
    x, y, a = (torch.from_numpy(t) for t in _g_inputs(1))
    before = dict(og.launch_counts)
    for dtype, out_dtype in og.VARIANTS:
        got = og.onehot_g(x, y, a, 32, 32, dtype, out_dtype)
        assert torch.equal(got, og.onehot_g_plain(x, y, a, 32, 32, dtype, out_dtype))
    assert og.launch_counts == before  # CPU tensors run the plain version
    with pytest.raises(ValueError, match="must be one of"):
        og.onehot_g(x, y, a, 32, 32, torch.bfloat16, torch.float32)
    with pytest.raises(TypeError, match="float32"):
        og.onehot_g(x.double(), y, a, 32, 32)
    with pytest.raises(ValueError, match="P, Q"):
        og.onehot_g(x[None], y, a, 32, 32)


def _sparse_tile_g(x, y, a, fh, fw, dtype, out_dtype):
    """T2's kernel order in torch: G starts at zero, and for p in order each (p, q) adds
    only its <= 4 taps that fall on the map, term = rnd(rnd(yw * a) * xw), G = rnd(G +
    term), every op in f32 and, for bf16 arithmetic, rounded to bf16 after it."""
    P, Q = x.shape
    rnd = ((lambda t: t.to(torch.bfloat16).float()) if dtype == torch.bfloat16
           else (lambda t: t))
    g = torch.zeros(fh, fw, Q, dtype=torch.float32)
    q = torch.arange(Q)
    for p in range(P):
        xv, yv, av = rnd(x[p]), rnd(y[p]), rnd(a[p])
        x0, y0 = torch.floor(xv), torch.floor(yv)
        dx, dy = rnd(xv - x0), rnd(yv - y0)
        xi, yi = x0.long(), y0.long()
        for h, yw in ((yi, rnd(1 - dy)), (yi + 1, dy)):
            for w, xw in ((xi, rnd(1 - dx)), (xi + 1, dx)):
                on = (h >= 0) & (h < fh) & (w >= 0) & (w < fw)
                term = rnd(rnd(yw * av) * xw)
                hh, ww, qq = h[on], w[on], q[on]
                g[hh, ww, qq] = rnd(g[hh, ww, qq] + term[on])
    return g.to(out_dtype)


@pytest.mark.parametrize("shape", [(8, 32, 32, 256), (3, 5, 7, 37)], ids=["probe", "odd"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_onehot_g_sparse_tile_order_matches_plain(variant, shape):
    P, FH, FW, Q = shape
    dtype, out_dtype = (TORCH[t] for t in VARIANTS[variant])
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.uniform(-2, FW + 1, (P, Q)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, FH + 1, (P, Q)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0, 1, (P, Q)).astype(np.float32))
    assert (x < 0).any() and (x >= FW - 1).any() and (y < 0).any() and (y >= FH - 1).any()
    want = og.onehot_g_plain(x, y, a, FH, FW, dtype, out_dtype)
    got = _sparse_tile_g(x, y, a, FH, FW, dtype, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _cu_defines():
    src = (Path(gp.__file__).resolve().parent.parent / "csrc" / "probes.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (T1_\w+) (\d+)", src, re.M)}


# (R, C, element bytes): the probe's four cases, then C = 1, C = 33, a table smaller
# than one slice, and a bf16 table with an odd C
SLICE_CASES = [(8192, 32, 4), (8192, 128, 4), (32768, 32, 4), (32768, 32, 2),
               (5000, 1, 4), (9000, 33, 4), (100, 32, 4), (20000, 33, 2)]


@pytest.mark.parametrize("R,C,size", SLICE_CASES)
def test_gather_slice_plan_covers_every_row_once(R, C, size):
    rows, n_slices = gp.slice_plan(R, C, size)
    row_bytes = C * size
    assert rows % gp.SLICE_ALIGN_ROWS == 0 and rows * row_bytes % 16 == 0
    assert rows * row_bytes <= gp.SLICE_BYTES < (rows + gp.SLICE_ALIGN_ROWS) * row_bytes
    assert 1 <= n_slices <= gp.MAX_SLICES
    covered = np.concatenate([np.arange(s * rows, min(R, (s + 1) * rows))
                              for s in range(n_slices)])
    assert np.array_equal(covered, np.arange(R))  # each row in exactly one slice, in order
    assert all(min(R, (s + 1) * rows) > s * rows for s in range(n_slices))  # none empty
    if R <= rows:
        assert n_slices == 1


def test_gather_slice_plan_constants_and_scratch_match_the_kernel():
    d = _cu_defines()
    assert (gp.SLICE_BYTES, gp.SLICE_ALIGN_ROWS, gp.MAX_SLICES, gp.SORT_WARPS, gp.WARP_ELEMS) == (
        d["T1_SLICE_BYTES"], d["T1_SLICE_ALIGN_ROWS"], d["T1_MAX_SLICES"], d["T1_SORT_WARPS"],
        d["T1_WARP_ELEMS"])
    assert d["T1_SLICE_BYTES"] + 1024 == d["T1_SMEM_BYTES"] == 232448  # sm_90's opt-in limit
    # the probe's main case, f32 and bf16: 1808 rows of 128 B (19 slices), 3616 of 64 B (10)
    assert gp.slice_plan(32768, 32, 4) == (1808, 19)
    assert gp.slice_plan(32768, 32, 2) == (3616, 10)
    # gather_rows_sum_scratch's formula: 8192 indices a block of pass A
    assert gp.scratch_sizes(64 * 32768, 19, 132) == (2097152, 256 * 16 * 19, 19 * 256 + 1, 20, 132)
    assert gp.scratch_sizes(16 * 8192, 5, 132) == (131072, 16 * 16 * 5, 5 * 16 + 1, 6, 132)
    assert gp.scratch_sizes(0, 1, 132) == (0, 16, 2, 2, 132)
    with pytest.raises(ValueError, match="no slice plan"):
        gp.slice_plan(100, gp.SLICE_BYTES // 8 // 4 + 1, 4)  # 8 rows do not fit
    with pytest.raises(ValueError, match="slices"):
        gp.slice_plan(gp.MAX_SLICES * 1808 + 1, 32, 4)


@pytest.mark.parametrize("R,C,size", SLICE_CASES + [(32 * 57856, 1, 4), (32 * 115712, 1, 2)])
def test_gather_slice_of_reciprocal_is_exact(R, C, size):
    """The kernel's slice number (probes.cu:slice_of): r * (1 / rps) in f32, truncated,
    then one correction step each way, equals r // rps for every row of the plan."""
    rows, n_slices = gp.slice_plan(R, C, size)
    r = np.arange(R, dtype=np.int64)
    inv = np.float32(1) / np.float32(rows)
    s = np.trunc(r.astype(np.float32) * inv).astype(np.int64)
    assert np.abs(s - r // rows).max() <= 1
    s -= s * rows > r
    s += (s + 1) * rows <= r
    assert np.array_equal(s, r // rows) and s.max() == n_slices - 1


def _jax_gather_sum(v, idx):
    """``bench_pallas_gather.py``'s kernel body (with ``kernel_b``'s upcast, a no-op on
    an f32 table) in its ``pallas_call``, interpreted."""
    R, C = v.shape
    n = idx.shape[0]

    def kernel(v_ref, i_ref, o_ref):
        acc = jnp.zeros((R, C), jnp.float32)
        for g in range(n):
            ib = jax.lax.broadcast_in_dim(i_ref[g], (R, C), (0,))
            acc = acc + jnp.take_along_axis(v_ref[:], ib, axis=0).astype(jnp.float32)
        o_ref[0, 0] = jnp.sum(acc)

    fn = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        interpret=True,
    )
    return _compiled(fn, v, idx)


@pytest.mark.parametrize("table", ["integer", "randn"])
@pytest.mark.parametrize("C", [32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_sum_plain_matches_jax_interpret(table, C, dtype):
    R, n = 256, 4
    rng = np.random.RandomState(C)
    # integer entries in -3..3: every partial sum is an integer far below 2**24 (and
    # exact in bf16), so any order of summation gives the same f32 number
    v = (rng.randint(-3, 4, (R, C)) if table == "integer" else rng.randn(R, C)).astype(np.float32)
    idx = rng.randint(0, R, (n, R)).astype(np.int32)
    jv, jidx = jnp.asarray(v, getattr(jnp, dtype)), jnp.asarray(idx)
    want = _jax_gather_sum(jv, jidx)
    got = gp.gather_rows_sum_plain(torch.from_numpy(v).to(getattr(torch, dtype)),
                                   torch.from_numpy(idx))
    assert got.shape == (1, 1) and got.dtype == torch.float32
    # the tool's XLA formula, on an f32 table as the tool ran it (on a bf16 table
    # jnp.sum accumulates in bf16)
    refs = [want] + ([np.asarray(jnp.take(jv, jidx.ravel(), axis=0).sum())]
                     if dtype == "float32" else [])
    for ref in refs:
        if table == "integer":
            assert got.item() == float(ref.item())
        else:
            np.testing.assert_allclose(got.item(), float(ref.item()), rtol=1e-5)


def test_gather_rows_sum_wrapper_runs_plain_on_cpu():
    rng = np.random.RandomState(3)
    v = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 64, (3, 64)).astype(np.int32))
    before = dict(gp.launch_counts)
    assert torch.equal(gp.gather_rows_sum(v, idx), gp.gather_rows_sum_plain(v, idx))
    assert gp.launch_counts == before  # CPU tensors run the plain version
    with pytest.raises(ValueError, match="int32"):
        gp.gather_rows_sum(v, idx.long())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gp.gather_rows_sum(v.double(), idx)


def test_bench_gather_tool_on_cpu():
    from gomatching_tpu_torch.tools import bench_gather

    res = bench_gather.main(["--cpu", "--iters", "1"])
    cases = [(r["R"] * bench_gather.CPU_SCALE, r["C"], r["n"], r["dtype"]) for r in res["results"]]
    assert cases == [(R, C, n, str(d).replace("torch.", "")) for R, C, n, d in bench_gather.CASES]
    for r in res["results"]:
        assert r["kernel_ms"] > 0 and r["library_ms"] > 0 and r["kernel_rows_per_s"] > 0
        np.testing.assert_allclose(r["value"], r["library_value"], rtol=1e-5)


def test_probe_bf16_g_tool_on_cpu():
    from gomatching_tpu_torch.tools import probe_bf16_g

    res = probe_bf16_g.main(["--cpu", "--iters", "1"])
    assert set(res["ms"]) == {"f32", "bf16", "f32_bf16_out"}
    assert all(t > 0 for t in res["ms"].values())
    # bf16 coordinates in [16, 32) resolve 1/8 of a cell: G moves by up to ~0.1
    assert 0 < res["bf16_max_abs_err"] < 0.2
    assert 0 < res["mixed_max_abs_err"] <= 2 ** -8  # one bf16 rounding of |G| < 1
