"""B5 (the corner-merged sampler of ``TPU.SAMPLING_IMPL 'pallas'``) and its table on bf16
value, as the CPU runs them (their plain versions), against the JAX package on the same
bf16 value: the table against ``_merged_corner_table`` bit for bit (a copy), the sampler
against interpret-mode ``ms_deform_attn_pallas`` and against the f32 gather core.
``chip_smoke.py`` phase 20 holds the CUDA kernels to these plain versions on the card (the
table exactly, B5 within one bf16 ulp).

Tolerances, elementwise, from what each side rounds:
  - against JAX's ``ms_deform_attn_pallas``: both widen each bf16 row to f32, scale it by
    f32 slot weights, sum in f32 and round the output to bf16 once; they differ only in
    the order of the f32 sums, so by at most one bf16 ulp of the larger output, plus 1e-5
    where the output is so near 0 that its ulp is below the sums' reordering;
  - against the f32 core on the same (bf16-valued) inputs: one rounding, at most half an
    ulp, 2**-8 of the magnitude, plus 3e-5 for f32 sums in another order.
Cases: the encoder (Lq = S), the decoder (Lq != S), 1-wide / 1-tall levels, and the edge
shapes phase 20 runs on the card (L*P = 16 at M = 3, L*P = 64, one level, Lq = 13);
locations partly outside [0, 1]. Also: the wrappers dispatch bf16 value to these plain
versions on the CPU without counting a launch, the kernel entries refuse CPU tensors and
every dtype mix but bf16 (or f32) value with f32 locations and attention, and a bf16 input
off the 16-byte words the kernels read (``MERGED_WIDTH``) is refused before any launch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_merged as dam

EDGE_LEVELS = ((6, 9), (3, 5), (2, 3), (1, 2))  # chip_smoke.py's EDGE_LEVELS
CASES = {
    "encoder": dict(shapes=((8, 10), (4, 5), (2, 3)), B=2, M=2, D=8, P=2, Lq=None),
    "decoder": dict(shapes=((6, 8), (3, 4)), B=1, M=4, D=8, P=3, Lq=17),
    "degenerate": dict(shapes=((1, 7), (5, 1), (1, 1), (3, 4)), B=1, M=2, D=4, P=3, Lq=13),
    # the edge shapes chip_smoke.py phase 20 holds the kernels to (odd M: an idle half-warp
    # in the bf16 B5; L*P = 64: four chunks of 16 samples; one level; Lq not a multiple of 8)
    "LP16_M3": dict(shapes=EDGE_LEVELS, B=1, M=3, D=8, P=4, Lq=None),
    "LP64": dict(shapes=EDGE_LEVELS, B=1, M=2, D=8, P=16, Lq=9),
    "L1": dict(shapes=((7, 5),), B=1, M=2, D=8, P=4, Lq=None),
    "Lq13": dict(shapes=EDGE_LEVELS, B=1, M=2, D=8, P=3, Lq=13),
}
HALF_ULP = 2.0**-8


def _compiled(fn, *args):
    """``fn`` as one XLA:CPU program compiled with the cheap options of
    tests/test_torch_deform_attn_edges.py."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
            "xla_cpu_use_fusion_emitters": False}
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(fn).lower(*args).compile(opts)(*args).astype(jnp.float32))


def _inputs(case, seed=0):
    """bf16-valued value (as f32), locations in [-0.2, 1.2], attention normalized."""
    c = CASES[case]
    shapes, B, M, D, P = c["shapes"], c["B"], c["M"], c["D"], c["P"]
    S = sum(h * w for h, w in shapes)
    Lq = S if c["Lq"] is None else c["Lq"]
    L = len(shapes)
    rng = np.random.RandomState(seed)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).bfloat16().float().numpy()
    loc = rng.uniform(-0.2, 1.2, (B, Lq, M, L, P, 2)).astype(np.float32)
    w = rng.rand(B, Lq, M, L * P).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    return value, list(shapes), loc, w.reshape(B, Lq, M, L, P)


def _bf16_ulp(x):
    """bf16's spacing at |x|: 2**(floor(log2 |x|) - 7) (2**-133 at 0)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.where(x == 0, 2.0**-133, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_table_is_jax_table_bit_for_bit(case):
    from gomatching_tpu.ops.deform_attn import _merged_corner_table

    value, shapes, _, _ = _inputs(case)
    vb = torch.from_numpy(value).bfloat16()
    got = dam.merged_corner_table(vb.permute(0, 2, 1, 3), shapes)
    assert got.dtype == torch.bfloat16
    vbm = jnp.asarray(np.ascontiguousarray(value.transpose(0, 2, 1, 3)), jnp.bfloat16)
    want = _merged_corner_table(vbm, shapes)
    assert want.dtype == jnp.bfloat16
    # the same bits: compare the bf16 words as integers
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    # the table entry the CUDA path launches as a kernel runs this plain version here
    assert torch.equal(dam.merged_table(vb, shapes), got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_plain_matches_jax_pallas_and_core(case):
    """The plain bf16 B5 within one bf16 ulp (+1e-5) of interpret-mode
    ms_deform_attn_pallas on the same bf16 value, and within half an ulp (+3e-5) of the
    f32 gather core."""
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas

    value, shapes, loc, attn = _inputs(case, seed=1)
    out = dam.ms_deform_attn_merged(torch.from_numpy(value).bfloat16(), shapes,
                                    torch.from_numpy(loc), torch.from_numpy(attn))
    B, Lq, M = loc.shape[:3]
    assert out.dtype == torch.bfloat16 and out.shape == (B, Lq, M * value.shape[-1])
    got = out.float().numpy()
    want = _compiled(lambda v, lo, a: ms_deform_attn_pallas(
        v.astype(jnp.bfloat16), shapes, lo, a, query_block=8, interpret=True), value, loc, attn)
    excess = np.abs(got - want) - (_bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 1e-5)
    assert excess.max() <= 0, f"max excess {excess.max()} (max |diff| {np.abs(got - want).max()})"
    core = np.asarray(ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc),
                                          jnp.asarray(attn), query_chunk=0))
    excess = np.abs(got - core) - (HALF_ULP * np.abs(core) + 3e-5)
    assert excess.max() <= 0, f"max excess {excess.max()}"


def test_cpu_wrappers_dispatch_bf16_to_plain_versions_without_counting_launches():
    value, shapes, loc, attn = _inputs("decoder", seed=2)
    vb = torch.from_numpy(value).bfloat16()
    before = dict(da.launch_counts)
    with torch.no_grad():
        got = dam.ms_deform_attn_merged(vb, shapes, torch.from_numpy(loc), torch.from_numpy(attn))
        table = dam.merged_table(vb, shapes)
    want = dam.ms_deform_attn_merged_plain(vb.float(), shapes, torch.from_numpy(loc),
                                           torch.from_numpy(attn))
    assert torch.equal(got, want.bfloat16())
    assert table.dtype == torch.bfloat16 and da.launch_counts == before


@pytest.mark.parametrize("bad", [None, "value", "locations", "attention"])
def test_bf16_kernel_entries_refuse_cpu_tensors_and_other_dtypes(bad):
    """The kernel entries take bf16 (or f32) value with f32 locations and attention: any
    other mix raises ValueError naming the dtypes before anything is built or counted; with
    the right dtypes, the B5 entry refuses CPU tensors (the table entry runs its plain
    version there)."""
    value, shapes, loc, attn = _inputs("decoder", seed=3)
    dtypes = {"value": torch.bfloat16, "locations": torch.float32, "attention": torch.float32}
    if bad is not None:
        dtypes[bad] = torch.float16
    v = torch.from_numpy(value).to(dtypes["value"])
    lo = torch.from_numpy(loc).to(dtypes["locations"])
    a = torch.from_numpy(attn).to(dtypes["attention"])
    table = dam.merged_corner_table(v.permute(0, 2, 1, 3), shapes)
    before = dict(da.launch_counts)
    with pytest.raises(ValueError, match="float32 or bfloat16" if bad else "CUDA"):
        dam.merged_sample(table, shapes, lo, a)
    if bad == "value":
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            dam.merged_table(v, shapes)
    assert da.launch_counts == before


def test_bf16_merged_entries_refuse_inputs_off_16_byte_words(monkeypatch):
    """B5 and its table build read bf16 value and the bf16 table in 16-byte words, as they do
    f32 (``MERGED_WIDTH``): a bf16 view that starts 4 elements (8 bytes) into its storage,
    which the kernels' earlier 8-byte reads took, is refused with ValueError naming the
    input, before anything is built or counted. The wrappers dispatch CPU tensors to their
    plain versions (or refuse them) before the guard, so here they are made to take the
    kernel route; the launcher then refuses the aligned CPU tensors only as such."""
    assert da.MERGED_WIDTH == 16
    rng = np.random.RandomState(4)
    shapes, B, M, L, P, Lq = [(3, 4), (2, 2)], 1, 2, 2, 2, 5
    S = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(B, S, M, da.KERNEL_D).astype(np.float32)).bfloat16()
    loc = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32))
    attn = torch.from_numpy(rng.rand(B, Lq, M, L, P).astype(np.float32))
    table = dam.merged_corner_table(value.permute(0, 2, 1, 3), shapes)

    def offset_view(t):
        store = torch.empty(t.numel() + 4, dtype=t.dtype)
        assert store.data_ptr() % 16 == 0
        view = store[4:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        return view

    monkeypatch.setattr(dam, "_on_cpu", lambda *tensors: False)
    before = dict(da.launch_counts)
    with pytest.raises(ValueError, match=rf"{da.MERGED_BF16}: table at address .* 16-byte"):
        dam.merged_sample(offset_view(table), shapes, loc, attn)
    with pytest.raises(ValueError, match=rf"{da.MERGED_TABLE_BF16}: value at address .* 16-byte"):
        dam.merged_table(offset_view(value), shapes)
    # aligned, the same inputs pass the guard and are refused only as CPU tensors
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        dam.merged_sample(table, shapes, loc, attn)
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        dam.merged_table(value, shapes)
    # the guard itself at that width
    with pytest.raises(ValueError, match="value at address .* 16-byte"):
        da.check_aligned("value", offset_view(value).data_ptr(), dam.MERGED_WIDTH)
    assert da.launch_counts == before
