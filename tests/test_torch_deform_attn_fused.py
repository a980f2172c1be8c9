"""The port's fused footprint entry B6c (``ops/deform_attn_fused.py``; its plain version,
as the CPU runs it) against the JAX package: within the halo against
``ms_deform_attn_encoder_fused`` in interpret mode (atol 2e-5, test_deform_attn_fused.py's),
and beyond it (offsets of up to 8 cells at halo 2, locations outside the maps) against
the exact gather core (atol 1e-5), where JAX's fused kernel drops attention mass
(``deform_attn_dropped_mass``) and the port does not."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gomatching_tpu_torch.ops import deform_attn as da
from gomatching_tpu_torch.ops import deform_attn_fused as daf
from gomatching_tpu_torch.ops import deform_attn_vmem as dav

SHAPES = [(20, 28), (10, 14), (5, 7), (3, 4)]  # test_deform_attn_tiled.py's
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P = 2, 2, 8, 4, 3
TILES = (8, 8, 4, 2)


def _inputs(seed, offset_cells, far=0.0):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D).astype(np.float32)
    refs = []
    for h, w in SHAPES:
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        refs.append(np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1))
    ref = np.concatenate(refs, 0)[None, :, None, None, None, :]
    off = rng.uniform(-offset_cells, offset_cells, (B, S, M, L, P, 2)).astype(np.float32)
    off = np.where(rng.rand(*off.shape) < far, off * 10, off)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    loc = (ref + off / wh[None, None, None, :, None, :]).astype(np.float32)
    attn = rng.rand(B, S, M, L, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return value, loc, attn


def _port(value, loc, attn, halo, block=8):
    return daf.ms_deform_attn_encoder_fused(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                            torch.from_numpy(attn), halo=halo, block=block,
                                            tile_sizes=TILES).numpy()


def test_fused_matches_jax_interpret_within_halo():
    from gomatching_tpu.ops.deform_attn_fused import ms_deform_attn_encoder_fused

    value, loc, attn = _inputs(0, offset_cells=2.0)
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    args = [jnp.asarray(a) for a in (value, loc, attn)]
    fn = jax.jit(lambda v, x, a: ms_deform_attn_encoder_fused(v, SHAPES, x, a, halo=4,
                                                              tile_sizes=TILES, interpret=True))
    want = np.asarray(fn.lower(*args).compile(opts)(*args))
    before = dict(da.launch_counts)
    np.testing.assert_allclose(_port(value, loc, attn, halo=4), want, atol=2e-5)
    assert da.launch_counts == before  # CPU tensors run the plain version


@pytest.mark.parametrize("block", [8, 1])
def test_fused_exact_beyond_halo(block):
    from gomatching_tpu.ops.deform_attn import ms_deform_attn_core
    from gomatching_tpu.ops.deform_attn_tiled import deform_attn_dropped_mass

    value, loc, attn = _inputs(1, offset_cells=8.0, far=0.05)
    assert (loc < 0).any() and (loc > 1).any()
    jloc, jattn = jnp.asarray(loc), jnp.asarray(attn)
    want = np.asarray(ms_deform_attn_core(jnp.asarray(value), SHAPES, jloc, jattn))
    np.testing.assert_allclose(_port(value, loc, attn, halo=2, block=block), want, atol=1e-5)
    # what JAX's fused kernel leaves out here (4.3e-2 of the attention at block 1; the
    # 8-aligned footprints cover most of these small maps)
    dropped = float(deform_attn_dropped_mass(SHAPES, jloc, jattn, halo=2, block=block,
                                             tile_sizes=TILES))
    assert dropped > 0
    # the port's footprints are JAX's: the corners beyond them come from device memory
    fp = daf.fused_footprints(SHAPES, P, 2, block, TILES)
    share = dav.staged_share(fp, SHAPES, torch.from_numpy(loc))
    smem, taps = (sum(v[k] for v in share.values()) for k in (0, 1))
    assert 0 < smem < taps


def test_fused_tiles_follow_jax_and_entry_refuses():
    from gomatching_tpu.ops import deform_attn_tiled as jt

    assert daf.fused_tiles(None, 4) == [(t, t) for t in jt._DEFAULT_TILES]
    assert daf.fused_tiles((16, 8), 4) == [(16, 16), (8, 8), (4, 4), (2, 2)]
    assert daf.fused_tiles((3,), 3) == [(3, 3), (2, 2), (2, 2)]
    value, loc, attn = _inputs(2, offset_cells=1.0)
    with pytest.raises(RuntimeError, match="no backward"):
        daf.ms_deform_attn_encoder_fused(torch.from_numpy(value).requires_grad_(True), SHAPES,
                                         torch.from_numpy(loc), torch.from_numpy(attn))
    with pytest.raises(ValueError, match="Lq == S"):
        daf.ms_deform_attn_encoder_fused(torch.from_numpy(value), SHAPES,
                                         torch.from_numpy(loc[:, 1:]),
                                         torch.from_numpy(attn[:, 1:]))
