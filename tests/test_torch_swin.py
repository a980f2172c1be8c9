"""The port's Swin trunk (models/swin.py) against JAX ``SwinTransformer`` on the same
seeded weights and inputs: shifted windows with their -100 mask, sides that are not
multiples of the window, odd sides at every PatchMerging, tiny and small depths; a
reference-named state dict with the reference's buffers loads strictly; drop-path's
per-sample keep rate and rescale with the port's own generator.

The trunks are narrow (embed_dim 16, heads (1, 2, 2, 4)); the JAX side is jitted with
XLA:CPU's cheap options (``run_jitted``), a quarter of its eager time. The full-width
Swin-T/S trees map key for key and shape for shape. Tolerance: f32, max |port - JAX|
<= 1e-4 of max |JAX| per output (the same einsum/softmax chain, in another order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
RTOL = 1e-4
TINY_SWIN = dict(embed_dim=16, num_heads=(1, 2, 2, 4), window_size=7)


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def seeded_tree(tree, rng):
    """Random values for every leaf of a JAX params tree (shapes from ``eval_shape``):
    kernels N(0, 1/fan_in), everything else N(0, 0.5) around the identity of its kind, so
    that norms, biases and the relative-position tables all matter."""

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight", "running_var"):
            a = 1.0 + 0.5 * rng.rand(*shape)
        else:
            a = 0.5 * rng.randn(*shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def port_state_dict(jparams, key_fn, **kw):
    """The JAX trunk's params in the port trunk's names, through the key map of
    ``weights.py`` (the reference's names, here without the ``backbone.0.backbone``
    prefix)."""
    from gomatching_tpu_torch.weights import params_from_jax

    m = {}
    key_fn(m, "bb", **kw)
    sd = params_from_jax({"backbone": jparams["params"]}, None, key_map=m)
    return {k[len("bb."):]: torch.from_numpy(v) for k, v in sd.items()}


def assert_close(got, want, name):
    got = got.detach().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (name, err, np.abs(want).max())


@pytest.mark.parametrize("depths,hw", [
    ((2, 2, 2, 2), (60, 90)),   # patches 15x23: every stage pads its windows, merges odd
    ((2, 2, 18, 2), (36, 52)),  # Swin-S's depths
])
def test_swin_trunk_matches_jax(depths, hw):
    from gomatching_tpu.models.swin import SwinTransformer as JaxSwin
    from gomatching_tpu_torch.models.swin import SwinTransformer
    from gomatching_tpu_torch.weights import swin_key_map

    jm = JaxSwin(depths=depths, **TINY_SWIN)
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    jparams = seeded_tree(shapes, np.random.RandomState(2))
    want = run_jitted(jm.apply, jparams, jnp.asarray(x))

    model = SwinTransformer(depths=depths, **TINY_SWIN)
    model.load_state_dict(port_state_dict(jparams, swin_key_map, depths=depths), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k in want:
        assert_close(got[k], want[k], k)


@pytest.mark.parametrize("swin_type", ["tiny", "small"])
def test_full_width_tree_maps_onto_the_port(swin_type):
    """JAX's full-width Swin-T/S tree (shapes from ``eval_shape``) converts through the
    key map onto every parameter of the port's trunk, shape for shape."""
    from gomatching_tpu.models.swin import SwinTransformer as JaxSwin
    from gomatching_tpu_torch.models.swin import SwinTransformer
    from gomatching_tpu_torch.weights import SWIN_DEPTHS, swin_key_map

    depths = SWIN_DEPTHS[swin_type]
    shapes = jax.eval_shape(JaxSwin(depths=depths).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = {k: v.shape for k, v in port_state_dict(zeros, swin_key_map, depths=depths).items()}
    want = {k: v.shape for k, v in SwinTransformer(depths=depths).state_dict().items()}
    assert got == want


def test_shift_mask_and_index_equal_jax():
    """The shifted-window mask and the relative-position index are JAX's, exactly."""
    from gomatching_tpu.models import swin as jswin
    from gomatching_tpu_torch.models import swin

    np.testing.assert_array_equal(swin._rel_pos_index(7, 7), jswin._rel_pos_index(7, 7))
    for hp, wp in ((14, 21), (7, 7), (28, 14)):
        np.testing.assert_array_equal(swin._shift_mask(hp, wp, 7, 3),
                                      np.asarray(jswin._shift_mask(hp, wp, 7, 3)))


@pytest.mark.parametrize("swin_type", ["tiny", "small"])
def test_reference_state_dict_loads_strictly(swin_type):
    """A reference-named GoMatching state dict with a Swin trunk, plus the buffers a
    reference checkpoint carries (``relative_position_index``, ``attn_mask``,
    ``num_batches_tracked``), loads strictly; another unexpected key still raises."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import build_key_map, init_state_dict, load_weights

    cfg = setup_eval_cfg(CONFIG, ["MODEL.WEIGHTS", "''", "MODEL.BACKBONE.NAME",
                                  "build_swin_backbone", "MODEL.SWIN.TYPE", swin_type])
    model = build_model(cfg)
    sd = init_state_dict(cfg, torch.Generator().manual_seed(0))
    assert set(build_key_map(cfg)) <= set(sd)
    assert model.detection_transformer.input_proj[2][0].in_channels == 768
    n_blocks = 24 if swin_type == "small" else 12
    assert len({k.split(".blocks.")[0] + k.split(".blocks.")[1].split(".")[0]
                for k in sd if ".blocks." in k}) == n_blocks
    bb = "backbone.0.backbone.layers.1.blocks.1.attn"
    ref = dict(sd, **{f"{bb}.relative_position_index": torch.zeros(49, 49, dtype=torch.long),
                      "backbone.0.backbone.layers.1.attn_mask": torch.zeros(4, 49, 49),
                      "backbone.0.backbone.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    load_weights(model, ref)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_weights(model, dict(sd, **{f"{bb}.rel_index": torch.zeros(1)}))


def test_drop_path_keep_rate_and_rescale():
    """Each sample's branch is kept with probability 1 - p (within 4 sigma over 20000
    samples) and divided by 1 - p; the trunk drops paths only when given a generator,
    and a seeded generator repeats its draw."""
    from gomatching_tpu_torch.models.swin import SwinTransformer, drop_path

    p, n = 0.3, 20000
    x = torch.ones(n, 2, 3, 4)
    y = drop_path(x, p, torch.Generator().manual_seed(0))
    per_sample = y.reshape(n, -1)
    assert torch.equal(per_sample.amin(1), per_sample.amax(1))  # one draw a sample
    vals = per_sample[:, 0]
    kept = vals != 0
    assert torch.allclose(vals[kept], torch.full_like(vals[kept], 1 / (1 - p)))
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - p)) < 4 * sigma
    assert torch.equal(drop_path(x, p, None), x) and torch.equal(drop_path(x, 0.0, None), x)

    torch.manual_seed(0)
    model = SwinTransformer(depths=(2, 2, 2, 2), drop_path_rate=0.5, **TINY_SWIN).eval()
    img = torch.randn(4, 3, 56, 56)
    with torch.no_grad():
        det = model(img)["res5"]
        assert torch.equal(det, model(img)["res5"])
        a = model(img, torch.Generator().manual_seed(1))["res5"]
        b = model(img, torch.Generator().manual_seed(1))["res5"]
        c = model(img, torch.Generator().manual_seed(2))["res5"]
    assert torch.equal(a, b) and not torch.equal(a, det) and not torch.equal(a, c)
    # the linear ramp of the rates (swin_transformer.py:570)
    rates = [blk.drop_path for layer in model.layers for blk in layer.blocks]
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.5, 8))
