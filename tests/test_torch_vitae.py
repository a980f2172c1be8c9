"""The port's ViTAEv2 trunk (models/vitae.py) against JAX ``ViTAEv2`` on the same seeded
weights and inputs: symmetric window padding with the odd remainder at the bottom and
right, PRM's dilated convs, PCM's grouped convs with their frozen BN, the T2T attention
of the 'transformer' reduction cells and the global attention of their normal cells; the
full-width ViTAEv2-S tree maps onto the port; a reference-named state dict with the
reference's buffers loads strictly.

The trunk is narrowed (token dims 8-32, groups and depths cut to fit); the JAX side is
jitted with XLA:CPU's cheap options. Tolerance: f32, max |port - JAX| <= 1e-4 of max |JAX|
per output.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_swin import CONFIG, assert_close, port_state_dict, run_jitted, seeded_tree

TINY_VITAE = dict(embed_dims=(8, 8, 16, 16), token_dims=(8, 16, 16, 32), rc_heads=(1, 1, 2, 4),
                  nc_heads=(1, 2, 4, 8), rc_groups=(1, 2, 2, 4), nc_groups=(1, 4, 4, 8),
                  nc_depths=(1, 1, 2, 1))


@pytest.mark.parametrize("hw", [(72, 100), (64, 64), (71, 99)])
def test_vitae_trunk_matches_jax(hw):
    """72x100: stage 1 is 18x25 tokens, padded by 1 + 2 rows and 1 + 2 columns to its
    7x7 windows, stage 2 9x13 by 2 + 3 and 0 + 1; 64x64: 16x16 and 8x8; 71x99: sides 3 mod
    4, which the port pads to 72x100 with zeros and JAX does not, the same outputs."""
    from gomatching_tpu.models.vitae import ViTAEv2 as JaxViTAE
    from gomatching_tpu_torch.models.vitae import ViTAEv2
    from gomatching_tpu_torch.weights import vitae_key_map

    jm = JaxViTAE(**TINY_VITAE)
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    jparams = seeded_tree(shapes, np.random.RandomState(2))
    want = run_jitted(jm.apply, jparams, jnp.asarray(x))

    model = ViTAEv2(**TINY_VITAE)
    model.load_state_dict(port_state_dict(jparams, vitae_key_map,
                                          nc_depths=TINY_VITAE["nc_depths"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["res3", "res4", "res5"]
    for k in want:
        assert_close(got[k], want[k], k)


def test_full_width_tree_maps_onto_the_port():
    """JAX's full-width ViTAEv2-S tree converts onto every parameter and FrozenBN tensor of
    the port's trunk, shape for shape; the spotter takes its 128/256/512 channels."""
    from gomatching_tpu.models.vitae import ViTAEv2 as JaxViTAE
    from gomatching_tpu_torch.models.gomatching import BACKBONE_CHANNELS
    from gomatching_tpu_torch.models.vitae import ViTAEv2
    from gomatching_tpu_torch.weights import vitae_key_map

    shapes = jax.eval_shape(JaxViTAE().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = {k: v.shape for k, v in port_state_dict(zeros, vitae_key_map).items()}
    model = ViTAEv2()
    assert got == {k: v.shape for k, v in model.state_dict().items()}
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 64, 64))
    assert tuple(out[k].shape[1] for k in ("res3", "res4", "res5")) == \
        BACKBONE_CHANNELS["build_vitaev2_backbone"]
    assert [out[k].shape[2] for k in ("res3", "res4", "res5")] == [8, 4, 2]


def test_reference_state_dict_loads_strictly():
    """A reference-named GoMatching state dict with the ViTAEv2 trunk, plus the buffers a
    reference checkpoint carries (``rcpe``, ``pos_embed``, ``num_batches_tracked``),
    loads strictly."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import build_key_map, init_state_dict, load_weights

    cfg = setup_eval_cfg(CONFIG, ["MODEL.WEIGHTS", "''", "MODEL.BACKBONE.NAME",
                                  "build_vitaev2_backbone"])
    model = build_model(cfg)
    sd = init_state_dict(cfg, torch.Generator().manual_seed(0))
    assert set(build_key_map(cfg)) <= set(sd)
    bb = "backbone.0.backbone.layers.2"
    ref = dict(sd, **{f"{bb}.NC.0.attn.rcpe": torch.zeros(3),
                      f"{bb}.RC.pos_embed": torch.zeros(3),
                      f"{bb}.NC.0.PCM.1.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    load_weights(model, ref)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_vitae_runs_where_jax_raises():
    """At sides 1 or 2 mod 4 (ICDAR15's 1000x1778 test size is one) JAX's reduction cell
    raises: its PRM and PCM give stage 1 maps of other sizes. The port pads the frame with
    zeros to a multiple of 4, so its output is JAX's on the frame so padded."""
    from gomatching_tpu.models.vitae import ViTAEv2 as JaxViTAE
    from gomatching_tpu_torch.models.vitae import ViTAEv2
    from gomatching_tpu_torch.weights import vitae_key_map

    hw, padded = (66, 97), (68, 100)
    jm = JaxViTAE(**TINY_VITAE)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, *padded, 3)))
    jparams = seeded_tree(shapes, np.random.RandomState(2))
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    with pytest.raises(TypeError):
        jm.apply(jparams, jnp.asarray(x))
    xp = np.zeros((1, *padded, 3), np.float32)
    xp[:, :hw[0], :hw[1]] = x
    want = run_jitted(jm.apply, jparams, jnp.asarray(xp))
    model = ViTAEv2(**TINY_VITAE)
    model.load_state_dict(port_state_dict(jparams, vitae_key_map,
                                          nc_depths=TINY_VITAE["nc_depths"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        assert_close(got[k], want[k], k)
