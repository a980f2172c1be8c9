"""The port's tracker trainer under every MODEL.FREEZE_TYPE JAX accepts, against the JAX
package: the trainable set equals ``split_params``'; one ``Trainer.step`` equals JAX's
(losses, the head, and a trainable spotter that only AdamW's decoupled decay moves, its
gradient being zero behind the detached spot); a policy JAX rejects still raises.
tests/test_torch_freeze_precision.py holds the mixed-dtype spot of FREEZE_TYPE Backbone
under MODEL.PRECISION bfloat16, its checkpoints, and the tensorboard scalars.

Both sides update from the same spot: the port's (``Trainer.spot``, which
tests/test_torch_train_tracker.py holds to JAX's within 1e-5) is handed to JAX's
``Trainer.step`` as its spot phase, so only the update programs are compiled (XLA:CPU's
cheap options). ``SOLVER.WEIGHT_DECAY`` 5 makes one step's decay, lr * wd = 5e-5 on the
trunk (lr 1e-5 under BACKBONE_MULTIPLIER 0.1) and 5e-4 elsewhere, hundreds of f32 ulps.
Tolerances: losses at rtol 1e-5; a decayed spotter tensor within 2 ulps of
p * (1 - lr * wd) and of JAX's; the head as tests/test_torch_train_tracker.py holds it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_tracker import (CANVAS, CONFIG, FAST_COMPILE, FRAME_HW, LOSS_RTOL,
                                      PARAM_RTOL, STEP_OPTS, TINY, _seeded_params, _targets)
from test_torch_video_pretrain import _mus

POLICIES = ("ExceptROIheads", "ExceptROIheadsID", "ROIheads", "Backbone", "BackboneBottomup", "")
FREEZE_OPTS = STEP_OPTS + ["SOLVER.WEIGHT_DECAY", "5.0",
                           "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", "0.001",
                           "MODEL.ASSO_HEAD.ASSO_THRESH", "0.001"]


def _cfgs(freeze_type, extra=()):
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_train_cfg

    opts = list(TINY) + FREEZE_OPTS + ["MODEL.FREEZE_TYPE", repr(freeze_type) if
                                       freeze_type == "" else freeze_type, *extra]
    return jax_cfg(CONFIG, opts), setup_train_cfg(CONFIG, opts)


@pytest.fixture(scope="module")
def params():
    from gomatching_tpu.models.gomatching import build_model as jax_build

    jcfg, _ = _cfgs("ExceptROIheads")
    return _seeded_params(jax_build(jcfg), np.random.RandomState(1))


@pytest.mark.parametrize("freeze_type", POLICIES)
def test_trainable_set_equals_split_params(params, freeze_type):
    """The parameters that require grad and fill the optimizer are exactly the reference
    keys of the subtrees JAX's ``split_params`` puts in its optimized tree (FrozenBN
    tensors of a trainable trunk included, as they are leaves of JAX's tree)."""
    from gomatching_tpu.engine.train import split_params
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import build_key_map, canonical_key, params_from_jax

    _, tcfg = _cfgs(freeze_type)
    trainable, frozen = split_params(params, freeze_type)
    want = {k for k, (_, target) in build_key_map(tcfg).items() if target[0] in trainable}
    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    got = {canonical_key(n) for n in tr.trainable_names}
    assert got == want and got
    in_opt = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    named = dict(tr.model.named_parameters())
    assert in_opt == {id(named[n]) for n in tr.trainable_names}
    assert all(p.requires_grad == (n in tr.trainable_names) for n, p in named.items())
    assert ("backbone.0.backbone.stem.conv1.norm.weight" in got) == ("backbone" in trainable)


def test_cascade_policy_raises():
    """A cascade-classifier policy names CenterNet2's ``roi_heads.box_predictor``, which
    GoMatching lacks: JAX's ``split_params`` and the port's trainer both raise."""
    from gomatching_tpu.engine.train import split_params
    from gomatching_tpu_torch.engine.train import Trainer

    _, tcfg = _cfgs("ExceptCascadeROIheads")
    with pytest.raises(NotImplementedError, match="CenterNet2"):
        split_params({"params": {}}, "ExceptCascadeROIheads")
    with pytest.raises(NotImplementedError, match="CenterNet2"):
        Trainer(tcfg, device="cpu")


def _jax_spot(spot_out):
    """The port's spot as JAX's spot phase hands it on: the packed host fields and the
    query features (JAX train.py:326-340)."""
    meta = [spot_out[f].float() for f in ("pred_logits", "re_pred_logits", "pred_ctrl_points",
                                          "pred_bd_points")]
    return {"host_meta": jnp.asarray(torch.cat(meta, -1).numpy()),
            "query_features": jnp.asarray(spot_out["query_features"].numpy())}


@pytest.mark.parametrize("freeze_type", ["ExceptROIheads", "ROIheads", "Backbone", ""])
def test_step_matches_jax(params, freeze_type, monkeypatch):
    """One step from the same spot: the losses, the head (moved, or untouched under
    ROIheads), each trainable spotter tensor decayed to p * (1 - lr * wd) with Adam's
    moments at 0, each frozen tensor untouched; and the next spot reads the decayed
    spotter."""
    from gomatching_tpu.engine.train import Trainer as JaxTrainer, merge_params
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import canonical_key, params_from_jax

    jcfg, tcfg = _cfgs(freeze_type)
    images = np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8)
    targets = _targets(np.random.RandomState(2))
    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    spot_out = tr.spot(images, FRAME_HW)
    batch = tr.prepare_batch(tr.host_fields(spot_out), targets)
    metrics = tr.update(batch, spot_out["query_features"])
    assert batch["prop_valid"].any()

    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params)
    jspot = _jax_spot(spot_out)
    jtr._spot = lambda *args: jspot
    jmetrics = jtr.step(images, FRAME_HW, targets)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)

    want = params_from_jax(jax.tree.map(np.asarray, merge_params(jtr.state.trainable,
                                                                 jtr.state.frozen)), tcfg)
    mu = _mus(jtr.state.opt_state)
    mu = params_from_jax(merge_params(mu, jax.tree.map(np.zeros_like, jtr.state.frozen)), tcfg)
    lrs = {id(p): g["lr"] for g in tr.optimizer.param_groups for p in g["params"]}
    wd = tcfg.SOLVER.WEIGHT_DECAY
    ulp = 2 * np.finfo(np.float32).eps
    moved_spotter = 0
    for name, p in tr.model.named_parameters():
        key = canonical_key(name)
        got, w, p0 = p.detach().numpy(), want[key], before[name].numpy()
        if name not in tr.trainable_names:
            assert np.array_equal(got, p0) and np.array_equal(w, p0), name
        elif name.startswith("roi_heads."):
            m = mu[key]
            noise = np.abs(m) <= 1e-6 * np.abs(m).max()
            err = np.abs(got - w)
            assert err[~noise].max() <= PARAM_RTOL * np.abs(w).max(), (name, err.max())
            assert err.max() <= 2.02 * lrs[id(p)] + PARAM_RTOL * np.abs(w).max(), name
        else:
            decayed = p0 * np.float32(1 - lrs[id(p)] * wd)
            tol = ulp * np.abs(p0)
            assert (np.abs(got - decayed) <= tol).all(), name
            assert (np.abs(got - w) <= tol).all(), name
            assert not tr.optimizer.state[p]["exp_avg"].any(), name
            assert not tr.optimizer.state[p]["exp_avg_sq"].any(), name
            moved_spotter += int(not np.array_equal(got, p0))
    spotter_trains = freeze_type in ("ROIheads", "Backbone", "")
    assert (moved_spotter > 0) == spotter_trains
    if spotter_trains:
        after = tr.spot(images, FRAME_HW)["pred_logits"]
        assert not torch.equal(after, spot_out["pred_logits"])

