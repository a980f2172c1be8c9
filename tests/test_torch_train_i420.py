"""One f32 tracker step on the port's I420 training wire (``TPU.TRAIN_UPLOAD_FORMAT``
yuv420: the clip encoded on the host, decoded, normalized and masked on the device)
against the JAX package's ``Trainer`` on the same wire, on
tests/test_torch_train_tracker.py's padded 3-frame clip and seeded weights, dropout off,
within that file's tolerances (SPOT_ATOL, LOSS_RTOL, PARAM_RTOL)."""

import functools
import os

import numpy as np

import jax

from test_torch_train_tracker import (CANVAS, FAST_COMPILE, FRAME_HW, LOSS_RTOL, PARAM_RTOL,
                                      SPOT_ATOL, STEP_OPTS, _adam_mu, _cfgs, _fused,
                                      _gap_threshold, _seeded_params, _targets)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")


def test_tracker_step_on_i420_wire_matches_jax(monkeypatch):
    """One f32 Trainer.step on a padded 3-frame clip shipped as I420 (the frames decoded,
    normalized and masked on the device) against JAX's Trainer.step on the same wire, with
    tests/test_torch_train_tracker.py::test_step_matches_jax's checks: the same proposals,
    matches and targets, the losses within LOSS_RTOL and every updated roi_heads tensor
    and AdamW's first moment within PARAM_RTOL, and the spot within SPOT_ATOL. JAX's spot
    is compiled with XLA:CPU's default options here: they fuse the decode's multiply-adds
    as the port computes them (the cheap options round one pixel of this clip the other
    way); its update with the cheap ones."""
    from gomatching_tpu.engine.train import Trainer as JaxTrainer, merge_params, unpack_spot_meta
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer, encode_train_clip
    from gomatching_tpu_torch.weights import params_from_jax

    jcfg, tcfg = _cfgs(CONFIG, STEP_OPTS)
    params = _seeded_params(jax_build(jcfg), np.random.RandomState(1))
    images = np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8)
    wire = encode_train_clip(images, tcfg.INPUT.FORMAT)
    assert wire.ndim == 3
    jtr0 = JaxTrainer(jcfg, jax_build(jcfg), params)
    args = (jtr0.state.frozen, jtr0.state.trainable, wire, FRAME_HW)
    jout = jax.jit(jtr0._spot_fn)(*args)
    jhost = unpack_spot_meta(np.asarray(jout["host_meta"]))
    th = _gap_threshold(_fused(jhost))
    opts = STEP_OPTS + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(th),
                        "MODEL.ASSO_HEAD.ASSO_THRESH", str(th)]
    jcfg, tcfg = _cfgs(CONFIG, opts)
    targets = _targets(np.random.RandomState(2))

    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params)
    jtr._spot = lambda *args: jout
    jbatch = jtr.prepare_batch(jhost, targets)
    jmetrics = jtr.step(wire, FRAME_HW, targets)

    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    spot_out = tr.spot(wire, FRAME_HW)
    for k in ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points",
              "query_features"):
        np.testing.assert_allclose(spot_out[k].numpy(), np.asarray(jout[k]), rtol=SPOT_ATOL,
                                   atol=SPOT_ATOL, err_msg=k)
    batch = tr.prepare_batch(tr.host_fields(spot_out), targets)
    metrics = tr.update(batch, spot_out["query_features"])
    assert batch["prop_valid"].any() and not batch["prop_valid"].all()
    for k in jbatch:
        if k == "prop_boxes":
            np.testing.assert_allclose(batch[k], jbatch[k], atol=SPOT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)

    def roi(tree):
        full = params_from_jax(merge_params({"roi_heads": tree}, params["params"]), tcfg)
        return {k[len("roi_heads."):]: v for k, v in full.items() if k.startswith("roi_heads.")}

    want = roi(jax.tree.map(np.asarray, jtr.state.trainable["roi_heads"]))
    mu = roi(jax.tree.map(np.asarray, _adam_mu(jtr.state.opt_state)["roi_heads"]))
    named = dict(tr.model.roi_heads.named_parameters())
    after = tr.model.roi_heads.state_dict()
    for k, w in want.items():
        m = tr.optimizer.state[named[k]]["exp_avg"].numpy()
        noise = np.abs(mu[k]) <= 1e-6 * np.abs(mu[k]).max()
        err = np.abs(after[k].numpy() - w)[~noise]
        assert err.max() <= PARAM_RTOL * np.abs(w).max(), (k, err.max(), np.abs(w).max())
        assert np.abs(m - mu[k]).max() <= PARAM_RTOL * np.abs(mu[k]).max() + 1e-12, k
