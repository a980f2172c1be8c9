"""The port's data-parallel step (``Trainer.step_multi`` in one process) against JAX
``Trainer.step_multi`` on a 2-device CPU mesh: two clips of different canvas and frame
count, padded as JAX's train loop pads them (``normalize_clip(canvas=, pad_t=)``, byte for
byte), the same weights, dropout off. Also ``prepare_batch(frame_valid=)`` against JAX's,
and JAX's padding-contributes-nothing check on the port."""

import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_train_tracker import (  # noqa: E402
    CONFIG, FAST_COMPILE, LOSS_RTOL, PARAM_RTOL, STEP_OPTS, _adam_mu, _cfgs, _fused,
    _gap_threshold, _seeded_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (64, 96)  # the padded canvas of the two clips below
ADAMW_EPS = 1e-8  # engine/optim.py's AdamW


def _sample(seed, t, hw):
    """A mapper-like clip: ``t`` float frames of size ``hw`` in [0, 255] (not integers,
    so that the uint8 wire rounds) and the GT of ``make_targets`` in pixels."""
    from gomatching_tpu_torch.utils.synthetic import make_targets

    rng = np.random.RandomState(seed)
    h, w = hw
    tg = make_targets(t, npts=5)
    return types.SimpleNamespace(
        images=[(rng.rand(h, w, 3) * 255).astype(np.float32) for _ in range(t)],
        image_hw=(h, w),
        gt_ctrl=[c * np.asarray([w, h], np.float32) for c in tg["gt_ctrl"]],
        gt_boxes=[b * np.asarray([w, h, w, h], np.float32) for b in tg["gt_boxes"]],
        gt_ids=tg["gt_ids"], gt_texts=[["ab"] * len(i) for i in tg["gt_ids"]])


SAMPLES = [(0, 3, (50, 90)), (1, 2, (60, 70))]  # (seed, frames, size): canvas 64x96, T 3


def _jax_train_net():
    sys.path.insert(0, ROOT)
    import train_net

    return train_net


def _padded_clips(raw=True):
    """Both clips on the common canvas and frame count, each as (images, (T, 2) frame
    sizes, targets with frame_valid), as the port's train loop builds them."""
    from gomatching_tpu_torch.train_net import normalize_clip, targets_from_sample

    samples = [_sample(*s) for s in SAMPLES]
    canvas = (max(s.image_hw[0] for s in samples), max(s.image_hw[1] for s in samples))
    t_max = max(len(s.images) for s in samples)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    clips = []
    for s in samples:
        images, hw = normalize_clip(s, mean, std, raw=raw, canvas=canvas, pad_t=t_max)
        clips.append((images, hw.astype(np.float32), targets_from_sample(s, pad_t=t_max)))
    return samples, canvas, t_max, clips


@pytest.mark.parametrize("raw", [True, False])
def test_padded_normalize_clip_equals_jax(raw):
    """The port's ``normalize_clip(canvas=, pad_t=)`` and ``targets_from_sample(pad_t=)``
    give JAX train_net's padded clip byte for byte: frames, frame sizes (JAX tiles the
    clip's size) and the padding frames' empty GT and ``frame_valid``."""
    jtn = _jax_train_net()
    samples, canvas, t_max, clips = _padded_clips(raw)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    for s, (images, hw, tg) in zip(samples, clips):
        want, (h, w) = jtn.normalize_clip(s, mean, std, canvas=canvas, pad_t=t_max, raw=raw)
        assert images.dtype == want.dtype and images.shape == want.shape == (t_max, *CANVAS, 3)
        assert images.tobytes() == want.tobytes()
        np.testing.assert_array_equal(hw, np.tile(np.asarray([h, w], np.float32), (t_max, 1)))
        jt = jtn.targets_from_sample(s)
        assert len(tg["gt_ctrl"]) == t_max
        np.testing.assert_array_equal(tg["frame_valid"], np.arange(t_max) < len(s.images))
        for t in range(t_max):
            if t < len(s.images):
                np.testing.assert_array_equal(tg["gt_ctrl"][t], jt["gt_ctrl"][t])
                np.testing.assert_array_equal(tg["gt_boxes"][t], jt["gt_boxes"][t])
            else:
                assert tg["gt_ctrl"][t].shape == (0, 5, 2)
                assert tg["gt_boxes"][t].shape == (0, 4)
                assert len(tg["gt_ids"][t]) == 0


@pytest.fixture(scope="module")
def setup():
    """Seeded JAX params, the padded clips, the port's trainer on those weights and a
    threshold in a gap of both clips' fused scores (from the port's spot, within 1e-5 of
    JAX's), so that both sides keep the same proposals."""
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import params_from_jax

    jcfg, tcfg = _cfgs(CONFIG, STEP_OPTS)
    params = _seeded_params(jax_build(jcfg), np.random.RandomState(1), hw=CANVAS)
    _, _, _, clips = _padded_clips()
    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    fused = np.concatenate([_fused(tr.host_fields(tr.spot(im, hw)))[tg["frame_valid"]]
                            for im, hw, tg in clips])
    return params, clips, _gap_threshold(fused)


def _trainers(params, th):
    from gomatching_tpu.engine.train import Trainer as JaxTrainer
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import params_from_jax

    opts = STEP_OPTS + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(th),
                        "MODEL.ASSO_HEAD.ASSO_THRESH", str(th)]
    jcfg, tcfg = _cfgs(CONFIG, opts)
    return (jcfg, tcfg, lambda mesh=None: JaxTrainer(jcfg, jax_build(jcfg), params, mesh=mesh),
            Trainer(tcfg, params_from_jax(params, tcfg), device="cpu"))


def test_step_multi_matches_jax(setup, monkeypatch):
    """One ``step_multi`` over the two padded clips: the port in one process, JAX on a
    2-device mesh (its spot one sharded dispatch, compiled with XLA:CPU's cheap options).
    Each loss (the mean over the clips) within LOSS_RTOL; AdamW's first moment and every
    updated roi_heads entry within PARAM_RTOL of JAX's largest weight, plus what AdamW's
    first step makes of the two sides' gradient difference where the gradient is near
    AdamW's eps."""
    from gomatching_tpu.engine.train import merge_params
    from gomatching_tpu.parallel import build_mesh
    from gomatching_tpu_torch.weights import params_from_jax

    params, clips, th = setup
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    _, tcfg, jax_trainer, tr = _trainers(params, th)
    jtr = jax_trainer(build_mesh(devices=jax.devices()[:2]))
    jmetrics = jtr.step_multi(clips)
    before = {k: v.clone() for k, v in tr.model.roi_heads.state_dict().items()}
    metrics = tr.step_multi(clips)
    assert len(tr.last_batches) == 2
    pv = tr.last_batches[1]["prop_valid"]
    assert pv[:2].any() and not pv[2].any()  # clip 1's padding frame has no proposals
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)

    def roi(tree):
        full = params_from_jax(merge_params({"roi_heads": tree}, params["params"]), tcfg)
        return {k[len("roi_heads."):]: v for k, v in full.items()
                if k.startswith("roi_heads.")}

    want = roi(jax.tree.map(np.asarray, jtr.state.trainable["roi_heads"]))
    mu = roi(jax.tree.map(np.asarray, _adam_mu(jtr.state.opt_state)["roi_heads"]))
    named = dict(tr.model.roi_heads.named_parameters())
    after = tr.model.roi_heads.state_dict()
    assert set(want) == set(after) == set(named)
    lr = float(tcfg.SOLVER.BASE_LR)
    for k, w in want.items():
        got, m = after[k].numpy(), tr.optimizer.state[named[k]]["exp_avg"].numpy()
        # AdamW's first step moves an entry by lr * g / (|g| + eps), g the clipped gradient
        # (10 x the first moment): a function of g whose slope is at most
        # eps / (min |g| + eps)^2 between the two sides' g. Where |g| is near eps (or zero
        # up to rounding) it turns the sides' gradient rounding into update differences,
        # so each entry is held to PARAM_RTOL of JAX's largest weight plus that slope times
        # the sides' gradient difference
        g = 10 * np.where(np.sign(m) == np.sign(mu[k]), np.minimum(np.abs(m), np.abs(mu[k])),
                          0.0)
        slope = ADAMW_EPS / (g + ADAMW_EPS) ** 2
        allowed = PARAM_RTOL * np.abs(w).max() + lr * slope * 10 * np.abs(m - mu[k])
        excess = np.abs(got - w) - allowed
        assert excess.max() <= 0, (k, float(np.abs(got - w).max()), np.abs(w).max())
        assert np.abs(got - before[k].numpy()).max() <= 1.01 * lr, k
        assert np.abs(m - mu[k]).max() <= PARAM_RTOL * np.abs(mu[k]).max() + 1e-12, k


def test_prepare_batch_frame_valid_equals_jax(setup):
    """``prepare_batch(..., frame_valid=)`` on the padded clip's spot gives JAX's arrays
    (the padding frame's proposals dropped), and without ``frame_valid`` the padding frame
    keeps proposals."""
    params, clips, th = setup
    _, _, jax_trainer, tr = _trainers(params, th)
    jtr = jax_trainer()
    images, hw, targets = clips[1]
    host = tr.host_fields(tr.spot(images, hw))
    got = tr.prepare_batch(host, targets, frame_valid=targets["frame_valid"])
    want = jtr.prepare_batch(host, targets, frame_valid=targets["frame_valid"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["prop_valid"][2].any() and got["prop_valid"][:2].any()
    assert tr.prepare_batch(host, targets)["prop_valid"][2].any()


def test_frame_padding_contributes_nothing(setup):
    """tests/test_train_net_mesh.py's check on the port: a clip padded with a zero frame,
    empty GT and ``frame_valid`` gives the unpadded clip's loss within JAX's rtol 5e-2."""
    from gomatching_tpu_torch.utils.synthetic import make_targets

    params, _, _ = setup
    _, _, _, tr = _trainers(params, 0.0001)
    images = np.random.RandomState(3).randn(2, 48, 64, 3).astype(np.float32)
    targets = make_targets(2, npts=5)

    def loss(imgs, tg, frame_valid=None):
        out = tr.spot(imgs, None)
        b = tr.prepare_batch(tr.host_fields(out), tg, frame_valid=frame_valid)
        with torch.no_grad():
            return float(tr.loss(tr.to_device(b), out["query_features"])[0])

    padded = np.concatenate([images, np.zeros_like(images[:1])])
    tg = {"gt_ctrl": targets["gt_ctrl"] + [np.zeros((0, 5, 2), np.float32)],
          "gt_boxes": targets["gt_boxes"] + [np.zeros((0, 4), np.float32)],
          "gt_ids": targets["gt_ids"] + [np.zeros((0,), np.int64)]}
    plain = loss(images, targets)
    np.testing.assert_allclose(loss(padded, tg, np.array([True, True, False])), plain,
                               rtol=5e-2)
