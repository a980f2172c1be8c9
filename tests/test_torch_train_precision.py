"""Tracker training with the frozen spotter in bf16 (``MODEL.PRECISION`` bfloat16)
against the JAX package's ``Trainer``: the spotter's tensors bf16, the head training in
f32, the checkpoint holding the f32 spotter, and one step on
tests/test_torch_train_tracker.py's padded 3-frame clip and seeded weights, dropout off
(tests/test_torch_train_i420.py holds the step on the I420 wire). Also a repair:
pretraining runs f32 whatever ``MODEL.PRECISION`` says, as JAX's pretraining model takes
no compute dtype: one step under bfloat16 equals the float32 step exactly.

Tolerance: the step's losses within twice JAX's own bf16-vs-f32 drift of each of JAX's
bf16 losses (at least LOSS_RTOL of the loss): the two frameworks round bf16 at other
places."""

import functools
import os

import numpy as np

import jax
import torch

from test_torch_train_tracker import (CANVAS, FAST_COMPILE, FRAME_HW, LOSS_RTOL, STEP_OPTS,
                                      _cfgs, _fused, _gap_threshold, _seeded_params, _targets)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")


def test_bf16_trainer_step_matches_jax_bf16(monkeypatch):
    """A Trainer under MODEL.PRECISION bfloat16: backbone and detection_transformer bf16
    (buffers too), roi_heads f32 and alone in the optimizer, the checkpoint's state_dict
    all f32 and equal to the loaded weights outside roi_heads; one step's losses (the
    thresholds in a gap of JAX's bf16 fused scores) within twice the drift between the
    losses of JAX's bf16 and f32 spots of JAX's bf16 losses. JAX's losses are its
    ``_loss_fn`` on its spot's query features, as its update computes them before the
    gradient (the head reads only its own f32 weights, so one program serves both
    precisions); JAX compiles with XLA:CPU's cheap options."""
    import jax.numpy as jnp

    from gomatching_tpu.engine.train import (Trainer as JaxTrainer, pack_host_batch,
                                             unpack_host_batch, unpack_spot_meta)
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import canonical_key, params_from_jax

    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    images = np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8)
    targets = _targets(np.random.RandomState(2))
    spots, params = {}, None
    for prec in ("bfloat16", "float32"):
        jcfg, _ = _cfgs(CONFIG, STEP_OPTS + ["MODEL.PRECISION", prec])
        jmodel = jax_build(jcfg)
        if params is None:
            params = _seeded_params(jmodel, np.random.RandomState(1))
        jtr = JaxTrainer(jcfg, jmodel, params)
        out = jtr._spot(jtr.state.frozen, jtr.state.trainable, images, FRAME_HW)
        spots[prec] = (unpack_spot_meta(np.asarray(out["host_meta"])),
                       out["query_features"].astype(jnp.float32))
    th = _gap_threshold(_fused(spots["bfloat16"][0]))
    opts = STEP_OPTS + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(th),
                        "MODEL.ASSO_HEAD.ASSO_THRESH", str(th)]
    jcfg, tcfg = _cfgs(CONFIG, opts + ["MODEL.PRECISION", "bfloat16"])
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params)
    meta = None

    def losses(trainable, flat, qf):
        b = unpack_host_batch(flat, meta)
        b["query_features"] = qf
        total, parts = jtr._loss_fn(trainable, {}, b)
        return {**parts, "total_loss": total}

    run = jax.jit(losses)
    jlosses = {}
    for prec, (host, qf) in spots.items():
        flat, meta = pack_host_batch(jtr.prepare_batch(host, targets))
        jlosses[prec] = {k: float(v) for k, v in run(jtr.state.trainable, flat, qf).items()}

    sd = params_from_jax(params, tcfg)
    tr = Trainer(tcfg, sd, device="cpu")
    for name, t in tr.model.state_dict().items():
        frozen = name.startswith(("backbone.", "detection_transformer."))
        assert t.dtype == (torch.bfloat16 if frozen else torch.float32), name
    assert tr.trainable and all(p.dtype == torch.float32 for p in tr.trainable)
    assert all(n.startswith("roi_heads.") for n in tr.trainable_names)
    metrics = tr.step(images, FRAME_HW, targets)
    assert tr.last_batch["prop_valid"].any()
    assert sorted(metrics) == sorted(jlosses["bfloat16"])
    for k, want in jlosses["bfloat16"].items():
        drift = abs(want - jlosses["float32"][k])
        assert abs(metrics[k] - want) <= max(2 * drift, LOSS_RTOL * abs(want)), (
            k, metrics[k], want, drift)
    ckpt = tr.model_state_dict()
    assert set(ckpt) == set(tr.model.state_dict())
    assert all(v.dtype == torch.float32 for v in ckpt.values())
    for k, v in ckpt.items():
        if not k.startswith("roi_heads."):
            assert torch.equal(v, torch.as_tensor(sd[canonical_key(k)])), k


def test_pretraining_ignores_precision():
    """Pretraining builds under MODEL.PRECISION bfloat16 and runs f32, as JAX's pretraining
    model takes no compute dtype: one step equals the float32 step exactly."""
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from test_torch_pretrain import TINY as PRE_TINY, _targets

    rng = np.random.RandomState(0)
    image = rng.randn(1, 64, 64, 3).astype(np.float32)
    targets = _targets(rng)
    runs = {}
    for prec in ("float32", "bfloat16"):
        cfg = setup_train_cfg(CONFIG, list(PRE_TINY) + ["MODEL.PRECISION", prec])
        tr = SpotterPretrainer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        assert all(p.dtype == torch.float32 for p in tr.model.parameters())
        runs[prec] = (tr.step(image, targets), tr.model.state_dict())
    (m32, p32), (m16, p16) = runs["float32"], runs["bfloat16"]
    assert m16 == m32
    assert set(p16) == set(p32) and all(torch.equal(p16[k], p32[k]) for k in p32)
