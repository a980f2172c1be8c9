"""The port's video spotter pretraining (MODEL.META_ARCHITECTURE
TransformerPureVideoDetector) against the JAX package: ``build_video_spotter_targets`` on
the loader's clips, one masked pretraining step (a uint8 clip on a padded canvas with
each frame's true size) against JAX's ``SpotterPretrainer._update``, and the
``--task spotter`` video CLI's checkpoints (tests/test_pretrain_surface.py:126).

Tolerances: targets exactly; losses at rtol 1e-4 and AdamW's first moment (0.1 x the
clipped gradient) within 2e-3 of JAX's largest entry per tensor (the image step's
gradient bound, tests/test_torch_pretrain.py); the parameters after the update within
1e-2 of the step's rate, plus 4 ulps of the parameter, where JAX's moment is above 1e-2 of
its tensor's largest, and within 2.02 rates elsewhere (AdamW's first step moves an entry
by the rate times the sign of its gradient, which a gradient at rounding level may flip).
"""

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from test_torch_pretrain import CONFIG, TINY, _seeded_params, _targets
from test_torch_train_tracker_cli import _write_dataset

VIDEO = ["MODEL.META_ARCHITECTURE", "TransformerPureVideoDetector"]
CANVAS = (64, 96)
FRAME_HW = np.array([[56, 80], [64, 90]], np.float32)  # each frame's true size
LOSS_RTOL = 1e-4
MU_RTOL = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


def _cfgs(extra=()):
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_train_cfg

    opts = list(TINY) + VIDEO + list(extra)
    return jax_cfg(CONFIG, opts), setup_train_cfg(CONFIG, opts)


def _frame(sample, t):
    """Frame t of a clip as a one-frame clip of its own size."""
    import dataclasses

    fields = ("images", "gt_boxes", "gt_ids", "gt_texts", "gt_ctrl", "gt_boundary", "gt_beziers")
    return dataclasses.replace(sample, image_hw=tuple(sample.images[t].shape[:2]),
                               **{f: getattr(sample, f)[t:t + 1] for f in fields})


def test_video_targets_equal_jax(tmp_path):
    """Per-frame targets of the same clips (the loaders give JAX's clips for one SEED,
    tests/test_torch_train_tracker_cli.py), array for array: a whole clip where its frames
    share one size, as a video clip's do; every frame against JAX's targets of that frame
    alone. (JAX normalizes by the clip's ``image_hw``, and its ``normalize_clip`` cannot
    stack a GEN_IMAGE_MOTION clip whose frames change size; the port normalizes each
    frame by its own size, as its tracker training does.)"""
    from gomatching_tpu.data.datasets import register_dataset as jax_register
    from gomatching_tpu.data.loader import build_train_loader as jax_loader
    from gomatching_tpu.engine.pretrain import build_video_spotter_targets as jax_targets
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.pretrain import build_video_spotter_targets

    data = _write_dataset(tmp_path)
    register_dataset("synth_port_video_targets", *data)
    jax_register("synth_port_video_targets", *data)
    jcfg, tcfg = _cfgs(["DATASETS.TRAIN", "('synth_port_video_targets',)",
                        "INPUT.TRAIN_SIZE", "64", "SEED", "5"])
    it, jit = iter(build_train_loader(tcfg)), iter(jax_loader(jcfg))
    n_gt, whole = 0, 0
    for _ in range(6):
        sample, jsample = next(it), next(jit)
        got = build_video_spotter_targets(sample, 2, 5, 37)
        wants = [(t, jax_targets(_frame(jsample, t), 2, 5, 37))
                 for t in range(len(jsample.images))]
        if len({img.shape for img in jsample.images}) == 1:
            wants.append((0, jax_targets(jsample, 2, 5, 37)))
            whole += 1
        for t0, want in wants:
            assert sorted(got) == sorted(want)
            for k in want:
                g = got[k][t0:t0 + len(want[k])]
                assert g.shape == want[k].shape and g.dtype == want[k].dtype, k
                np.testing.assert_array_equal(g, want[k], err_msg=k)
        n_gt += int(got["valid"].sum())
    assert n_gt > 0 and whole > 0


def _mus(opt_state):
    """AdamW's first moment of every leaf, merged over the optimizer's LR groups."""
    import optax

    found = []
    jax.tree_util.tree_map(lambda x: x, opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState) and not found.append(x))
    merged = {}
    for state in found:
        for path, leaf in jax.tree_util.tree_leaves_with_path(state.mu):
            if hasattr(leaf, "shape"):
                merged[path] = np.asarray(leaf)
    tree = jax.tree.map(lambda x: None, found[0].mu,
                        is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return jax.tree_util.tree_map_with_path(lambda p, _: merged[p], tree,
                                            is_leaf=lambda x: x is None)


def test_masked_video_step_matches_jax(monkeypatch):
    """One step on a 2-frame uint8 clip whose frames fill 56x80 and 64x90 of a 64x96
    canvas: the encoder and decoder are masked (B1 and B3 on the card), the clip is
    normalized on the device with its padding zeroed. JAX: TRAIN_SAMPLING_IMPL xla (its
    exact sampler), its update program compiled with XLA:CPU's cheap options. No warm-up,
    so that the update moves every entry by the base rate."""
    from gomatching_tpu.engine.pretrain import SpotterPretrainer as JaxPretrainer
    from gomatching_tpu.models.gomatching import build_pretrain_model as jax_build
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.weights import canonical_key, params_from_jax

    extra = ["TPU.TRAIN_SAMPLING_IMPL", "xla", "SOLVER.WARMUP_ITERS", "0"]
    jcfg, tcfg = _cfgs(extra)
    jmodel = jax_build(jcfg)
    rng = np.random.RandomState(0)
    params = _seeded_params(jmodel, rng, hw=CANVAS)
    dt = params["params"]["detection_transformer"]
    for layer in [v for k, v in dt.items() if k.startswith(("encoder_layer", "decoder_layer"))]:
        attn = layer.get("self_attn", layer.get("attn_cross"))
        for name, scale in (("sampling_offsets", 0.05), ("attention_weights", 0.1)):
            k = attn[name]["kernel"]
            attn[name]["kernel"] = (scale * rng.randn(*k.shape)).astype(np.float32)
    images = rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    for img, (h, w) in zip(images, FRAME_HW.astype(int)):
        img[h:], img[:, w:] = 0, 0
    targets = {k: np.concatenate([v, v[:, ::-1]]) for k, v in _targets(rng).items()}

    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    jtr = JaxPretrainer(jcfg, jmodel, params)
    jt = jax.tree.map(jnp.asarray, targets)
    jstate, jlosses = jtr._step_fn(jtr.state, jnp.asarray(images), jnp.asarray(FRAME_HW), jt)

    tr = SpotterPretrainer(tcfg, state_dict=params_from_jax(params, tcfg, pretrain=True),
                           device="cpu")
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    losses = tr.step(images, targets, image_hw=FRAME_HW)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(losses[k], float(jlosses[k]), rtol=LOSS_RTOL, err_msg=k)

    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, pretrain=True)
    mu = params_from_jax(_mus(jstate.opt_state), tcfg, pretrain=True)
    lrs = {id(p): g["lr"] for g in tr.optimizer.param_groups for p in g["params"]}
    for name, p in tr.model.named_parameters():
        key = canonical_key(name)
        got, w, m = p.detach().numpy(), want[key], mu[key]
        m_port = tr.optimizer.state[p]["exp_avg"].numpy()
        assert np.abs(m_port - m).max() <= MU_RTOL * np.abs(m).max() + 1e-20, name
        lr = lrs[id(p)]
        ulp = 4 * np.finfo(np.float32).eps * np.abs(w)
        sig = np.abs(m) > 1e-2 * np.abs(m).max()
        err = np.abs(got - w)
        assert (err[sig] <= 1e-2 * lr + ulp[sig]).all(), (name, err[sig].max(), lr)
        assert (err <= 2.02 * lr + ulp).all(), (name, err.max(), lr)
        if np.abs(m).max() > 0:
            assert not np.array_equal(got, before[name].numpy()), name


def test_video_cli_writes_spotter_checkpoints(tmp_path):
    """``train_net.main --task spotter`` with TransformerPureVideoDetector on a synthetic
    video dataset: a clip a step on a padded canvas, finite losses, and a
    ``spotter_{iter:07d}.pth`` each CHECKPOINT_PERIOD that loads strictly into a fresh
    pretraining model."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.models.gomatching import build_pretrain_model
    from gomatching_tpu_torch.weights import load_weights

    register_dataset("synth_port_video_pretrain", *_write_dataset(tmp_path))
    out = tmp_path / "out"
    history = train_net.main([
        "--config-file", CONFIG, "--cpu", "--task", "spotter", "--max-iter", "2",
        "--opts", *TINY, *VIDEO, "DATASETS.TRAIN", "('synth_port_video_pretrain',)",
        "INPUT.TRAIN_SIZE", "64", "SOLVER.CHECKPOINT_PERIOD", "1", "SEED", "3",
        "OUTPUT_DIR", str(out)])
    assert len(history) == 2 and all(np.isfinite(h["total_loss"]) for h in history)
    assert all(h["frames"] >= 1 and h["image_hw"][0] % 32 == 0 for h in history)
    ckpts = sorted(os.listdir(out / "checkpoints"))
    assert ckpts == ["spotter_0000001.pth", "spotter_0000002.pth"]
    cfg = setup_train_cfg(CONFIG, list(TINY) + VIDEO)
    model = build_pretrain_model(cfg)
    load_weights(model, load_checkpoint(str(out / "checkpoints" / ckpts[-1])))
