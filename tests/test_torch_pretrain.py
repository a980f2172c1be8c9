"""The port's spotter pretraining (engine/pretrain.py, engine/optim.py, data/*,
train_net.py) against the JAX package: one full-model step on shared weights, the
optimizer against optax, the targets and augmentations, and the CLI on the CPU."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
TINY = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "2",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.WEIGHTS", "''",
    "TPU.MAX_GT", "4",
]
GRAD_RTOL = 1e-3  # max|g_port - g_jax| <= GRAD_RTOL * max|g_jax|, per parameter
# XLA:CPU compiles the ResNet-50 init and its gradient ~3x faster without LLVM's
# expensive passes; the programs are the same HLO
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _run_jitted(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _seeded_params(jmodel, rng, hw=(64, 64)):
    """Seeded weights in the JAX model's own tree (its shapes from ``eval_shape``, which
    needs no compile), drawn as the reference init draws them: kernels N(0, 1/fan_in),
    zero biases, norms at identity, N(0, 1) embeddings."""
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight", "running_var"):
            a = np.ones(shape)
        elif name in ("level_embed", "point_embed"):
            a = rng.randn(*shape)
        else:  # bias, running_mean
            a = np.zeros(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _cfgs(extra=()):
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_train_cfg

    opts = list(TINY) + list(extra)
    return jax_cfg(CONFIG, opts), setup_train_cfg(CONFIG, opts)


def _targets(rng, G=4, npts=5, voc=37):
    return {
        "valid": np.array([[True, True, True, False]]),
        "labels": np.zeros((1, G), np.int32),
        "ctrl_points": rng.rand(1, G, npts, 2).astype(np.float32),
        "bd_points": rng.rand(1, G, npts, 4).astype(np.float32),
        "texts": np.where(np.arange(25)[None, None] < rng.randint(1, 6, (1, G, 1)),
                          rng.randint(0, 36, (1, G, 25)), voc).astype(np.int32),
        "beziers": rng.rand(1, G, 4, 2).astype(np.float32),
    }


def test_pretrain_step_matches_jax():
    """One step on shared seeded weights (JAX: TRAIN_SAMPLING_IMPL xla, its exact
    sampler): identical matches for dec, aux_0 and enc; every loss at rtol 1e-4; every
    parameter's gradient within GRAD_RTOL of JAX's largest entry. The offset and
    attention projections get small random kernels, so that no sample sits on a grid
    line, where the bilinear derivative jumps (the model's init has zero kernels there,
    which puts every encoder sample on one: gradients there are not compared)."""
    from gomatching_tpu.engine.pretrain import SpotterPretrainer as JaxPretrainer
    from gomatching_tpu.engine.spotter_losses import _solve_padded
    from gomatching_tpu.models.gomatching import build_pretrain_model as jax_build
    from gomatching_tpu_torch.engine.pretrain import SpotterPretrainer
    from gomatching_tpu_torch.weights import canonical_key, params_from_jax

    jcfg, tcfg = _cfgs(["TPU.TRAIN_SAMPLING_IMPL", "xla"])
    jmodel = jax_build(jcfg)
    rng = np.random.RandomState(0)
    params = _seeded_params(jmodel, rng)
    dt = params["params"]["detection_transformer"]
    for layer in [v for k, v in dt.items() if k.startswith(("encoder_layer", "decoder_layer"))]:
        attn = layer.get("self_attn", layer.get("attn_cross"))
        for name, scale in (("sampling_offsets", 0.05), ("attention_weights", 0.1)):
            k = attn[name]["kernel"]
            attn[name]["kernel"] = (scale * rng.randn(*k.shape)).astype(np.float32)
    image = rng.randn(1, 64, 64, 3).astype(np.float32)
    targets = _targets(rng)

    jtr = JaxPretrainer(jcfg, jmodel, params)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def jax_loss(p):
        out = jtr._forward(p, jnp.asarray(image), None, None)
        losses = jtr.criterion(out, jt, num_inst=jnp.maximum(jnp.sum(jt["valid"]), 1.0))
        return sum(jax.tree.leaves(losses)), (losses, out)

    (_, (jlosses, jout)), jgrads = _run_jitted(jax.value_and_grad(jax_loss, has_aux=True), params)
    jmatches = {k: _solve_padded(np.asarray(c), np.asarray(nv))
                for k, (c, nv) in _run_jitted(jtr.criterion.costs, jout, jt).items()}

    tr = SpotterPretrainer(tcfg, state_dict=params_from_jax(params, tcfg, pretrain=True),
                           device="cpu")
    losses, matches = tr.forward_backward(*tr.to_device(image, targets))
    assert sorted(matches) == sorted(jmatches) == ["aux_0", "dec", "enc"]
    for k in jmatches:
        np.testing.assert_array_equal(matches[k].numpy(), jmatches[k], err_msg=k)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, pretrain=True)
    names = dict(tr.model.named_parameters())
    assert {canonical_key(n) for n in names} == set(want)
    worst = (0.0, None)
    for name, p in names.items():
        w = want[canonical_key(name)]
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(w)
        err = np.abs(g - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err, np.abs(w).max())
        worst = max(worst, (err / max(np.abs(w).max(), 1e-30), name))
    print(f"worst per-parameter max|g_port - g_jax| / max|g_jax|: {worst}")


def test_spotter_gradients_stop_where_jax_stops():
    """The top-k proposals and each refined reference carry no gradient
    (gomatching_tpu/models/spotter.py:554, :587): the decoder's points reach neither
    the proposal heads nor an earlier layer's refinement."""
    from gomatching_tpu_torch.models.spotter import DeepSoloSpotter
    from gomatching_tpu_torch.models.pos_encoding import position_encoding_2d
    from gomatching_tpu_torch.weights import init_weights_

    spotter = DeepSoloSpotter(d_model=64, n_heads=4, num_encoder_layers=1, num_decoder_layers=2,
                              dim_feedforward=64, num_queries=8, num_points=5)
    init_weights_(spotter, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feats = [torch.randn(1, c, s, s, generator=g) for c, s in ((512, 8), (1024, 4), (2048, 2))]
    pos = [position_encoding_2d((1, s, s), 32, 10000.0, None) for s in (8, 4, 2)]
    out = spotter(feats, pos, None, train_outputs=True)
    assert len(out["aux_outputs"]) == 1
    assert out["enc_logits"].shape == (1, 85, 1) and out["enc_beziers"].shape == (1, 85, 8)
    heads = list(spotter.bezier_proposal_coord.parameters())
    for pts in (out["pred_ctrl_points"], out["pred_bd_points"],
                out["aux_outputs"][0]["pred_ctrl_points"]):
        grads = torch.autograd.grad(pts.sum(), heads, allow_unused=True, retain_graph=True)
        assert all(gr is None or not gr.any() for gr in grads)
    # the last layer's points see layer 1's refinement only as a constant
    last = spotter.ctrl_point_coord[0].layers[-1].weight
    (g_final,) = torch.autograd.grad(out["pred_ctrl_points"].sum(), [last], retain_graph=True)
    (g_enc,) = torch.autograd.grad(out["enc_beziers"].sum(), heads[-1:])
    assert g_final.abs().sum() > 0 and g_enc.abs().sum() > 0


@pytest.mark.parametrize("optimizer", ["ADAMW", "SGD"])
def test_optimizer_matches_optax(optimizer):
    """The port's param groups + AdamW/SGD + LambdaLR + hand-written clip against the
    JAX package's optax chain on fixed gradients, after 1 and 3 steps (through warm-up
    into the cosine); parameters agree to rtol 1e-6."""
    import optax

    from gomatching_tpu.engine.train import build_optimizer as jax_build_optimizer
    from gomatching_tpu_torch.engine.optim import (
        build_optimizer,
        clip_by_global_norm_,
        clip_max_norm,
    )

    extra = ["SOLVER.OPTIMIZER", optimizer, "SOLVER.WARMUP_ITERS", "2", "SOLVER.MAX_ITER", "4",
             "SOLVER.CUSTOM_MULTIPLIER", "0.5",
             "SOLVER.CUSTOM_MULTIPLIER_NAME", "['sampling_offsets']"]
    if optimizer == "SGD":
        extra += ["SOLVER.BASE_LR", "0.01", "SOLVER.LR_SCHEDULER_NAME", "WarmupMultiStepLR",
                  "SOLVER.STEPS", "(2,)"]
    jcfg, tcfg = _cfgs(extra)
    rng = np.random.RandomState(0)
    init = {"backbone": {"w": rng.randn(3, 4)},
            "detection_transformer": {"sampling_offsets": {"kernel": rng.randn(4, 2)},
                                      "head": {"bias": rng.randn(5)}}}
    init = jax.tree.map(lambda a: a.astype(np.float32), init)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.2).astype(np.float32), init)
             for _ in range(3)]

    tx, _ = jax_build_optimizer(jcfg)
    jp = {"params": jax.tree.map(jnp.asarray, init)}
    state = tx.init(jp)

    model = torch.nn.Module()
    model.backbone = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.tensor(init["backbone"]["w"]))})
    model.detection_transformer = torch.nn.ParameterDict({
        "sampling_offsets": torch.nn.Parameter(
            torch.tensor(init["detection_transformer"]["sampling_offsets"]["kernel"])),
        "head": torch.nn.Parameter(torch.tensor(init["detection_transformer"]["head"]["bias"])),
    })
    opt, sched = build_optimizer(tcfg, model)
    assert clip_max_norm(tcfg) == 0.1
    tparams = {"backbone": model.backbone["w"],
               "sampling_offsets": model.detection_transformer["sampling_offsets"],
               "head": model.detection_transformer["head"]}
    for step, g in enumerate(grads, 1):
        updates, state = tx.update({"params": jax.tree.map(jnp.asarray, g)}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tparams["backbone"].grad = torch.tensor(g["backbone"]["w"])
        tparams["sampling_offsets"].grad = torch.tensor(
            g["detection_transformer"]["sampling_offsets"]["kernel"])
        tparams["head"].grad = torch.tensor(g["detection_transformer"]["head"]["bias"])
        clip_by_global_norm_(model.parameters(), clip_max_norm(tcfg))
        opt.step()
        sched.step()
        if step in (1, 3):
            want = jp["params"]
            for got, w in ((tparams["backbone"], want["backbone"]["w"]),
                           (tparams["sampling_offsets"],
                            want["detection_transformer"]["sampling_offsets"]["kernel"]),
                           (tparams["head"], want["detection_transformer"]["head"]["bias"])):
                np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=1e-6,
                                           atol=1e-7, err_msg=f"step {step}")


def _write_dataset(root, n_images=3, hw=(72, 96)):
    """A few random images with a quad and a 14-point polygon each, COCO-style."""
    import cv2

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(n_images):
        fn = f"{i}.jpg"
        cv2.imwrite(str(img_dir / fn), rng.randint(0, 255, (*hw, 3), np.uint8))
        images.append({"id": i + 1, "file_name": fn, "height": hw[0], "width": hw[1]})
        x0 = 8 + 4 * i
        annotations.append({"id": 2 * i + 1, "image_id": i + 1, "category_id": 1,
                            "poly": [x0, 10, x0 + 40, 12, x0 + 40, 26, x0, 24],
                            "transcription": "abc"})
        top = [[10 + 8 * k, 40 + (k % 2)] for k in range(7)]
        bottom = [[58 - 8 * k, 56 - (k % 2)] for k in range(7)]
        annotations.append({"id": 2 * i + 2, "image_id": i + 1, "category_id": 1,
                            "poly": sum(top + bottom, []), "transcription": "###"})
    path = root / "train.json"
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "text"}]}))
    return str(img_dir), str(path)


@pytest.mark.parametrize("rotate,crop_instance", [(True, False), (False, True)])
def test_records_augmentation_and_targets_equal_jax(tmp_path, rotate, crop_instance):
    """load_video_json, augment_pretrain_record (same RandomState seed) and
    build_spotter_targets give exactly the JAX package's arrays."""
    import cv2

    from gomatching_tpu.data.datasets import load_video_json as jax_load
    from gomatching_tpu.data.image_augment import augment_pretrain_record as jax_aug
    from gomatching_tpu.engine.pretrain import build_spotter_targets as jax_targets
    from gomatching_tpu_torch.data.datasets import load_video_json
    from gomatching_tpu_torch.data.image_augment import augment_pretrain_record
    from gomatching_tpu_torch.engine.pretrain import build_spotter_targets

    img_dir, js = _write_dataset(tmp_path)
    recs, jrecs = load_video_json(js, img_dir, 5), jax_load(js, img_dir, 5)
    for rec, jrec in zip(recs, jrecs):
        for a, ja in zip(rec["annotations"], jrec["annotations"]):
            for k in ("texts", "beziers", "boundary", "polyline"):
                np.testing.assert_array_equal(a[k], ja[k])
        img = cv2.imread(rec["file_name"])
        kw = dict(rotate=rotate, crop_enabled=True, crop_frac=(0.6, 0.6),
                  crop_instance=crop_instance, angle=45.0)
        out, annos = augment_pretrain_record(img, rec, np.random.RandomState(7), **kw)
        jout, jannos = jax_aug(img, jrec, np.random.RandomState(7), **kw)
        np.testing.assert_array_equal(out, jout)
        aug = {"height": out.shape[0], "width": out.shape[1], "annotations": annos}
        jaug = {"height": jout.shape[0], "width": jout.shape[1], "annotations": jannos}
        got, want = build_spotter_targets(aug, 4, 5, 37), jax_targets(jaug, 4, 5, 37)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cli_args(tmp_path, *extra, task="spotter"):
    return ["--config-file", CONFIG, "--cpu", "--task", task, "--max-iter", "2",
            "--opts", *TINY, "DATASETS.TRAIN", "('synth_port_pretrain',)",
            "OUTPUT_DIR", str(tmp_path / "out"), "INPUT.TRAIN_SIZE", "64",
            "SOLVER.CHECKPOINT_PERIOD", "2", "SEED", "3", *extra]


def test_train_net_cli_trains_and_writes_a_checkpoint(tmp_path):
    """``train_net.main`` on the CPU over a synthetic dataset: finite losses, a
    ``spotter_0000002.pth`` that loads back strictly into a fresh model, and moved
    parameters."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.models.gomatching import build_pretrain_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    register_dataset("synth_port_pretrain", *_write_dataset(tmp_path))
    history = train_net.main(_cli_args(tmp_path))
    assert len(history) == 2 and all(np.isfinite(h["total_loss"]) for h in history)
    assert all(h["step_s"] > h["data_s"] > 0 for h in history)
    ckpts = os.listdir(tmp_path / "out" / "checkpoints")
    assert ckpts == ["spotter_0000002.pth"]
    sd = load_checkpoint(str(tmp_path / "out" / "checkpoints" / ckpts[0]))
    cfg = setup_train_cfg(CONFIG, list(TINY))
    model = build_pretrain_model(cfg)
    load_weights(model, sd)
    init = init_state_dict(cfg, torch.Generator().manual_seed(3), pretrain=True)
    assert set(init) == set(sd)
    moved = [k for k in sd if not torch.equal(sd[k], init[k])]
    assert any(k.startswith("backbone.") for k in moved)
    assert any(k.startswith("detection_transformer.") for k in moved)


@pytest.mark.parametrize("extra", [
    ("--num-gpus", "2"),
    ("--resume",),
    ("--task", "tracker", "--num-gpus", "2"),
    ("--task", "tracker", "--opts", "MODEL.FREEZE_TYPE", "ExceptCascadeROIheads"),
])
def test_train_net_refuses_what_is_not_ported(tmp_path, extra):
    """What neither task ports raises NotImplementedError before any step: data
    parallelism (A12) for either task, --resume of pretraining, and for tracker training
    a freeze policy JAX rejects too (a cascade one)."""
    from gomatching_tpu_torch import train_net

    task = "spotter"
    if extra[:2] == ("--task", "tracker"):
        task, extra = "tracker", extra[2:]
    if extra[0] == "--opts":
        args = _cli_args(tmp_path, *extra[1:], task=task)
    else:
        args = list(extra) + _cli_args(tmp_path, task=task)
    with pytest.raises(NotImplementedError):
        train_net.main(args)


@pytest.mark.parametrize("task,opts", [
    ("tracker", ("MODEL.BACKBONE.NAME", "build_vitaev2_backbone")),
    ("spotter", ("MODEL.META_ARCHITECTURE", "TransformerPureVideoDetector")),
    ("spotter", ("MODEL.BACKBONE.NAME", "build_swin_backbone")),
    ("tracker", ("MODEL.FREEZE_TYPE", "ROIheads")),
])
def test_train_net_runs_what_was_refused(tmp_path, task, opts):
    """Tracker training on the ViTAEv2-S trunk and under FREEZE_TYPE ROIheads, video
    pretraining, and image pretraining on the Swin-T trunk (drop-path 0.2) each run one
    step at the tiny config on a synthetic dataset and write their checkpoints."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.datasets import register_dataset
    from test_torch_train_tracker_cli import TINY as TRACKER_TINY, _write_dataset as write_videos

    name = f"synth_port_now_ported_{task}_{opts[1]}"
    video = task == "tracker" or "Video" in opts[1]
    register_dataset(name, *(write_videos(tmp_path) if video else _write_dataset(tmp_path)))
    args = _cli_args(tmp_path, *(TRACKER_TINY if task == "tracker" else ()), *opts,
                     "DATASETS.TRAIN", f"('{name}',)", task=task)
    args[args.index("--max-iter") + 1] = "1"
    history = train_net.main(args)
    assert len(history) == 1 and np.isfinite(history[0]["total_loss"])
    prefix = "model_" if task == "tracker" else "spotter_"
    assert f"{prefix}0000001{'_rescore' if task == 'tracker' else ''}.pth" in os.listdir(
        tmp_path / "out" / "checkpoints")
