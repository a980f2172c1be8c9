"""The port's tracker-training data path, matcher dropout and CLI: ClipMapper and the
video clip loader against the JAX package's on a synthetic dataset (same seed, same
clips and GT), ASSO_HEAD.DROPOUT's placement and seeding, and ``train_net --task
tracker`` on the CPU (metrics, checkpoints, resume, the freeze partition)."""

import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
TINY = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.ASSO_HEAD.NUM_HEADS", "4",
    "MODEL.WEIGHTS", "''",
    # random heads score ~0.01-0.5: every proposal passes both thresholds
    "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", "0.001",
    "MODEL.ASSO_HEAD.ASSO_THRESH", "0.001",
]


def _write_dataset(root, n_frames=10, hw=(72, 96)):
    """One video of ``n_frames`` frames with two text instances drifting 2-3 px a frame
    (and an untracked one), and one still image with one instance (a pseudo-video of one
    frame)."""
    import cv2

    rng = np.random.RandomState(0)
    images, annotations = [], []

    def add(img_id, fn, x0, y0, inst, **extra):
        annotations.append({"id": len(annotations) + 1, "image_id": img_id, "category_id": 1,
                            "bbox": [x0, y0, 30, 14],
                            "poly": [x0, y0, x0 + 30, y0 + 1, x0 + 30, y0 + 14, x0, y0 + 13],
                            "transcription": "ab1", "instance_id": inst, **extra})

    for fi in range(n_frames):
        fn = f"f{fi}.jpg"
        cv2.imwrite(str(root / fn), rng.randint(0, 255, (*hw, 3), np.uint8))
        images.append({"id": fi + 1, "file_name": fn, "height": hw[0], "width": hw[1],
                       "video_id": 7})
        add(fi + 1, fn, 6 + 3 * fi, 10, 101)
        add(fi + 1, fn, 40 - 2 * fi, 40, 102)
        add(fi + 1, fn, 50, 5, 0)
    cv2.imwrite(str(root / "still.jpg"), rng.randint(0, 255, (*hw, 3), np.uint8))
    images.append({"id": 100, "file_name": "still.jpg", "height": hw[0], "width": hw[1]})
    add(100, "still.jpg", 20, 30, 201)
    path = root / "train.json"
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "text"}]}))
    return str(root), str(path)


def _assert_same_clip(got, want):
    assert got.image_hw == want.image_hw and len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a, b)
    for field in ("gt_boxes", "gt_ids", "gt_texts", "gt_ctrl", "gt_boundary", "gt_beziers"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("path", ["dynamic_scale", "gen_image_motion"])
def test_clip_mapper_matches_jax(tmp_path, path):
    """ClipMapper gives JAX's clips and GT for the same seed: on the video (random
    window and stride, DYNAMIC_SCALE growing the clip past TRAIN_LEN) or on the still
    image (GEN_IMAGE_MOTION), four draws in a row."""
    from gomatching_tpu.data.datasets import group_by_video as jax_group
    from gomatching_tpu.data.datasets import load_video_json as jax_load
    from gomatching_tpu.data.mapper import ClipMapper as JaxMapper
    from gomatching_tpu_torch.data.datasets import group_by_video, load_video_json
    from gomatching_tpu_torch.data.mapper import ClipMapper

    root, js = _write_dataset(tmp_path)
    videos = group_by_video(load_video_json(js, root, 5))
    jvideos = jax_group(jax_load(js, root, 5))
    assert sorted(videos) == sorted(jvideos) == [-1, 7]
    key = 7 if path == "dynamic_scale" else -1
    kw = dict(train_size=64, scale_range=(0.1, 1.2), train_len=3, num_points=5, seed=11)
    mapper, jmapper = ClipMapper(**kw), JaxMapper(**kw)
    lengths = []
    for _ in range(4):
        got, want = mapper(videos[key]), jmapper(jvideos[key])
        _assert_same_clip(got, want)
        lengths.append(len(got.images))
    if path == "dynamic_scale":
        assert max(lengths) > 3  # the downsized clips grew
        assert any(len(g) for g in got.gt_ids)
    else:
        assert lengths == [3] * 4


def test_loader_matches_jax_and_resumes(tmp_path):
    """build_train_loader gives JAX's clip sequence over the video and the still image
    for the same SEED; its state_dict, restored into a fresh loader, continues the
    sequence exactly."""
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu.data.datasets import register_dataset as jax_register
    from gomatching_tpu.data.loader import build_train_loader as jax_loader
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.data.loader import build_train_loader

    data = _write_dataset(tmp_path)
    register_dataset("synth_port_tracker_loader", *data)
    jax_register("synth_port_tracker_loader", *data)
    opts = [*TINY, "DATASETS.TRAIN", "('synth_port_tracker_loader',)", "INPUT.TRAIN_SIZE", "64",
            "SEED", "5"]
    loader = build_train_loader(setup_train_cfg(CONFIG, opts))
    jit = iter(jax_loader(jax_cfg(CONFIG, opts)))
    it = iter(loader)
    for _ in range(3):
        _assert_same_clip(next(it), next(jit))
    state = json.loads(json.dumps(loader.state_dict()))  # plain values only
    resumed = build_train_loader(setup_train_cfg(CONFIG, opts))
    resumed.load_state_dict(state)
    rit = iter(resumed)
    for _ in range(3):
        want = next(jit)
        _assert_same_clip(next(it), want)
        _assert_same_clip(next(rit), want)


def _head(dropout, seed=0, variant="lst"):
    from gomatching_tpu_torch.models.lst_matcher import LSTMatcherHead
    from gomatching_tpu_torch.weights import init_weights_

    head = LSTMatcherHead(hidden_dim=16, num_points=3, feature_dim=32, num_heads=4,
                          variant=variant, dropout=dropout, dropout_seed=seed)
    return init_weights_(head, torch.Generator().manual_seed(1))


def test_dropout_active_in_training_inert_at_inference():
    """ASSO_HEAD.DROPOUT acts only in ``associate(..., train=True)`` of a head in
    ``train()`` mode, adds no state_dict key, and draws the same masks from the same
    seed (other masks from another)."""
    g = torch.Generator().manual_seed(2)
    tokens = torch.randn(1, 10, 32, generator=g)
    valid = torch.arange(10)[None] < 8
    plain = _head(0.0).eval()
    want = plain.associate(tokens, valid, False)
    head = _head(0.1)
    assert set(head.state_dict()) == set(plain.state_dict())
    assert sum(p.numel() for p in head.parameters()) == sum(p.numel() for p in plain.parameters())
    head.load_state_dict(plain.state_dict())
    head.eval()
    assert torch.equal(head.associate(tokens, valid, False, train=True), want)
    head.train()
    assert torch.equal(head.associate(tokens, valid, False), want)
    a = head.associate(tokens, valid, False, train=True)
    b = head.associate(tokens, valid, False, train=True)
    assert not torch.equal(a, want) and not torch.equal(a, b)
    again = _head(0.1)
    again.load_state_dict(plain.state_dict())
    again.train()
    assert torch.equal(again.associate(tokens, valid, False, train=True), a)
    other = _head(0.1, seed=1)
    other.load_state_dict(plain.state_dict())
    other.train()
    assert not torch.equal(other.associate(tokens, valid, False, train=True), a)


@pytest.mark.parametrize("variant,short_term,shapes", [
    # encoder layer then decoder layer: attention probabilities, dropout1, FFN inside,
    # dropout2 (roi_heads/transformer.py:191-207, :264-287)
    ("lst", True, [(1, 4, 6, 6), (1, 6, 32), (1, 6, 32), (1, 6, 32)] * 2),
    # GoMatching++: one decoder layer without FFN
    ("shared", False, [(1, 4, 6, 6), (1, 6, 32)]),
])
def test_dropout_placement(variant, short_term, shapes):
    """Each dropout of a pass, in order, at the places the reference's nn.Dropout
    modules sit; each drop zeroes entries and scales the rest by 1 / (1 - p)."""
    head = _head(0.5, variant=variant).train()
    seen = []
    make = head._dropout_fn

    def counting(device):
        drop = make(device)

        def f(x):
            y = drop(x)
            kept = y != 0
            assert torch.allclose(y[kept], 2 * x[kept]) and (~kept).any()
            seen.append(tuple(x.shape))
            return y
        return f

    head._dropout_fn = counting
    tokens = torch.randn(1, 6, 32, generator=torch.Generator().manual_seed(3))
    head.associate(tokens, torch.ones(1, 6, dtype=torch.bool), short_term, train=True)
    assert seen == shapes


def _cli_args(tmp_path, out, *extra, max_iter=2):
    return ["--config-file", CONFIG, "--cpu", "--task", "tracker", "--max-iter", str(max_iter),
            "--opts", *TINY, "DATASETS.TRAIN", "('synth_port_tracker',)",
            "OUTPUT_DIR", str(tmp_path / out), "INPUT.TRAIN_SIZE", "64",
            "SOLVER.CHECKPOINT_PERIOD", "2", "SEED", "3", *extra]


@pytest.fixture
def dataset(tmp_path):
    from gomatching_tpu_torch.data.datasets import register_dataset

    register_dataset("synth_port_tracker", *_write_dataset(tmp_path))


def test_tracker_cli_trains_only_roi_heads(tmp_path, dataset):
    """``train_net.main --task tracker --cpu`` for 2 iterations: finite losses, proposals
    and matched tracks, a metrics.json line with JAX's keys, config.yaml, a
    ``model_0000002_rescore.pth`` that loads back strictly and a train state; against
    the seeded initial weights (the rescoring head copied from the spotter classifier)
    only ``roi_heads.*`` tensors moved, all of them."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import latest_train_state, load_checkpoint
    from gomatching_tpu_torch.models.gomatching import build_model
    from gomatching_tpu_torch.weights import init_state_dict, load_weights

    # no warm-up, so that each head tensor's first updates exceed its float32 spacing
    history = train_net.main(_cli_args(tmp_path, "out", "SOLVER.WARMUP_FACTOR", "1.0"))
    assert len(history) == 2 and all(np.isfinite(h["total_loss"]) for h in history)
    assert all(h["step_s"] > h["data_s"] > 0 and set(h["phase_t"]) == {"spot", "host", "update"}
               for h in history)
    assert all(h["proposals"] > 0 for h in history) and any(h["matched"] for h in history)
    out = tmp_path / "out"
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert len(lines) == 1 and lines[0]["iteration"] == 2
    assert {"iteration", "lr", "data_time", "time", "loss_res", "loss_long_asso",
            "loss_short_asso", "total_loss"} == set(lines[0])
    assert (out / "config.yaml").exists()
    assert latest_train_state(str(out / "checkpoints"))[1] == 2
    sd = load_checkpoint(str(out / "checkpoints" / "model_0000002_rescore.pth"))
    cfg = setup_train_cfg(CONFIG, list(TINY))
    load_weights(build_model(cfg), sd)
    init = train_net.init_rescoring_from_classifier(
        init_state_dict(cfg, torch.Generator().manual_seed(3)))
    assert set(sd) == set(init)
    moved = {k for k in sd if not torch.equal(sd[k], init[k])}
    assert moved == {k for k in sd if k.startswith("roi_heads.")}


def test_tracker_cli_resume_equals_uninterrupted(tmp_path, dataset):
    """2 iterations, then ``--resume`` for a third, end at the same weights, optimizer
    moments and losses as 3 iterations in one run (dropout off): the train state holds
    the head, AdamW, the schedule and the loader's position."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint, load_train_state

    off = ["MODEL.ASSO_HEAD.DROPOUT", "0.0"]
    full = train_net.main(_cli_args(tmp_path, "full", *off, max_iter=3))
    train_net.main(_cli_args(tmp_path, "split", *off, max_iter=2))
    rest = train_net.main(["--resume"] + _cli_args(tmp_path, "split", *off, max_iter=3))
    assert len(rest) == 1
    for k in ("total_loss", "loss_res", "loss_long_asso", "loss_short_asso", "frames"):
        assert rest[0][k] == full[2][k], k
    ckpt = "checkpoints/model_0000003_rescore.pth"
    a, b = (load_checkpoint(str(tmp_path / d / ckpt)) for d in ("full", "split"))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = (load_train_state(str(tmp_path / d / "checkpoints/state_0000003.pth"))
              for d in ("full", "split"))
    assert sa["step"] == sb["step"] == 3 and sa["loader"] == sb["loader"]
    for i, st in sa["optimizer"]["state"].items():
        assert torch.equal(st["exp_avg"], sb["optimizer"]["state"][i]["exp_avg"])


@pytest.mark.parametrize("uint8", [True, False])
def test_tracker_cli_training_wire(tmp_path, dataset, monkeypatch, uint8):
    """TPU.TRAIN_UPLOAD_UINT8 as JAX reads it (train_net.py:344-350): True sends the
    clip as uint8 with each frame's true size, so the spotter sees the padding masks;
    False sends host-normalized float32 and no size, so nothing is masked."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.engine.train import Trainer

    seen = []
    spot = Trainer.spot

    def record(self, images, image_hw=None):
        seen.append((images.dtype, image_hw))
        return spot(self, images, image_hw)

    monkeypatch.setattr(Trainer, "spot", record)
    history = train_net.main(_cli_args(tmp_path, "out", "TPU.TRAIN_UPLOAD_UINT8", str(uint8),
                                       max_iter=1))
    assert len(history) == 1 and np.isfinite(history[0]["total_loss"])
    (dtype, hw), = seen
    if uint8:
        assert dtype == np.uint8 and hw.shape == (history[0]["frames"], 2)
    else:
        assert dtype == np.float32 and hw is None


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_tracker_cli_starts_from_weights(tmp_path, dataset, fmt):
    """MODEL.WEIGHTS naming a torch checkpoint or the JAX package's .npz params: the
    frozen tensors come through one step unchanged, and the rescoring head starts from
    the spotter classifier (the path names no ``_rescore`` checkpoint)."""
    import sys

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint
    from gomatching_tpu_torch.weights import init_state_dict

    cfg = setup_train_cfg(CONFIG, list(TINY))
    sd = init_state_dict(cfg, torch.Generator().manual_seed(9))
    path = str(tmp_path / f"weights.{fmt}")
    if fmt == "pth":
        torch.save({"model": sd}, path)
    else:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        from convert_torch_weights import convert

        from gomatching_tpu.config import setup_train_cfg as jax_cfg
        from gomatching_tpu.engine.checkpoint import save_params

        params, missing, _ = convert({k: v.numpy() for k, v in sd.items()},
                                     jax_cfg(CONFIG, list(TINY)))
        assert not missing
        save_params(path, params)
    train_net.main(_cli_args(tmp_path, "out", "MODEL.WEIGHTS", path, max_iter=1))
    got = load_checkpoint(str(tmp_path / "out" / "checkpoints" / "model_0000001_rescore.pth"))
    assert set(got) == set(sd)
    for k in sd:
        if not k.startswith("roi_heads."):
            assert torch.equal(got[k], sd[k]), k
    for leaf in ("weight", "bias"):
        cls = sd[f"detection_transformer.ctrl_point_class.0.{leaf}"]
        head = got[f"roi_heads.rescoring_head.{leaf}"]
        assert torch.allclose(head, cls, atol=1e-6)  # one step at the warm-up LR
        assert not torch.allclose(sd[f"roi_heads.rescoring_head.{leaf}"], cls, atol=1e-6)
