"""The port's training-throughput tool (``gomatching_tpu_torch/tools/bench_train.py``):
``synth_clip`` draws JAX's clip (``tools/bench_train.synth_clip``) bit for bit; with
``--cpu`` at a tiny config the tracker mode and the ``--pretrain`` mode print their lines,
the tracker mode's first loss equals a direct ``Trainer.step`` on the same clip and its
timed iteration (the clip handed over as a tensor already on the device) equals a second
direct step on the numpy clip; ``--overlap`` raises, and so does a run without a card and
without ``--cpu``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from test_torch_train_tracker_cli import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_train", os.path.join(ROOT, "tools", "bench_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("t,h,w,npts,seed", [(4, 48, 40, 25, 0), (2, 33, 65, 5, 7)])
def test_synth_clip_matches_jax(t, h, w, npts, seed):
    from gomatching_tpu_torch.tools.bench_train import synth_clip

    want_img, want = _jax_tool().synth_clip(np.random.RandomState(seed), t, h, w, npts=npts)
    got_img, got = synth_clip(np.random.RandomState(seed), t, h, w, npts=npts)
    assert got_img.dtype == want_img.dtype == np.uint8 and np.array_equal(got_img, want_img)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]) == t
        for g, x in zip(got[k], want[k]):
            if k == "gt_texts":
                assert g == x
            else:
                assert g.dtype == x.dtype and np.array_equal(g, x), k


def _argv(*extra, opts=()):
    return ["--cpu", "--size", "64", "--frames", "2", "--iters", "1", *extra,
            "--opts", *TINY, *opts]


def test_tracker_mode_cpu(capsys):
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.tools import bench_train

    out = bench_train.main(_argv())["tracker"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("# tracker step: first step ") and "ms/iter" in lines[1]
    assert lines[2].startswith("#   split: upload ") and "spot" in lines[2]
    assert lines[3].startswith("# projected 30k iters: ") and "RTX 3090" in lines[3]
    assert lines[4].startswith("# peak device memory")
    assert out["hours_30k"] == pytest.approx(out["ms"] * 30000 / 3.6e6)
    assert sorted(out["split_ms"]) == ["host", "spot", "update"]

    cfg = setup_train_cfg(CONFIG, ["MODEL.WEIGHTS", "''"] + list(TINY))
    images, targets = bench_train.synth_clip(np.random.RandomState(0), 2, 64, 64, npts=5)
    hw = np.tile(np.asarray([64, 64], np.float32)[None], (2, 1))
    trainer = Trainer(cfg, device="cpu")
    first = trainer.step(images, hw, targets)
    second = trainer.step(images, hw, targets)
    assert np.isfinite(first["total_loss"]) and first["total_loss"] > 0
    assert out["first_loss"] == first["total_loss"]
    assert out["loss"] == second["total_loss"]


def test_pretrain_mode_cpu(capsys):
    from gomatching_tpu_torch.tools import bench_train

    out = bench_train.main(_argv("--pretrain", "--impl", "vmem",
                                 opts=("TPU.MAX_GT", "4")))["pretrain"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("# pretrain step [vmem: every --impl value runs the exact B1-B4")
    assert "ms/iter" in lines[1] and "64x64" in lines[1]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["loss"])
    assert out["impls"] == ["vmem"]


def test_overlap_and_missing_card_raise():
    from gomatching_tpu_torch.tools import bench_train

    with pytest.raises(ValueError, match="TPU transport"):
        bench_train.main(_argv("--overlap"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_train.main(["--iters", "1"])
