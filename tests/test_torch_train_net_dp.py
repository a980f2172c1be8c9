"""``train_net.main --num-gpus 2 --cpu`` (two spawned gloo ranks, a ``file://``
rendezvous in ``tmp_path``): the data-parallel tracker loop's checkpoint, rank 0's
metrics, ``--resume`` with each rank's loader position, and the refusal of a state
written by another number of ranks. Rank 0 imports tensorboard in each run (~15 s on one
core where TensorFlow is installed), so this file holds the two runs alone."""

import json
import os

import numpy as np
import pytest

from test_torch_train_tracker_cli import CONFIG, TINY, _write_dataset


def _cli(tmp_path, data, out, *extra, max_iter=3, num_gpus="2"):
    return ["--config-file", CONFIG, "--cpu", "--task", "tracker", "--num-gpus", num_gpus,
            "--dist-url", f"file://{tmp_path / f'rdzv_{out}_{max_iter}'}",
            "--max-iter", str(max_iter), "--opts", *TINY, "DATASETS.TRAIN", f"('{data}',)",
            "OUTPUT_DIR", str(tmp_path / out), "INPUT.TRAIN_SIZE", "64",
            "SOLVER.CHECKPOINT_PERIOD", "3", "SEED", "3", *extra]


def test_train_net_two_ranks_checkpoint_and_resume(tmp_path):
    """``train_net.main --num-gpus 2 --cpu``: 3 iterations with finite losses; one
    checkpoint and one train state, holding both ranks' loader states; metrics.json with
    rank 0's one line (the averaged losses); ``--resume --max-iter 4`` continues at
    iteration 3, each rank from its own loader position (the saved one advanced by one
    clip); resuming that state with one rank is refused."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.loader import build_train_loader
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint, load_train_state

    root, js = _write_dataset(tmp_path)
    data = f"{root}::{js}"
    history = train_net.main(_cli(tmp_path, data, "out"))
    assert len(history) == 3 and all(np.isfinite(h["total_loss"]) for h in history)
    assert all(set(h["phase_t"]) == {"spot", "host", "update", "allreduce"} for h in history)
    ckpt = tmp_path / "out" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["model_0000003_rescore.pth", "state_0000003.pth"]
    load_checkpoint(str(ckpt / "model_0000003_rescore.pth"))
    lines = (tmp_path / "out" / "metrics.json").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["iteration"] == 3
    assert json.loads(lines[0])["total_loss"] == history[-1]["total_loss"]
    state = load_train_state(str(ckpt / "state_0000003.pth"))
    assert len(state["loaders"]) == 2 and state["loaders"][0] == state["loader"]
    assert state["loaders"][0] != state["loaders"][1]

    rest = train_net.main(["--resume"] + _cli(tmp_path, data, "out", max_iter=4))
    assert len(rest) == 1 and np.isfinite(rest[0]["total_loss"])
    after = load_train_state(str(ckpt / "state_0000004.pth"))
    assert after["step"] == 4
    cfg = setup_train_cfg(CONFIG, list(TINY) + ["DATASETS.TRAIN", f"('{data}',)",
                                                "INPUT.TRAIN_SIZE", "64", "SEED", "3"])
    for rank in (0, 1):
        loader = build_train_loader(cfg, rank, 2)
        loader.load_state_dict(state["loaders"][rank])
        next(iter(loader))
        assert loader.state_dict() == after["loaders"][rank], rank

    with pytest.raises(ValueError, match="written by 2 ranks"):
        train_net.main(["--resume"] + _cli(tmp_path, data, "out", max_iter=5, num_gpus="1"))
