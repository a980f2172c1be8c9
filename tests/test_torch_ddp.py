"""Data-parallel tracker training over spawned gloo ranks on the CPU: two ranks of one
clip each against the one-process ``step_multi`` of both clips, with dropout off and on,
the ranks' weights bit for bit; and ``dryrun_multigpu(2, "cpu")``. Each launch
rendezvouses through a file in ``tmp_path``. The CLI over two ranks is in
``test_torch_train_net_dp.py``. Last, a launch without a deadline outlasting the
group's collective timeout."""

import time

import numpy as np
import torch

import torch_dp_workers as workers
from test_torch_step_multi import _padded_clips
from test_torch_train_tracker_cli import CONFIG, TINY

# one step that moves the head: no warm-up, an LR of 1e-4
STEP = ["SOLVER.BASE_LR", "1e-4", "SOLVER.WARMUP_FACTOR", "1.0", "SEED", "2"]
RTOL = 1e-6


def _one_process(opts, clips):
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.train import Trainer

    tr = Trainer(setup_train_cfg(CONFIG, list(TINY) + STEP + list(opts)), device="cpu")
    metrics = tr.step_multi(clips)
    return metrics, tr.model.roi_heads.state_dict()


def test_two_ranks_equal_one_process_of_both_clips(tmp_path):
    """Two gloo ranks with one padded clip each give the one-process ``step_multi`` of
    both clips: every loss and every updated roi_heads tensor within RTOL, with dropout
    off and with ASSO_HEAD.DROPOUT 0.5 (each clip's masks seeded from (17, step, clip
    index over the ranks)). The two ranks' heads are the same bits, and with dropout and
    the same clip on both ranks their own losses differ: the ranks draw other masks."""
    from gomatching_tpu_torch.parallel.launch import launch

    _, _, _, clips = _padded_clips()
    variants = [("off", ["MODEL.ASSO_HEAD.DROPOUT", "0.0"], clips),
                ("on", ["MODEL.ASSO_HEAD.DROPOUT", "0.5"], clips),
                ("same_clip", ["MODEL.ASSO_HEAD.DROPOUT", "0.5"], [clips[0], clips[0]])]
    ranks = launch(workers.train_steps, 2, dist_url=f"file://{tmp_path / 'r'}",
                   args=(CONFIG, list(TINY) + STEP, variants), device="cpu", timeout_s=300)
    for name, extra, vclips in variants[:2]:
        metrics, head = _one_process(extra, vclips)
        a, b = (r[name] for r in ranks)
        assert a["digest"] == b["digest"], name
        for k in a["head"]:
            assert torch.equal(a["head"][k], b["head"][k]), (name, k)
            np.testing.assert_allclose(a["head"][k].numpy(), head[k].numpy(), rtol=RTOL,
                                       atol=RTOL * float(head[k].abs().max()), err_msg=k)
        assert a["metrics"] == b["metrics"]
        for k, v in metrics.items():
            np.testing.assert_allclose(a["metrics"][k], v, rtol=RTOL, err_msg=(name, k))
    same = [r["same_clip"]["local"][0] for r in ranks]
    assert same[0] != same[1]
    off = [r["off"]["local"][0] for r in ranks]
    assert off[0] != off[1]  # different clips


def test_dryrun_multigpu_on_the_cpu(tmp_path):
    from gomatching_tpu_torch.parallel.dryrun import dryrun_multigpu

    out = dryrun_multigpu(2, "cpu", dist_url=f"file://{tmp_path / 'd'}")
    assert [r["rank"] for r in out] == [0, 1]
    assert out[0]["metrics"] == out[1]["metrics"]
    assert np.isfinite(out[0]["metrics"]["total_loss"])


def test_a_launch_without_a_time_limit_outlasts_the_collective_timeout(tmp_path,
                                                                       monkeypatch):
    """A launch given no ``timeout_s`` has no deadline: ranks that run longer than the
    group's collective timeout (here cut to 6 s) outside a collective finish, where a
    deadline of that length would have killed them."""
    from gomatching_tpu_torch.parallel import launch as launch_mod

    monkeypatch.setattr(launch_mod, "DEFAULT_TIMEOUT_S", 6)
    t0 = time.monotonic()
    out = launch_mod.launch(workers.sleep_then_return, 2, dist_url=f"file://{tmp_path / 's'}",
                            args=(7,), device="cpu")
    assert out == ["finished", "finished"] and time.monotonic() - t0 > 7
