"""The harness end to end at a tiny size on the CPU: the result line, the run without a
card, and faults planted in the timed path that the comparison has to catch."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_context

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
VIDEO_CELLS = [w["name"] for w in BENCH["workloads"]
               if run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")["job"] == "video"]
# the share the affinities are moved by, by the matchers' precision
AFFINITY_SHARE = {"float32": 0.01, "bfloat16": 0.05}


def cell_model(workload: str) -> dict:
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    return run.load_json(run.HERE, "configs", f"{cell['config']}.json")["model"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(workload, **kw):
    ctx, bench = tiny_context(workload, **kw)
    return run.run_cell(ctx, bench)


@pytest.mark.parametrize("workload", VIDEO_CELLS)
def test_tiny_cell_line(workload):
    line = run_tiny(workload, seconds=1.5)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == list(json.load(open(os.path.join(
        run.HERE, "limits", f"{workload}.json"))))


def test_tiny_traced_line():
    line = run_tiny("icdar15-f32-video", seconds=1.5, trace=True)
    assert line["correct"] is True
    assert {"predictor.spot_ms_per_frame", "tracker.ms_per_frame", "infer.mfu"} <= set(
        line["metrics"])
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert list(line)[-1] == "checks" and "breakdown" in line


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(run.HERE, "run.py"), "--workload",
                           "icdar15-f32-video", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and "{" not in proc.stdout


def test_no_program_no_result(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark the run fails."""
    import shutil

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "icdar15-f32-video", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "{" not in proc.stdout


def _patch_spot(monkeypatch, fn):
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    orig = VideoPredictor.spot_batch_packed

    def spot(self, frames_u8, target_hw):
        return fn(self, orig, frames_u8, target_hw)

    monkeypatch.setattr(VideoPredictor, "spot_batch_packed", spot)


@pytest.mark.parametrize("workload", VIDEO_CELLS)
def test_half_the_batch_left_out(monkeypatch, workload):
    """Only the first half of each spot batch is computed; the rest repeats it."""
    def half(self, orig, frames_u8, target_hw):
        keep = max(1, len(frames_u8) // 2)
        out = orig(self, frames_u8[:keep], target_hw)
        return np.concatenate([out, np.repeat(out[-1:], len(frames_u8) - keep, 0)])

    _patch_spot(monkeypatch, half)
    ctx, bench = tiny_context(workload, seconds=1.5)
    # every spot call judged: a seeded sample of three from a short window can hold only
    # 1-frame calls, which the fault leaves as they are
    ctx["traffic"] = dict(ctx["traffic"], sample_spot_calls=10**9)
    assert run.run_cell(ctx, bench)["correct"] is False


@pytest.mark.parametrize("workload", VIDEO_CELLS)
def test_an_answer_altered(monkeypatch, workload):
    """Each spot call's first slot comes out altered: its score 0.05 higher and its reid
    embedding shifted by a fifth of the frame's largest reid value."""
    def altered(self, orig, frames_u8, target_hw):
        out = orig(self, frames_u8, target_hw).copy()
        out[:, 0, 0] += 0.05
        reid = out[:, :, -self.cfg.MODEL.ASSO_HEAD.FC_DIM:]
        reid[:, 0] += 0.2 * np.abs(reid).max()
        return out

    _patch_spot(monkeypatch, altered)
    line = run_tiny(workload, seconds=1.5)
    assert line["correct"] is False
    assert line["checks"]["reid_gap"]["value"] > line["checks"]["reid_gap"]["limit"]


@pytest.mark.parametrize("workload", VIDEO_CELLS)
def test_an_affinity_altered(monkeypatch, workload):
    """Every association call's logits are off by a share of their largest magnitude: 1%
    in an f32 cell, 5% in a bf16 one (whose limit, 1.2%, sits above bf16's rounding of
    the logits)."""
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    share = AFFINITY_SHARE[cell_model(workload)["assoc_precision"]]
    orig = VideoPredictor.associate

    def altered(self, *args, **kw):
        out = orig(self, *args, **kw)
        return out + share * np.abs(out).max()

    monkeypatch.setattr(VideoPredictor, "associate", altered)
    line = run_tiny(workload, seconds=1.5)
    assert line["correct"] is False
    assert line["checks"]["affinity_gap"]["value"] > line["checks"]["affinity_gap"]["limit"]


TRAIN_CELL = "icdar15-f32-tracker-train"


def test_tiny_train_line():
    line = run_tiny(TRAIN_CELL, seconds=1.5)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_ms_per_iter", "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line["checks"]) == list(json.load(open(os.path.join(
        run.HERE, "limits", f"{TRAIN_CELL}.json"))))


def test_tiny_train_traced_line():
    line = run_tiny(TRAIN_CELL, seconds=1.5, trace=True)
    assert line["correct"] is True
    assert {"train.spot_ms", "train.host_ms", "train.update_ms", "train.mfu"} <= set(
        line["metrics"])


def test_train_state_unchanged(monkeypatch):
    """The optimizer leaves the parameters as they were."""
    from gomatching_tpu_torch.engine.train import Trainer

    def frozen(self, losses):
        self.scheduler.step()
        self.step_count += 1
        return 0.0

    monkeypatch.setattr(Trainer, "apply_gradients", frozen)
    line = run_tiny(TRAIN_CELL, seconds=1.0)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > line["checks"]["change_gap"]["limit"]


def test_train_half_the_batch_left_out(monkeypatch):
    """The second half of each clip's frames gives no proposals to the losses."""
    from gomatching_tpu_torch.engine.train import Trainer

    orig = Trainer.prepare_batch

    def half(self, spot_out, targets, frame_valid=None):
        out = orig(self, spot_out, targets, frame_valid)
        T = out["prop_valid"].shape[0]
        out["prop_valid"][(T + 1) // 2:] = False
        return out

    monkeypatch.setattr(Trainer, "prepare_batch", half)
    assert run_tiny(TRAIN_CELL, seconds=1.0)["correct"] is False


def test_train_loss_altered(monkeypatch):
    """The reported loss is 1% off what was computed."""
    from gomatching_tpu_torch.engine.train import Trainer

    orig = Trainer.update

    def altered(self, batch, query_features):
        out = orig(self, batch, query_features)
        out["total_loss"] *= 1.01
        return out

    monkeypatch.setattr(Trainer, "update", altered)
    line = run_tiny(TRAIN_CELL, seconds=1.0)
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"]["limit"]


def _in_the_window(self) -> bool:
    """The step is one of the window's (set-up's checked steps come first)."""
    return self.step_count >= 3


@pytest.mark.parametrize("fault", ["state_unchanged", "loss_altered"])
def test_train_fault_inside_the_window_only(monkeypatch, fault):
    """A fault that begins after set-up's steps is caught by the stretch checked inside
    the window: the optimizer leaves the parameters as they were, or the reported loss
    is 1% off."""
    from gomatching_tpu_torch.engine.train import Trainer

    apply, update = Trainer.apply_gradients, Trainer.update

    def frozen(self, losses):
        if not _in_the_window(self):
            return apply(self, losses)
        self.scheduler.step()
        self.step_count += 1
        return 0.0

    def altered(self, batch, query_features):
        window = _in_the_window(self)
        out = update(self, batch, query_features)
        if window:
            out["total_loss"] *= 1.01
        return out

    if fault == "state_unchanged":
        monkeypatch.setattr(Trainer, "apply_gradients", frozen)
    else:
        monkeypatch.setattr(Trainer, "update", altered)
    line = run_tiny(TRAIN_CELL, seconds=1.5)
    key = {"state_unchanged": "change_gap", "loss_altered": "loss_gap"}[fault]
    assert line["correct"] is False
    assert line["checks"][key]["value"] > line["checks"][key]["limit"]
