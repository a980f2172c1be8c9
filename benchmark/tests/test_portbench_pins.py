"""What the harness reads, pinned, one file of ``pins/`` a configuration: the seeded
state_dict at the configuration's full widths (every key in order, its shape and two
float64 checksums, so that the one ``randn`` draw and its split are pinned too),
``spot_flops`` at the video cells' model inputs and, for a configuration that trains, the
training job's counts of a step. ``measure`` took them on the tree before the trunks
became files of their own; how the reference, the weights and the counts are put
together may change, what they give may not."""

import os

import numpy as np
import pytest

from benchmark import counts, run
from benchmark.jobs.tracker_train import train_step_flops
from benchmark.weights import make_state_dict

PINS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pins")
CONFIGS = sorted(f[:-5] for f in os.listdir(PINS) if f.endswith(".json"))
SEED = 2147483659  # above 2**31, as the driver's seeds are
MODEL_INPUTS = [(1000, 1778), (1280, 2276)]


def checksums(t) -> list:
    """The plain and a position-weighted float64 sum of a tensor's elements."""
    x = t.detach().cpu().double().numpy().reshape(-1)
    w = np.arange(1, x.size + 1, dtype=np.float64) / max(x.size, 1)
    return [float(x.sum()), float((x * w).sum())]


def measure(config: str, state_dict: bool) -> dict:
    cfg = run.load_json(run.HERE, "configs", f"{config}.json")
    m = cfg["model"]
    if state_dict:
        sd = make_state_dict(m, SEED, "cpu")
        return {"state_dict": [[k, list(v.shape)] + checksums(v) for k, v in sd.items()]}
    out = {"spot_flops": {f"{h}x{w}": counts.spot_flops(h, w, m) for h, w in MODEL_INPUTS}}
    if "train" in cfg:
        T, size = int(cfg["train"]["train_len"]), int(cfg["train"]["train_size"])
        out["train"] = {"spot_flops": counts.spot_flops(size, size, m),
                        "step_flops": train_step_flops(m, T, size)}
    return out


def pinned(config: str) -> dict:
    return run.load_json(PINS, f"{config}.json")


@pytest.mark.parametrize("config", CONFIGS)
def test_state_dict_pinned(config):
    want = pinned(config)["state_dict"]
    got = measure(config, True)["state_dict"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    bad = [(g[0], g[2:], w[2:]) for g, w in zip(got, want) if g[2:] != w[2:]]
    assert not bad, bad[:5]


@pytest.mark.parametrize("config", CONFIGS)
def test_counts_pinned(config):
    want = {k: v for k, v in pinned(config).items() if k != "state_dict"}
    assert measure(config, False) == want
