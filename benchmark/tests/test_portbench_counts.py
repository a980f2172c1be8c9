"""The operation and byte counts against torch's own counter on the plain reference."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference.model import ReferenceModel, resize_hw
from benchmark.tests.tiny import TINY_MODEL
from benchmark.weights import make_state_dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "configs")) if f.endswith(".json"))


def model_of(config: str, tiny: bool = True) -> dict:
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        m = json.load(f)["model"]
    return dict(m, **TINY_MODEL) if tiny else m


@pytest.mark.parametrize("config", CONFIGS)
def test_spot_flops_match_the_counter(config):
    m = model_of(config)
    ref = ReferenceModel(m)
    ref.load_state_dict(make_state_dict(m, 7, "cpu"))
    h, w = resize_hw(96, 128, m["min_size_test"], m["max_size_test"])
    x = torch.randn(1, h, w, 3)
    with FlopCounterMode(display=False) as fc:
        enc = ref.encode(x)
        ref.decode(enc, ref.select(enc), (h, w))
    want = counts.spot_flops(h, w, m)
    assert fc.get_total_flops() == want["dense"]
    assert want["tokens"] == enc["memory"].shape[1]
    D = m["hidden_dim"] // m["nheads"]
    samples = (m["enc_layers"] * want["tokens"] * m["enc_n_points"]
               + m["dec_layers"] * m["num_queries"] * m["num_points"] * m["dec_n_points"])
    assert want["taps"] == samples * m["nheads"] * m["num_feature_levels"] * D * 10


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("short_term", [True, False])
def test_matcher_flops_match_the_counter(config, short_term):
    m = model_of(config)
    ref = ReferenceModel(m)
    ref.load_state_dict(make_state_dict(m, 7, "cpu"))
    n = 24
    tokens = torch.randn(1, n, m["asso_fc_dim"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.associate(tokens, torch.ones(1, n, dtype=torch.bool), short_term)
    assert fc.get_total_flops() == counts.matcher_flops(n, m, short_term)


def test_full_width_levels():
    m = model_of("gomatching-icdar15-r50", tiny=False)
    assert counts.level_shapes(1000, 1778, m) == [(125, 223), (63, 112), (32, 56), (16, 28)]
    assert counts.spot_flops(1000, 1778, m)["tokens"] == 37171
    m = model_of("gomatching-pp-dstext-r50", tiny=False)
    assert counts.spot_flops(1280, 2276, m)["tokens"] == 60640


@pytest.mark.parametrize("dtype,bound_ms", [("float32", 0.119), ("bfloat16", 0.0852)])
def test_encoder_sampler_bound(dtype, bound_ms):
    """Each input read once and the output written once over 3.35 TB/s, at B = 3 and
    S = 37171: 0.119 ms in f32 and 0.0852 ms in bf16 value."""
    m = model_of("gomatching-icdar15-r50", tiny=False)
    got = counts.encoder_sampler_bound_s(3, 37171, m, dtype, 3.35e12, 67e12) * 1e3
    assert got == pytest.approx(bound_ms, abs=5e-4)
