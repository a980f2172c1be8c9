"""The port's ViTAEv2 trunk (models/vitae.py) against the benchmark's plain reference trunk
(benchmark/reference/trunks/vitaev2_s.py, written apart from the port), both at narrowed
widths on one seeded state_dict loaded into both by name: frame sides 0, 1, 2 and 3 mod 4
(which both pad with zeros to a multiple of 4) and stage-1 and stage-2 levels that need
padding to 7x7 windows. And the trunk's spans: under a profiler ``trunk``,
``trunk.global_attn`` and ``trunk.conv`` register one call each where expected, the counter
``trunk.global_attn.flops.float32`` gains 4 B h n^2 hd summed over the 'transformer'
cells, the attention part of the trunk file's operation count; CUDA event pairs are
recorded for those spans only while a profiler records.

Tolerance: float32, max |port - reference| <= 1e-5 of max |reference| per output. The two
compute the same equations in another order (the 1/sqrt(hd) scale before or after q k^T,
the windows laid out apart, NCHW or token layout between cells): rounding of ~1e-7
relative a step over the 14 cells and their sums, ~5e-7 observed.
"""

import pytest
import torch
import torch.nn as nn

from gomatching_tpu_torch.models.gomatching import MaskedBackbone, backbone_features
from gomatching_tpu_torch.models.vitae import ViTAEv2
from gomatching_tpu_torch.utils import profiling

TINY = dict(embed_dims=(8, 8, 16, 16), token_dims=(8, 16, 16, 32), rc_heads=(1, 1, 2, 4),
            nc_heads=(1, 2, 4, 8), rc_groups=(1, 2, 2, 4), nc_groups=(1, 4, 4, 8),
            nc_depths=(1, 1, 2, 1))
TRUNK_SPANS = ("trunk", "trunk.global_attn", "trunk.conv")
FLOPS = "trunk.global_attn.flops.float32"


def reference_trunk():
    from benchmark.reference import trunks

    return trunks.load("vitaev2_s")


def seeded_state_dict(module: nn.Module, seed: int) -> dict:
    """Every tensor drawn: kernels N(0, 1/fan_in), biases, norms and the frozen BN's
    statistics away from their identity values, so that each one counts."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in module.state_dict().items():
        r = torch.randn(v.shape, generator=g)
        if k.endswith("running_var"):
            r = 0.5 + r.abs()
        elif v.dim() > 1:
            r = r * v[0].numel() ** -0.5
        elif k.endswith("weight"):
            r = 1 + 0.2 * r
        else:
            r = 0.2 * r
        out[k] = r
    return out


@pytest.fixture(scope="module")
def pair():
    R = reference_trunk()
    ref = R.ViTAEv2(**dict(R.PUBLISHED, **TINY)).eval()
    port = ViTAEv2(**TINY).eval()
    sd = seeded_state_dict(ref, 5)
    ref.load_state_dict(sd, strict=True)
    port.load_state_dict(sd, strict=True)
    return R, ref, port


@pytest.mark.parametrize("hw", [(72, 100), (65, 93), (66, 98), (67, 71)])
def test_port_matches_the_plain_reference(pair, hw):
    """72x100 (0 mod 4): stage 1 is 18x25 tokens, padded by 1 + 2 rows and 1 + 2 columns to
    its windows, stage 2 9x13; 65x93 (1 mod 4), 66x98 (2 mod 4: ICDAR15's 1778 is), 67x71
    (3 mod 4): the same after the zero padding to 68x72."""
    R, ref, port = pair
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(hw[0] * hw[1]))
    with torch.no_grad():
        want = ref(x)
        got = port(x)
    _, sizes = R.operations(*hw, dict(R.PUBLISHED, **TINY))
    assert [tuple(t.shape[2:]) for t in want] == sizes
    for k, w in zip(("res3", "res4", "res5"), want):
        assert got[k].shape == w.shape, k
        err = ((got[k] - w).abs().max() / w.abs().max()).item()
        assert err <= 1e-5, (k, err)


def _trunk_call(port, x):
    return backbone_features(nn.Sequential(MaskedBackbone(port)), x.permute(0, 2, 3, 1), 32,
                             10000.0)


class FakeEvent:
    """Stands in for ``torch.cuda.Event`` on a host without CUDA: each pair reads 2 ms."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.recorded = False

    def record(self):
        self.recorded = True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 2.0


def test_spans_counter_and_events(pair, monkeypatch):
    R, _, port = pair
    monkeypatch.setattr(profiling, "_TRACED", {k: {} for k in profiling._KINDS})
    monkeypatch.setattr(profiling, "_PENDING", [])
    monkeypatch.setattr(profiling, "_DEVICE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made = 0
    b, hw = 2, (67, 99)
    x = torch.randn(b, 3, *hw)
    d = TINY["nc_depths"]
    calls = {"trunk": 1, "trunk.global_attn": 2 + d[2] + d[3], "trunk.conv": 4 + sum(d)}
    # the 'transformer' stages' levels: n tokens of token_dims channels (h * hd)
    _, sizes = R.operations(*hw, dict(R.PUBLISHED, **TINY))
    flops = b * sum(4 * (a * c) ** 2 * TINY["token_dims"][s] * (1 + d[s])
                    for s, (a, c) in zip((2, 3), sizes[1:]))
    assert flops == b * R.operations(*hw, dict(R.PUBLISHED, **TINY))[0]["global_attn"]

    # no profiler: host seconds, calls and the counter, no event
    snap = profiling.snapshot()
    with torch.no_grad():
        _trunk_call(port, x)
    got = profiling.since(snap)
    assert {k: got["calls"][k] for k in TRUNK_SPANS} == calls
    assert got["counts"] == {FLOPS: flops}
    assert FakeEvent.made == 0 and profiling.device_seconds() == {}
    assert profiling.snapshot(traced=True)["calls"] == {}

    # a profiler: the same, and one event pair a span
    traced = profiling.snapshot(traced=True)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _trunk_call(port, x)
        _trunk_call(port, x)
    got = profiling.since(traced, traced=True)
    assert got["calls"] == {k: 2 * n for k, n in calls.items()}
    assert got["counts"] == {FLOPS: 2 * flops}
    assert FakeEvent.made == 2 * 2 * sum(calls.values())
    dev = profiling.device_seconds()
    assert dev == {k: pytest.approx(2 * n * 2e-3) for k, n in calls.items()}
    assert profiling._PENDING == []
    # the counter only grows; the whole registry took all three calls
    assert profiling.snapshot()["counts"][FLOPS] >= 3 * flops
