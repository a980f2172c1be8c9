"""The port's spans (``gomatching_tpu_torch/utils/profiling.py``): with no profiler a span
opens no ``record_function`` and adds its seconds, calls and counts to the registry and
its bucket; under a CPU ``torch.profiler`` a tiny ``process_video`` and a tiny
``Trainer.step`` leave the program's ranges in the Chrome trace, named as ``SPANS`` and
nested as the code nests them; ``time_cost`` keeps the reference's keys, each filled by
its span, and ``phase_t`` the step's three phases, the update no shorter than its parts."""

import json
import os

import numpy as np
import pytest
import torch

from gomatching_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
TINY = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1", "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8", "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64", "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64", "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.ASSO_HEAD.NUM_HEADS", "4", "MODEL.WEIGHTS", "''",
]
# every proposal passes: the tracker and the matcher get work
PREDICT = TINY + ["MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.0001", "INPUT.MIN_SIZE_TEST", "64",
                  "INPUT.MAX_SIZE_TEST", "128", "TPU.SPOT_BATCH", "2",
                  "TPU.UPLOAD_FORMAT", "yuv420"]
TRAIN = TINY + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", "0.001",
                "MODEL.ASSO_HEAD.ASSO_THRESH", "0.001", "INPUT.TRAIN_SIZE", "64"]
# the program spans each span may lie in directly (None: in none)
PARENTS = {
    "stack": {None}, "spot.call": {None}, "spot.unpack": {None}, "track": {None}, "post": {None},
    "spot.encode": {"spot.call"}, "spot.upload": {"spot.call"},
    "spot.model": {"spot.call"}, "spot.readback": {"spot.call"}, "spot.nms": {"spot.model"},
    "sampler.encoder": {"spot.model", "train.spot"},
    "sampler.queries": {"spot.model", "train.spot"},
    "trunk": {"spot.model", "train.spot"},
    "trunk.global_attn": {"trunk"}, "trunk.conv": {"trunk"},
    "track.short": {"track", "track.step"}, "track.long": {"track", "track.step"},
    "track.step": {"track"}, "assoc": {"track.short", "track.long"},
    "train.spot": {None}, "train.host": {None}, "train.update": {None},
    "update.loss": {"train.update"}, "update.backward": {"train.update"},
    "update.apply": {"train.update"}, "update.readback": {"train.update"},
}
VITAE_SPANS = {"trunk.global_attn", "trunk.conv"}
FRAMES, WINDOW = 7, 4


def _frames(n=FRAMES):
    base = np.random.RandomState(0).randint(0, 255, (96, 128, 3), dtype=np.uint8)
    return [np.roll(base, 3 * t, axis=1) for t in range(n)]


@pytest.fixture(scope="module")
def program():
    from gomatching_tpu_torch.config import setup_eval_cfg, setup_train_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.tools.bench_train import synth_clip

    torch.manual_seed(0)
    predictor = VideoPredictor(setup_eval_cfg(CONFIG, PREDICT), device="cpu")
    trainer = Trainer(setup_train_cfg(CONFIG, TRAIN + ["SEED", "3"]), device="cpu")
    images, targets = synth_clip(np.random.RandomState(1), 2, 64, 64, npts=5)
    hw = np.tile(np.asarray([64, 64], np.float32)[None], (2, 1))
    return predictor, trainer, (images, hw, targets)


@pytest.fixture(scope="module")
def traced(program, tmp_path_factory):
    """One tiny video and one training step under a CPU profiler: the trace's program
    ranges, the video's ``time_cost`` and what the registry gained over each."""
    predictor, trainer, clip = program
    tc = profiling.new_time_cost()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        snap = profiling.snapshot()
        predictor.process_video(iter(_frames()), tc, window=WINDOW)
        video = profiling.since(snap)
        snap = profiling.snapshot()
        trainer.step(*clip)
        step = profiling.since(snap)
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") in profiling.SPANS]
    return {"events": events, "time_cost": tc, "video": video, "step": step,
            "phase_t": dict(trainer.phase_t)}


def test_span_opens_no_range_without_a_profiler(monkeypatch, program):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    snap, traced = profiling.snapshot(), profiling.snapshot(traced=True)
    bucket = {}
    for _ in range(3):
        with profiling.span("spot.call", bucket, "detector"):
            with profiling.span("spot.nms"):
                profiling.count("sampler.encoder.rows.float32", 5)
    with pytest.raises(ValueError):
        with profiling.StageTimer(bucket, "post_process"):
            raise ValueError("the span still closes")
    got = profiling.since(snap)
    assert got["calls"] == {"spot.call": 3, "spot.nms": 3, "post_process": 1}
    assert got["counts"] == {"sampler.encoder.rows.float32": 15}
    assert got["seconds"]["spot.call"] == pytest.approx(bucket["detector"], rel=1e-9, abs=1e-12)
    assert got["seconds"]["post_process"] == pytest.approx(bucket["post_process"], abs=1e-12)
    assert got["seconds"]["spot.call"] >= got["seconds"]["spot.nms"] > 0
    # the whole program, a video and a step, opens none either
    predictor, trainer, clip = program
    predictor.process_video(iter(_frames(3)), window=WINDOW)
    trainer.step(*clip)
    assert profiling.since(traced, traced=True) == {"seconds": {}, "calls": {}, "counts": {}}
    assert {"spot.nms", "sampler.encoder", "track", "update.apply"} <= set(
        profiling.since(snap)["calls"])


def test_trace_holds_the_program_spans_nested(traced):
    events = traced["events"]
    # the ResNet trunk opens no span of the ViTAEv2 trunk's (tests/test_torch_vitae_reference.py)
    assert {e["name"] for e in events} == set(profiling.SPANS) - VITAE_SPANS
    by_tid = {}
    for e in events:
        by_tid.setdefault(e["tid"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for spans in by_tid.values():
        for a, b, name in spans:
            around = [s for s in spans if s[0] <= a and b <= s[1] and s != (a, b, name)]
            parent = max(around, key=lambda s: (s[0], -s[1]))[2] if around else None
            assert parent in PARENTS[name], (name, parent)
    # each range in the trace is one call the registry counted
    calls = {n: sum(e["name"] == n for e in events) for n in set(profiling.SPANS) - VITAE_SPANS}
    got = {k: v for k, v in traced["video"]["calls"].items()}
    for k, v in traced["step"]["calls"].items():
        got[k] = got.get(k, 0) + v
    assert got == calls
    assert traced["video"]["calls"]["track.step"] == FRAMES
    assert traced["video"]["calls"]["spot.call"] == len(range(0, WINDOW, 2)) + len(
        range(0, FRAMES - WINDOW, 2))
    rows = traced["video"]["counts"]["sampler.encoder.rows.float32"]
    assert rows > 0 and rows % FRAMES == 0  # B x S over the calls: S tokens a frame


def test_time_cost_and_phase_t(traced):
    tc, sec = traced["time_cost"], traced["video"]["seconds"]
    assert list(tc) == list(profiling.STAGES)
    for key, name in [("pre_process", "stack"), ("detector", "spot.call"),
                      ("tracker", "track.step"), ("short_match", "track.short"),
                      ("long_match", "track.long"), ("post_process", "post")]:
        assert tc[key] == pytest.approx(sec[name], rel=1e-6), key
    for key in ("total_time", "backbone", "rescore"):
        assert tc[key] == 0.0
    phase, step = traced["phase_t"], traced["step"]["seconds"]
    assert list(phase) == ["spot", "host", "update"]
    for key in phase:
        assert phase[key] == pytest.approx(step[f"train.{key}"], rel=1e-6)
    parts = ["update.loss", "update.backward", "update.apply", "update.readback"]
    assert phase["update"] >= sum(step[p] for p in parts) > 0
