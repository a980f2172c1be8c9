"""The per-layer metrics that read the program's own spans: ``program_trace.reduce`` on a
hand-built Chrome trace, each reader on a synthetic record and without one (as on a
program that keeps no span registry), and a tiny traced cell of each kind on the CPU,
whose line carries the metrics that read the program's registry."""

import json

import pytest
import torch

from benchmark import counts, program_trace, run
from benchmark.tests.tiny import tiny_context

PROGRAM = ("spot.call", "spot.model", "spot.nms", "track")
PROGRAM_SPAN_METRICS = {
    "track.ms_per_frame": "video", "spot.nms_ms_per_frame": "video",
    "spot.upload_ms_per_frame": "video", "spot.readback_ms_per_frame": "video",
    "train.apply_ms": "train",
}
TRACE_METRICS = {"sampler.encoder_roofline": "video", "spot.launches_per_frame": "video",
                 "train.update_launches": "train"}


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace(tmp_path):
    """A 100 us window: spot.call [10, 60] holding spot.model [20, 50] holding spot.nms
    [30, 40]; track [65, 90]; the device busy [0, 45], [55, 80], [92, 100]."""
    ev = [_x("window", "user_annotation", 0, 100), _x("spot.call", "user_annotation", 10, 50),
          _x("spot.model", "user_annotation", 20, 30), _x("spot.nms", "user_annotation", 30, 10),
          _x("track", "user_annotation", 65, 25),
          # another thread's range, and a range that is not the program's, count for nothing
          _x("spot.nms", "user_annotation", 40, 60, tid=2),
          _x("spot_batch", "user_annotation", 0, 100)]
    # (correlation, launched at, device start, duration, category)
    for corr, t, a, d, cat in [(1, 2, 0, 20, "kernel"), (2, 15, 20, 10, "kernel"),
                               (3, 25, 30, 8, "kernel"), (4, 35, 38, 7, "kernel"),
                               (5, 52, 55, 15, "gpu_memcpy"), (6, 68, 70, 10, "kernel"),
                               (7, 91, 92, 8, "kernel")]:
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t, 1, correlation=corr))
        ev.append(_x(f"k{corr}", cat, a, d, tid=7, correlation=corr))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_reduce_by_program_span(tmp_path):
    got = program_trace.reduce(_trace(tmp_path), PROGRAM)
    us = pytest.approx
    assert got["window_s"] == us(100e-6) and got["busy_s"] == us(78e-6)
    s = got["spans"]
    # what was launched while each span was open, at any depth
    assert (s["spot.call"]["device_s"], s["spot.call"]["kernels"], s["spot.call"]["copies"]) == (
        us(40e-6), 3, 1)
    assert (s["spot.model"]["device_s"], s["spot.model"]["kernels"]) == (us(15e-6), 2)
    assert (s["spot.nms"]["device_s"], s["spot.nms"]["kernels"]) == (us(7e-6), 1)
    assert (s["track"]["device_s"], s["track"]["kernels"], s["track"]["copies"]) == (
        us(10e-6), 1, 0)
    # the idle [45, 55] and [80, 92], by the innermost span open
    assert s["spot.model"]["idle_s"] == us(5e-6) and s["spot.call"]["idle_s"] == us(5e-6)
    assert s["track"]["idle_s"] == us(10e-6) and s["spot.nms"]["idle_s"] == 0
    assert got["idle_outside_s"] == us(2e-6)
    idle = sum(v["idle_s"] for v in s.values()) + got["idle_outside_s"]
    assert idle == us(got["window_s"] - got["busy_s"])


def test_reduce_needs_a_window(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("spot.call", "user_annotation", 0, 1)]}))
    with pytest.raises(RuntimeError, match="no window"):
        program_trace.reduce(str(path), PROGRAM)


def test_program_spans_are_not_the_benchmarks():
    """A program span named as one of the benchmark's own ranges would be read as both."""
    from benchmark.jobs import tracker_train, video
    from benchmark.tracing import WINDOW
    from gomatching_tpu_torch.utils import profiling

    theirs = set(video.SPAN_NAMES) | set(tracker_train.SPAN_NAMES) | {WINDOW}
    assert not set(profiling.SPANS) & theirs


def _model():
    return run.load_json(run.HERE, "configs", "gomatching-icdar15-r50.json")["model"]


def _records():
    peaks = run.load_json(run.HERE, "peaks.json")
    video = {
        "kind": "video", "frames": 10, "model": _model(), "mem_bw": peaks["mem_bw"],
        "peak_flops": peaks["float32"],
        "program": {"seconds": {"track": 0.05, "spot.nms": 0.02, "spot.encode": 0.01,
                                "spot.upload": 0.005, "spot.readback": 0.03},
                    "calls": {}, "counts": {"sampler.encoder.rows.float32": 2 * 3 * 37171}},
        "program_trace": {"spans": {"sampler.encoder": {"device_s": 2e-3, "kernels": 2},
                                    "spot.call": {"device_s": 0.4, "kernels": 500}}},
    }
    train = {"kind": "train", "iters": 4,
             "program": {"seconds": {"update.apply": 0.04}, "calls": {}, "counts": {}},
             "program_trace": {"spans": {"train.update": {"device_s": 0.3, "kernels": 800}}}}
    return video, train


def test_readers_on_synthetic_records():
    video, train = _records()
    m = video["model"]
    bound = counts.encoder_sampler_bound_s(3, 37171, m, "float32", video["mem_bw"],
                                           video["peak_flops"])
    want = {"track.ms_per_frame": 5.0, "spot.nms_ms_per_frame": 2.0,
            "spot.upload_ms_per_frame": 1.5, "spot.readback_ms_per_frame": 3.0,
            "spot.launches_per_frame": 50.0, "train.apply_ms": 10.0,
            "train.update_launches": 200.0,
            "sampler.encoder_roofline": 100.0 * 2 * bound / 2e-3}
    for name, kind in {**PROGRAM_SPAN_METRICS, **TRACE_METRICS}.items():
        rec = video if kind == "video" else train
        assert run.metric_reader(name)(rec) == pytest.approx(want[name]), name
        # the other kind of cell reads nothing
        assert run.metric_reader(name)(train if kind == "video" else video) is None, name


def test_readers_without_their_records(monkeypatch):
    """No record and no span registry in the program (as at a commit before the
    program's spans): every reader returns None and raises nothing."""
    from gomatching_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    video, train = _records()
    for name, kind in {**PROGRAM_SPAN_METRICS, **TRACE_METRICS}.items():
        rec = dict(video if kind == "video" else train)
        del rec["program"], rec["program_trace"]
        assert run.metric_reader(name)(rec) is None, name


@pytest.fixture
def fresh_traced_registry(monkeypatch):
    """A registry of traced sums of this test alone (a benchmark run holds one profiler;
    this process may have run others)."""
    from gomatching_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_TRACED", {k: {} for k in profiling._KINDS})
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["icdar15-f32-video", "icdar15-f32-tracker-train"])
def test_tiny_traced_line_reads_the_program(fresh_traced_registry, workload):
    ctx, bench = tiny_context(workload, seconds=1.5, trace=True)
    line = run.run_cell(ctx, bench)
    assert line["correct"] is True
    kind = "train" if "train" in workload else "video"
    mine = {n for n, k in PROGRAM_SPAN_METRICS.items() if k == kind}
    assert mine <= set(line["metrics"])
    assert all(line["metrics"][n]["value"] > 0 for n in mine)
    if kind == "video":
        # the program's span holds the benchmark's wrapped tracker calls
        assert (line["metrics"]["track.ms_per_frame"]["value"]
                >= line["metrics"]["tracker.ms_per_frame"]["value"])
    else:
        assert (line["metrics"]["train.apply_ms"]["value"]
                <= line["metrics"]["train.update_ms"]["value"])
