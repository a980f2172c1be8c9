"""The traced run: the benchmark's own spans, and the reduction of a ``torch.profiler``
trace to what the per-layer metrics read.

Spans are ``record_function`` ranges the benchmark opens around calls into the
program's layers (instance wrappers, installed only in a traced run); the window is the
span ``window``. Device time is that of kernels, copies and fills; a device kernel is
tied to the benchmark span that launched it through the launch's correlation id.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "window"


class Spans:
    """Host time and call counts of the benchmark's spans (perf_counter), beside the
    profiler's ranges of the same names."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def wrap(self, name: str, fn: Callable, on_call: Optional[Callable] = None) -> Callable:
        import time

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if on_call is not None:
                on_call(*args, **kwargs)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        return wrapped


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_trace(path: str, span_names: Tuple[str, ...]) -> Dict:
    """A Chrome trace -> window and busy seconds, kernel seconds by name, device
    seconds and calls of kernels launched inside each named span, and idle gaps named
    by the innermost benchmark span open on the host."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, launches, spans = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in span_names:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                          e.get("tid")))
    busy_iv, by_name = [], {}
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        busy_iv.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    merged = _merge(busy_iv)
    busy = sum(b - a for a, b in merged) * 1e-6
    # kernels launched inside each named span
    span_dev: Dict[str, float] = {}
    spans.sort()
    starts = [s[0] for s in spans]
    import bisect

    def innermost(t: float) -> Optional[str]:
        i = bisect.bisect_right(starts, t)
        best = None
        for s in reversed(spans[max(0, i - 64):i]):
            if s[0] <= t <= s[1] and (best is None or s[0] >= best[0]):
                best = s
        return None if best is None else best[2]

    for e in dev:
        corr = e.get("args", {}).get("correlation")
        t = launches.get(corr)
        if t is None:
            continue
        name = innermost(t)
        if name is not None:
            span_dev[name] = span_dev.get(name, 0.0) + float(e["dur"]) * 1e-6
    gaps: Dict[str, float] = {}
    prev = w0
    for a, b in merged + [(w1, w1)]:
        if a > prev:
            name = innermost((a + prev) / 2) or "outside the benchmark's spans"
            gaps[name] = gaps.get(name, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy,
            "kernel_s": sum(by_name.values()), "by_name": by_name,
            "span_device_s": span_dev, "gaps": gaps}


def profile_window(trace_dir: str):
    """A profiler over host and device whose trace goes to ``trace_dir``."""
    os.makedirs(trace_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(rec: Dict, kind: str) -> Optional[float]:
    """The share (%) of a traced window of a ``kind`` cell in which no kernel, copy or
    fill ran on the device; None for another kind of cell or an untraced run."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
