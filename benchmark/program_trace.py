"""The program's own spans (``gomatching_tpu_torch/utils/profiling.py``) as the per-layer
metrics read them: its registry's sums over the traced window (``program``), and the
reduction of a traced window's Chrome trace by the program's spans (``reduce``).

A program span is a ``record_function`` range the program opens while a profiler records.
``reduce`` ties each device kernel, copy and fill to every program span open on the host
when it was launched (through the launch's correlation id), and each idle stretch of the
device to the innermost program span open on the host meanwhile.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

from .tracing import DEVICE_CATS, LAUNCH_CATS, WINDOW, _merge

OUTSIDE = "outside the program's spans"


def program(rec: Dict) -> Optional[Dict]:
    """The program's span seconds, calls and counts over a run's traced window: the job's
    record of them (``records["program"]``) where it keeps one, else the sums the program's
    registry recorded while a profiler recorded (a run holds one profiler, the traced
    window's); None where the program keeps no registry."""
    if rec.get("program") is not None:
        return rec["program"]
    try:
        from gomatching_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return None if snapshot is None else snapshot(traced=True)


def span_ms_per(rec: Dict, kind: str, names: Iterable[str], per: str) -> Optional[float]:
    """Host milliseconds in the program's spans ``names``, summed, over ``rec[per]`` (the
    frames or the steps of the window), for a ``kind`` cell; None without them."""
    p = program(rec)
    if rec.get("kind") != kind or not rec.get(per) or p is None:
        return None
    names = list(names)
    if not any(n in p["seconds"] for n in names):
        return None
    return sum(p["seconds"].get(n, 0.0) for n in names) * 1e3 / rec[per]


def _timeline(spans: List[Tuple[float, float, str]], w0: float, w1: float
              ) -> List[Tuple[float, float, Tuple[str, ...]]]:
    """[w0, w1] cut into stretches (start, end, the spans open, outermost first) from
    nested spans (start, end, name) of one thread."""
    segs: List[Tuple[float, float, Tuple[str, ...]]] = []
    stack: List[Tuple[float, str]] = []
    t = w0

    def emit(upto: float) -> None:
        nonlocal t
        upto = min(upto, w1)
        if upto > t:
            segs.append((t, upto, tuple(n for _, n in stack)))
            t = upto

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        emit(a)
        stack.append((b, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(w1)
    return segs


def reduce(path: str, names: Iterable[str]) -> Dict:
    """A Chrome trace with a ``window`` range -> for each program span in ``names``: the
    device seconds, kernels and copies launched while it was open (``device_s``,
    ``kernels``, ``copies``), and the device's idle seconds while it was the innermost
    program span open (``idle_s``); the idle seconds outside every program span
    (``idle_outside_s``), and the window's and busy seconds. Only the spans of the
    window's thread count; the idle seconds add up to the window's."""
    names = set(names)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev, launches, spans = [], {}, []
    for e in events:
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in names and e.get("tid") == tid:
            a = float(e["ts"])
            spans.append((a, a + float(e["dur"]), e["name"]))
    segs = _timeline(spans, w0, w1)
    starts = [s[0] for s in segs]
    out = {n: {"device_s": 0.0, "kernels": 0, "copies": 0, "idle_s": 0.0} for n in names}
    busy = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if min(b, w1) > max(a, w0):
            busy.append((max(a, w0), min(b, w1)))
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None or not w0 <= t < w1:
            continue
        for n in set(segs[bisect.bisect_right(starts, t) - 1][2]):
            o = out[n]
            o["device_s"] += float(e["dur"]) * 1e-6
            o["kernels"] += e["cat"] == "kernel"
            o["copies"] += e["cat"] == "gpu_memcpy"
    busy = _merge(busy)
    # the idle stretches, cut where the innermost open span changes
    idle = []
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    outside = 0.0
    i = 0
    for a, b in idle:
        while segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, open_ = segs[j]
            d = (min(b, s1) - max(a, s0)) * 1e-6
            if open_:
                out[open_[-1]]["idle_s"] += d
            else:
                outside += d
            j += 1
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s, "spans": out,
            "idle_outside_s": outside}
