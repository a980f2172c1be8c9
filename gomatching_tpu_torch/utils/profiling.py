"""Tracing / profiling utilities (the port's copy of gomatching_tpu/utils/profiling.py).

The reference's hand-rolled wall-clock segmentation -- a ``time_cost`` dict with stage
buckets threaded through inference (reference eval.py:303-304, gom_lstmatcher.py:273-289)
plus per-video FPS prints -- and ``device_trace``, a ``torch.profiler`` Chrome trace of
the host and the CUDA device (the reference has no trace support).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


STAGES = (
    "total_time",
    "pre_process",
    "backbone",
    "detector",
    "rescore",
    "tracker",
    "long_match",
    "short_match",
    "post_process",
)


def new_time_cost() -> Dict[str, float]:
    """Fresh stage-bucket dict with the reference's keys (eval.py:303-304)."""
    return {k: 0.0 for k in STAGES}


class StageTimer:
    """Accumulates wall-clock into a time_cost bucket:

        with StageTimer(tc, "detector"):
            ...work...
    """

    def __init__(self, time_cost: Dict[str, float], stage: str):
        self.tc = time_cost
        self.stage = stage

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.tc[self.stage] = self.tc.get(self.stage, 0.0) + time.time() - self.t0
        return False


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the host and, when a CUDA device is present, the
    device, written as a Chrome trace to ``<log_dir>/trace.json`` when ``log_dir`` is
    set; no-op otherwise. View it in chrome://tracing or Perfetto."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def fps_report(time_cost: Dict[str, float], n_frames: int) -> str:
    """The reference's aggregate print (eval.py:382-383)."""
    total = time_cost.get("total_time", 0.0)
    fps = n_frames / total if total > 0 else 0.0
    return f"total_time: {total:.2f} FPS: {fps:.2f}"
