"""The stream seconds of the program's device-timed spans as the per-layer metrics read
them: ``profiling.device_seconds`` (``gomatching_tpu_torch/utils/profiling.py``), the
summed time of a CUDA event pair around each span of ``DEVICE_TIMED`` that ran while a
profiler recorded (a run holds one profiler, the traced window's). A program without
them (before the trunk's spans) gives None, and so does a run without a CUDA device."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def device_seconds() -> Optional[Dict[str, float]]:
    try:
        from gomatching_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "device_seconds", None)
    return None if read is None else read()


def span_s(rec: Dict, name: str) -> Optional[float]:
    """Stream seconds of the program's span ``name`` in a video cell's traced window;
    None where nothing was recorded."""
    if rec.get("kind") != "video" or not rec.get("frames"):
        return None
    got = (device_seconds() or {}).get(name, 0.0)
    return got if got > 0 else None


def ms_per_frame(rec: Dict, name: str) -> Optional[float]:
    s = span_s(rec, name)
    return None if s is None else s * 1e3 / rec["frames"]


def peaks() -> Dict[str, float]:
    with open(PEAKS) as f:
        return json.load(f)
