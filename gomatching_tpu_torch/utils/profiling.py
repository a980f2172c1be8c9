"""Tracing / profiling utilities (the port's copy of gomatching_tpu/utils/profiling.py,
and the port's spans).

The reference's hand-rolled wall-clock segmentation -- a ``time_cost`` dict with stage
buckets threaded through inference (reference eval.py:303-304, gom_lstmatcher.py:273-289)
plus per-video FPS prints -- and ``device_trace``, a ``torch.profiler`` Chrome trace of
the host and the CUDA device (the reference has no trace support).

The port's spans (``span``; every name in ``SPANS``) and counters (``count``:
``sampler.encoder.rows.<value dtype>``, B x S of each encoder sampler call, and
``trunk.global_attn.flops.<dtype>``, the operations of the two products of each
attention over a whole level of the ViTAEv2 trunk) add host seconds, calls and counts to
one registry of this module, which ``snapshot`` and ``since`` read. A span may also add
its seconds to a bucket (a ``time_cost`` or ``Trainer.phase_t`` dict). While a
``torch.profiler`` records, a span also opens ``torch.profiler.record_function(name)``,
so that its range lies in the Chrome trace on the clock of the kernels it launched; at
any other time it opens nothing, since an unrecorded ``record_function`` still costs
~10 us. There is no switch: tracing is on exactly while a profiler records
(``device_trace``, a benchmark's traced window).

The spans of ``DEVICE_TIMED`` also record a pair of CUDA events on the current stream
while a profiler records (and a CUDA device is present), and ``device_seconds`` gives
each such span's summed stream seconds: from when the stream reaches the span's start
(after the work queued before it) to when it reaches the span's end. That is the time
from the span's first kernel to its last one's end, idle inside the span included (where
the host launches slower than the device runs, it reads the host's pace). It stands in
for the device time of the kernels launched inside the span until the profiler's own
trace is read by span.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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

# every span the port opens (``spot.encode`` to ``spot.readback`` nest in ``spot.call``,
# ``spot.nms`` in ``spot.model``, the samplers' and ``trunk`` in ``spot.model`` or
# ``train.spot``, ``trunk.*`` in ``trunk``, the tracker's in ``track``, the update's parts
# in ``train.update``); none is named as a span of the benchmark's (``window``, ``spot``,
# ``host``, ``tracker``, ...)
SPANS = (
    "stack",            # a spot batch's frames stacked (time_cost pre_process)
    "spot.call",        # a spot call and its packed copy unpacked (time_cost detector)
    "spot.encode",      # encode_frames: encode_i420 on the host under yuv420
    "spot.upload",      # the frames' copy to the device
    "spot.model",       # decode, preprocess, the spot, detection and the packing
    "spot.nms",         # nms_mask in GoMatchingModel.detect
    "spot.readback",    # the packed copy to the host: the host waits for the device
    "spot.unpack",      # the batch's rows into each frame's FrameDetections
    "sampler.encoder",  # B2: the encoder sampler on the raw offsets and logits
    "sampler.queries",  # B1 or B5: a sampler on normalized locations
    "trunk",            # the trunk's call in backbone_features (any trunk)
    "trunk.global_attn",  # ViTAEv2: softmax(q k^T) v over a whole level (stages 3-4)
    "trunk.conv",       # ViTAEv2: the PRM and PCM convolution branches of a cell
    "track",            # a window's tracker work in process_video
    "track.short",      # short-term passes (time_cost short_match)
    "track.long",       # long-term passes (time_cost long_match)
    "track.step",       # Tracker.step of one frame (time_cost tracker)
    "assoc",            # one matcher call on the device (VideoPredictor.associate)
    "post",             # remove_short_tracks and the rescaling (time_cost post_process)
    "train.spot",       # Trainer: the frozen spot and its host fields (phase_t spot)
    "train.host",       # prepare_batch (phase_t host)
    "train.update",     # the update (phase_t update)
    "update.loss",      # the batch to the device and the loss forward
    "update.backward",  # backward
    "update.apply",     # apply_gradients: zero fill, clip, AdamW, the schedule
    "update.readback",  # the losses' copy to the host
)

# the spans whose stream time ``device_seconds`` gives
DEVICE_TIMED = ("trunk", "trunk.global_attn", "trunk.conv")

_KINDS = ("seconds", "calls", "counts")
_ALL: Dict[str, Dict[str, float]] = {k: {} for k in _KINDS}
_TRACED: Dict[str, Dict[str, float]] = {k: {} for k in _KINDS}
# (span, start event, end event) not yet read, and the stream seconds read from them
_PENDING: List[Tuple[str, object, object]] = []
_DEVICE: Dict[str, float] = {}


def _device_event(name: str):
    """A CUDA event recorded now on the current stream, for a span of ``DEVICE_TIMED``
    while a CUDA device is present; None otherwise."""
    if name not in DEVICE_TIMED or not torch.cuda.is_available():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class span:
    """A span of the program:

        with span("spot.nms"):
            ...work...

    adds its host seconds (``time.perf_counter``) and one call under ``name`` to the
    registry and, given a ``bucket`` dict, its seconds to ``bucket[key]`` (``key``
    defaults to ``name``); opens ``record_function(name)`` only while a profiler
    records, and for a span of ``DEVICE_TIMED`` a CUDA event pair then too."""

    __slots__ = ("name", "bucket", "key", "_t0", "_range", "_event")

    def __init__(self, name: str, bucket: Optional[Dict[str, float]] = None,
                 key: Optional[str] = None):
        self.name = name
        self.bucket = bucket
        self.key = name if key is None else key

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self._event = _device_event(self.name)
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        name = self.name
        regs = (_ALL,)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            regs = (_ALL, _TRACED)
            if self._event is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _PENDING.append((name, self._event, end))
        for reg in regs:
            sec, calls = reg["seconds"], reg["calls"]
            sec[name] = sec.get(name, 0.0) + dt
            calls[name] = calls.get(name, 0) + 1
        bucket = self.bucket
        if bucket is not None:
            bucket[self.key] = bucket.get(self.key, 0.0) + dt
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` to the registry's counter ``name``."""
    for reg in (_ALL, _TRACED) if _autograd_profiler._is_profiler_enabled else (_ALL,):
        counts = reg["counts"]
        counts[name] = counts.get(name, 0) + n


def snapshot(traced: bool = False) -> Dict[str, Dict[str, float]]:
    """The registry's sums since the process started: ``{"seconds": {span: s}, "calls":
    {span: n}, "counts": {counter: n}}``. ``traced``: only what was recorded while a
    profiler recorded (the spans whose ranges a trace holds)."""
    reg = _TRACED if traced else _ALL
    return {k: dict(reg[k]) for k in _KINDS}


def since(snap: Dict[str, Dict[str, float]], traced: bool = False) -> Dict[str, Dict[str, float]]:
    """What the registry gained since ``snap`` (a ``snapshot`` of the same ``traced``)."""
    now = snapshot(traced)
    return {k: {n: v - snap[k].get(n, 0) for n, v in now[k].items() if v != snap[k].get(n, 0)}
            for k in _KINDS}


def device_seconds() -> Dict[str, float]:
    """The stream seconds of each span of ``DEVICE_TIMED`` since the process started,
    summed over what was recorded while a profiler recorded (the module docstring says
    what they hold); waits for the device to finish the spans recorded so far."""
    for name, start, end in _PENDING:
        end.synchronize()
        _DEVICE[name] = _DEVICE.get(name, 0.0) + start.elapsed_time(end) * 1e-3
    _PENDING.clear()
    return dict(_DEVICE)


def new_time_cost() -> Dict[str, float]:
    """Fresh stage-bucket dict with the reference's keys (eval.py:303-304)."""
    return {k: 0.0 for k in STAGES}


class StageTimer(span):
    """A span that accumulates wall-clock into a time_cost bucket named as itself:

        with StageTimer(tc, "detector"):
            ...work...
    """

    __slots__ = ()

    def __init__(self, time_cost: Dict[str, float], stage: str):
        super().__init__(stage, time_cost)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the host and, when a CUDA device is present, the
    device, written as a Chrome trace to ``<log_dir>/trace.json`` when ``log_dir`` is
    set; no-op otherwise. View it in chrome://tracing or Perfetto; the port's spans are
    its ``user_annotation`` ranges."""
    if not log_dir:
        yield
        return
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
