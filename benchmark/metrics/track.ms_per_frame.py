"""Host milliseconds a frame in the tracker, timed by the program: its ``track`` span (a
window's batched short- and long-term passes and each frame's step, in
``VideoPredictor.process_video``) over the frames returned. The program's twin of
``tracker.ms_per_frame``."""

from benchmark.program_trace import span_ms_per


def read(rec):
    return span_ms_per(rec, "video", ["track"], "frames")
