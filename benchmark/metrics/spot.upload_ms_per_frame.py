"""Host milliseconds a frame in getting the frames to the device: the program's
``spot.encode`` (``encode_i420`` under yuv420) and ``spot.upload`` (the copy from pageable
host memory) spans, summed, over the frames returned."""

from benchmark.program_trace import span_ms_per


def read(rec):
    return span_ms_per(rec, "video", ["spot.encode", "spot.upload"], "frames")
