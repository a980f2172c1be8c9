"""Host milliseconds a frame in NMS: the program's ``spot.nms`` span (``nms_mask`` in
``GoMatchingModel.detect``, its per-query steps launched from the host) over the frames
returned."""

from benchmark.program_trace import span_ms_per


def read(rec):
    return span_ms_per(rec, "video", ["spot.nms"], "frames")
