"""Host milliseconds a frame at the end of each spot call: the program's ``spot.readback``
span (the packed detections' copy to the host, which waits for the device to finish the
batch) over the frames returned."""

from benchmark.program_trace import span_ms_per


def read(rec):
    return span_ms_per(rec, "video", ["spot.readback"], "frames")
