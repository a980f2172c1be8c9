"""Device milliseconds a frame in the trunk: the stream time of the program's ``trunk``
span (the trunk's call in ``backbone_features``, any trunk; CUDA events, idle inside the
span included) over the frames returned."""

from benchmark.program_device import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "trunk")
