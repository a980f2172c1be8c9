"""Device milliseconds a frame in the ViTAEv2 trunk's convolution branches: the stream
time of the program's ``trunk.conv`` spans (each cell's PRM and PCM with their layout
changes; CUDA events) over the frames returned."""

from benchmark.program_device import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "trunk.conv")
