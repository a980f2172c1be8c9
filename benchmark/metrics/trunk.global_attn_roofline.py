"""The ViTAEv2 trunk's attention over whole levels (stages 3-4) as a share of its
roofline: the least time of the operations the program counted
(``trunk.global_attn.flops.<dtype>``: 4 B h n^2 hd a call, q k^T and the product with v)
at the dtype's peak (``peaks.json``), over the stream time of its ``trunk.global_attn``
spans (softmax(q k^T) v; CUDA events). Compute bounds it at every shape of the cells: n / 4
operations a byte, against a ridge of 20 in float32."""

from benchmark.program_device import peaks, span_s
from benchmark.program_trace import program

PREFIX = "trunk.global_attn.flops."


def read(rec):
    dev, p = span_s(rec, "trunk.global_attn"), program(rec)
    if dev is None or p is None:
        return None
    ops = {k[len(PREFIX):]: n for k, n in p["counts"].items() if k.startswith(PREFIX)}
    if not ops:
        return None
    peak = peaks()
    return 100.0 * sum(n / peak[dt] for dt, n in ops.items()) / dev
