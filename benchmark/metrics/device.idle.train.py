"""The share of the traced training window in which no kernel, copy or fill ran on the
device (``tracing.idle_share``; the inference cells' share is ``device.idle.infer``)."""

from benchmark.tracing import idle_share


def read(rec):
    return idle_share(rec, "train")
