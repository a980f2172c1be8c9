"""The share of the traced inference window in which no kernel, copy or fill ran on the
device (``tracing.idle_share``; the training cells' share is ``device.idle.train``)."""

from benchmark.tracing import idle_share


def read(rec):
    return idle_share(rec, "video")
