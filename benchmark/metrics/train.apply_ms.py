"""Host milliseconds a step in applying the gradients: the program's ``update.apply`` span
(``Trainer.apply_gradients``: the zero fill of untouched gradients, the clip, AdamW and
the schedule) over the window's steps."""

from benchmark.program_trace import span_ms_per


def read(rec):
    return span_ms_per(rec, "train", ["update.apply"], "iters")
