"""The training step's share of the chip's peak in the configuration's dtype: the
benchmark's operation count of a step (``jobs/tracker_train.train_step_flops``) times
the window's steps, over its wall time."""


def read(rec):
    if rec.get("kind") != "train" or rec["window_s"] <= 0 or not rec["iters"]:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / rec["peak_flops"]
