"""Host milliseconds a step in the trainer's ``host`` phase (``Trainer.phase_t``, which
ends in a copy to the host), over the window's steps."""


def read(rec):
    if rec.get("kind") != "train" or not rec["iters"]:
        return None
    return rec["phase_s"]["host"] * 1e3 / rec["iters"]
