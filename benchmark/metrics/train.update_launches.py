"""Kernels a step launched inside the program's ``train.update`` span (the loss, backward,
the zero fill, the clip, AdamW; ``records["program_trace"]``) over the window's steps."""


def read(rec):
    pt = rec.get("program_trace")
    if (rec.get("kind") != "train" or pt is None or not rec["iters"]
            or "train.update" not in pt["spans"]):
        return None
    return pt["spans"]["train.update"]["kernels"] / rec["iters"]
