"""Device milliseconds a frame: the traced window's kernel, copy and fill time over the
frames returned."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "video" or tr is None or not rec["frames"] or tr["kernel_s"] <= 0:
        return None
    return tr["kernel_s"] * 1e3 / rec["frames"]
