"""Host milliseconds a frame in the tracker (the batched short- and long-term passes,
each frame's step, the matcher on the device inside them): the benchmark's ``tracker``
span over the frames returned."""


def read(rec):
    if rec.get("kind") != "video" or not rec["frames"] or "tracker" not in rec["spans"]:
        return None
    return rec["spans"]["tracker"] * 1e3 / rec["frames"]
