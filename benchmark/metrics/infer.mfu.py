"""The inference step's share of the chip's peak in the configuration's dtype: the
benchmark's operation count of every frame's spot and every association pass, over the
window's wall time (``counts.py``; peaks in ``peaks.json``)."""


def read(rec):
    if rec.get("kind") != "video" or rec["window_s"] <= 0 or not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / rec["peak_flops"]
