"""Kernels a frame launched inside the program's ``spot.call`` span (the spot call: decode,
preprocess, the model, NMS and the packing; ``records["program_trace"]``) over the frames
returned."""


def read(rec):
    pt = rec.get("program_trace")
    if rec.get("kind") != "video" or pt is None or not rec["frames"] or "spot.call" not in pt["spans"]:
        return None
    return pt["spans"]["spot.call"]["kernels"] / rec["frames"]
