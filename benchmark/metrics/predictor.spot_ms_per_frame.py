"""Host milliseconds a frame in the predictor's spot calls: the program's ``detector``
bucket (upload, the spot on the device, the packed copy back) over the frames returned."""


def read(rec):
    if rec.get("kind") != "video" or not rec["frames"]:
        return None
    return rec["time_cost"].get("detector", 0.0) * 1e3 / rec["frames"]
