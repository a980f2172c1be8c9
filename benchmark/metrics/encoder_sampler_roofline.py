"""The encoder sampler's share of its roofline: for every call the least time its bytes
(value, offsets and logits read once, the output written once) or its taps allow
(``counts.encoder_sampler_bound_s``), summed, over the device time of the kernels
launched inside the benchmark's ``encoder_sampler`` span."""

from benchmark import counts


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "video" or tr is None or not rec.get("sampler_calls"):
        return None
    dev = tr["span_device_s"].get("encoder_sampler", 0.0)
    if dev <= 0:
        return None
    m = rec["model"]
    bound = sum(counts.encoder_sampler_bound_s(b, s, m, dt, rec["mem_bw"], rec["peak_flops"])
                for b, s, dt in rec["sampler_calls"])
    return 100.0 * bound / dev
