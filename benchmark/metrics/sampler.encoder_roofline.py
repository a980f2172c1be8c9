"""The encoder sampler's share of its roofline, from the program's spans: the least time
(``counts.encoder_sampler_bound_s``, linear in B x S) of the rows the program counted
(``sampler.encoder.rows.<dtype>``), over the device time of the kernels launched inside
its ``sampler.encoder`` span (``records["program_trace"]``). The program's twin of
``encoder_sampler_roofline``."""

from benchmark import counts
from benchmark.program_trace import program


def read(rec):
    pt, p = rec.get("program_trace"), program(rec)
    if rec.get("kind") != "video" or pt is None or p is None:
        return None
    dev = pt["spans"].get("sampler.encoder", {}).get("device_s", 0.0)
    prefix = "sampler.encoder.rows."
    rows = {k[len(prefix):]: n for k, n in p["counts"].items() if k.startswith(prefix)}
    if dev <= 0 or not rows:
        return None
    bound = sum(counts.encoder_sampler_bound_s(1, n, rec["model"], dt, rec["mem_bw"],
                                               rec["peak_flops"]) for dt, n in rows.items())
    return 100.0 * bound / dev
