"""The readings that a cell's limits are set from: the program's comparison readings
over many seeds and its control's (the reference put in the program's place one
precision lower), each at the cell's own size and load over a short window, in one
process. Prints one JSON line a run and a summary: per reading the program's largest
and the control's smallest value.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 8]

Needs a CUDA device. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, control: bool, seconds: float, device=None) -> list:
    import torch

    from benchmark import check_train, check_video, run

    bench = run.load_json(ROOT, "BENCHMARK.json")
    out = []
    for seed in seeds:
        ctx = run.cell_context(workload, bench)
        ctx.update(seed=int(seed), seconds=seconds, trace=False,
                   device=device or torch.device("cuda", 0), t0=time.perf_counter(),
                   trace_dir=os.path.join(ROOT, "build", "benchmark_traces"))
        video = ctx["traffic"]["job"] == "video"
        if control:
            ctx["control"] = check_video.control_answers if video else check_train.control_steps
        # every reading the comparison makes, those the cell holds under its limits and
        # the others
        keys = check_video.READINGS + ("frames_missing",) if video else check_train.READINGS
        ctx["limits"] = {k: ctx["limits"].get(k, float("inf")) for k in keys}
        line = run.run_cell(ctx, bench)
        row = {"seed": int(seed), "control": control, "correct": line["correct"],
               "readings": {k: c["value"] for k, c in line["checks"].items()},
               "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != os.path.join(ROOT, "benchmark")]
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    split = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    prog = readings(args.workload, split(args.seeds), False, args.seconds)
    ctrl = readings(args.workload, split(args.control_seeds), True, args.seconds)
    keys = list((prog or ctrl)[0]["readings"])
    summary = {k: {"program_max": max((r["readings"][k] for r in prog), default=None),
                   "control_min": min((r["readings"][k] for r in ctrl), default=None)}
               for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
