"""Run one cell of the port's benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration in
``benchmark/configs/<config>.json`` (whose ``model["backbone"]``, ``resnet`` where it is
absent, names the trunk: ``benchmark/reference/trunks/<backbone>.py``, which gives the
plain reference's trunk, the initialisers of its tensors, its operation count and the
port's trunk keys that are compared), its traffic in ``benchmark/traffic/<traffic>.json``
(which names the job: ``benchmark/jobs/<job>.py``), the limits of its comparison in
``benchmark/limits/<cell>.json`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (a window of at most
``TRACE_SECONDS`` under the profiler). The run needs as many CUDA devices as the cell
asks for and exits 1 without them; it exits 1 as well if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "gomatching_tpu")
TRACE_SECONDS = 10.0


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's (the
    whole name: ``gomatching_tpu_torch`` is not ``gomatching_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_context(workload: str, bench: dict) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return {"cell": cell, "config": config, "model": config["model"], "traffic": traffic,
            "limits": load_json(HERE, "limits", f"{workload}.json"),
            "peaks": load_json(HERE, "peaks.json")}


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run_cell(ctx: dict, bench: dict) -> dict:
    """Run the cell's job and build the result line (everything but the import check)."""
    workload = ctx["cell"]["name"]
    job = importlib.import_module(f"benchmark.jobs.{ctx['traffic']['job']}")
    res = job.run(ctx)
    checks = {}
    for key, limit in ctx["limits"].items():
        checks[key] = {"value": res["checks"][key], "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if ctx["trace"]:
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = metric_reader(m["name"])(res["records"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    device = ctx["device"]
    import torch

    line = {
        "correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]},
    }
    tr = res["records"].get("trace")
    if tr is not None:
        from benchmark.tracing import top

        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": top(tr["by_name"]), "idle_gaps": top(tr["gaps"])}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the repository root, not this folder, leads the path: ``benchmark.*`` and the port
    # import from there, and no module here shadows one of the standard library's
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    os.environ["USE_FLAX"] = "0"
    bench = load_json(ROOT, "BENCHMARK.json")
    ctx = cell_context(args.workload, bench)
    import torch

    chips = int(ctx["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    # a traced run profiles a window of at most TRACE_SECONDS: the trace of a longer one
    # takes minutes to write and read
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds
    ctx.update(seed=args.seed, seconds=seconds, trace=bool(args.trace),
               device=torch.device("cuda", 0), t0=T0,
               trace_dir=os.path.join(ROOT, "build", "benchmark_traces"))
    line = run_cell(ctx, bench)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules that must not load were loaded: {bad}", file=sys.stderr)
        return 1
    if line["device"]["platform"] == "gpu" and args.trace and not line["device"]["busy_s"] > 0:
        print("the traced window recorded no device time", file=sys.stderr)
        return 1
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
