"""Data-parallel tracker training through ``train_net`` over N ranks, timed per rank.

    python -m gomatching_tpu_torch.tools.bench_dp --num-gpus 4 --max-iter 6 \\
        --data <image_root>::<json> [--cpu] [--config-file FILE] [--opts KEY VALUE ...]

Launches N processes (NCCL over N cards, or gloo on the CPU with ``--cpu``); each runs
``train_net.main --num-gpus N`` on the COCO-style video dataset ``--data`` with seeded
random weights and both proposal thresholds at 0.001 (random heads score ~0.01), and
reports per iteration its wall from taking the clip to the losses (``step_s``), the data
stage, the wait for the other ranks' clip sizes, the all-reduce's host wall, and its peak
device memory. ``train_net`` asserts at
its checkpoint that every rank holds the same weights. Prints one line per rank and, as
the last line, a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "GoMatching_ICDAR15.yaml")


def _rank(argv: List[str], cpu: bool) -> Dict:
    import torch

    from .. import train_net

    if not cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    history = train_net.main(argv)
    peak = None if cpu else torch.cuda.max_memory_allocated()
    return {"rank": torch.distributed.get_rank(), "peak_bytes": peak,
            "iterations": [{k: h[k] for k in ("step_s", "data_s", "wait_s", "frames",
                                               "image_hw", "total_loss")}
                           | {"allreduce_s": h["phase_t"]["allreduce"]} for h in history]}


def main(argv=None) -> Dict:
    from ..parallel.launch import launch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-gpus", type=int, default=2)
    p.add_argument("--max-iter", type=int, default=6)
    p.add_argument("--data", required=True, help="<image_root>::<json> of a video dataset")
    p.add_argument("--config-file", default=CONFIG)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    if a.num_gpus < 2:
        raise ValueError("--num-gpus: a data-parallel run needs at least 2 ranks")
    with tempfile.TemporaryDirectory(prefix="bench_dp_") as out:
        train_argv = ["--config-file", a.config_file, "--task", "tracker",
                      "--num-gpus", str(a.num_gpus), "--max-iter", str(a.max_iter),
                      *(["--cpu"] if a.cpu else []), "--opts", "MODEL.WEIGHTS", "''",
                      "SEED", "1", "DATASETS.TRAIN", f"('{a.data}',)", "OUTPUT_DIR", out,
                      "SOLVER.CHECKPOINT_PERIOD", str(a.max_iter),
                      "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", "0.001",
                      "MODEL.ASSO_HEAD.ASSO_THRESH", "0.001", *a.opts]
        ranks = launch(_rank, a.num_gpus, args=(train_argv, a.cpu),
                       device="cpu" if a.cpu else None)
    for r in ranks:
        its = r["iterations"]
        peak = "n/a" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.2f} GiB"
        print(f"rank {r['rank']}: ms/iter "
              + ", ".join(f"{x['step_s'] * 1e3:.1f}" for x in its)
              + "; data " + ", ".join(f"{x['data_s'] * 1e3:.1f}" for x in its)
              + "; wait " + ", ".join(f"{x['wait_s'] * 1e3:.1f}" for x in its)
              + "; all-reduce " + ", ".join(f"{x['allreduce_s'] * 1e3:.1f}" for x in its)
              + f"; frames {[x['frames'] for x in its]}; peak {peak}")
    # train_net raises at its checkpoint when the ranks' weights are not the same bits
    print(f"{a.num_gpus} ranks, {a.max_iter} iterations: the ranks' weights the same bits at "
          "the last iteration")
    summary = {"ranks": a.num_gpus, "iterations": a.max_iter,
               "losses": [x["total_loss"] for x in ranks[0]["iterations"]],
               "per_rank": ranks}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
