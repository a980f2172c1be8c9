"""A tiny version of each video cell for the CPU tests: the cell's own files, with the
widths cut and small frames (the harness's code paths, not its sizes)."""

from __future__ import annotations

import os
import time

import torch

from benchmark import run

TINY_MODEL = {
    "hidden_dim": 64, "nheads": 2, "enc_layers": 1, "dec_layers": 1, "dim_feedforward": 64,
    "num_queries": 8, "num_points": 5, "asso_fc_dim": 64, "min_size_test": 64,
    "max_size_test": 128, "spot_batch": 2,
}
TINY_OPTS = [
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64", "MODEL.TRANSFORMER.NHEADS", "2",
    "MODEL.TRANSFORMER.ENC_LAYERS", "1", "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64", "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5", "MODEL.ASSO_HEAD.FC_DIM", "64",
    "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128", "TPU.SPOT_BATCH", "2",
]
TINY_TRAFFIC = {
    "video": {"frame_hw": [96, 128], "video_lengths": [7, 12, 15], "window_frames": 5,
              "kept_per_frame": 3, "sample_spot_calls": 3, "sample_assoc_calls": 3},
    "tracker_train": {"gt_per_frame": 3, "kept_per_frame": 3},
}
TINY_TRAIN = {"train_len": 3, "train_size": 64}
TINY_TRAIN_OPTS = ["INPUT.VIDEO.TRAIN_LEN", "3", "INPUT.TRAIN_SIZE", "64"]


def tiny_context(workload: str, seed: int = 1234567891, seconds: float = 2.0,
                 trace: bool = False) -> dict:
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    ctx = run.cell_context(workload, bench)
    ctx["model"] = dict(ctx["model"], **TINY_MODEL)
    job = ctx["traffic"]["job"]
    ctx["traffic"] = dict(ctx["traffic"], **TINY_TRAFFIC[job])
    opts = list(TINY_OPTS)
    if job == "tracker_train":
        ctx["config"] = dict(ctx["config"], train=dict(ctx["config"]["train"], **TINY_TRAIN))
        opts += TINY_TRAIN_OPTS
    ctx.update(seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
               t0=time.perf_counter(), extra_opts=opts,
               trace_dir=os.path.join(run.ROOT, "build", "benchmark_traces"))
    return ctx, bench
