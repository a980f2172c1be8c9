"""One data-parallel training step over ``n`` ranks at the tiny config: the port's
counterpart of ``__graft_entry__.dryrun_multichip`` (which stays the JAX package's).

    python -m gomatching_tpu_torch.parallel.dryrun [N] [--cpu]

On cards: NCCL over ``n`` cards; with ``device="cpu"``: ``n`` gloo processes. Every rank
builds the tiny tracker (JAX's tiny config with 2 heads of 32 channels, the samplers'
kernels' width) from one seed, takes one random clip of its own through
``Trainer.step_multi`` (the gradient averaged over the ranks) and reports its loss and
a digest of its trainable weights; the step must give a finite loss and the same weights,
bit for bit, on every rank.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "GoMatching_ICDAR15.yaml")
TINY = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "2",  # 32 channels a head, as the CUDA samplers take
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", "0.0001",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.ASSO_HEAD.ASSO_THRESH", "0.0001",
    "MODEL.WEIGHTS", "''",
]
T, H, W = 2, 32, 48  # JAX dryrun_multichip's clip


def _rank_step(device: Optional[str]) -> Dict:
    from ..config import setup_train_cfg
    from ..engine.train import Trainer
    from ..utils.synthetic import make_targets
    from .mesh import rank_and_world

    import torch.distributed as dist

    rank, world = rank_and_world()
    cfg = setup_train_cfg(CONFIG, list(TINY))
    trainer = Trainer(cfg, device=device, group=dist.group.WORLD)
    rng = np.random.RandomState(rank)
    clip = (rng.randn(T, H, W, 3).astype(np.float32), None, make_targets(T, npts=5))
    metrics = trainer.step_multi([clip])
    return {"rank": rank, "world": world, "metrics": metrics,
            "digest": trainer.replica_digest()}


def dryrun_multigpu(n: int, device: str = "cuda", dist_url: str = "auto") -> List[Dict]:
    """One data-parallel step over ``n`` ranks (NCCL on ``n`` cards, or gloo on the CPU
    with ``device="cpu"``); asserts a finite loss and trainable weights identical across
    the ranks; returns each rank's record."""
    from .launch import launch

    cpu = device == "cpu"
    out = launch(_rank_step, n, dist_url=dist_url, args=("cpu" if cpu else None,),
                 device="cpu" if cpu else None)
    for r in out:
        if not np.isfinite(r["metrics"]["total_loss"]):
            raise AssertionError(f"rank {r['rank']}: non-finite loss {r['metrics']}")
    if len({r["digest"] for r in out}) != 1:
        raise AssertionError("the ranks' trainable weights differ after the step")
    print(f"dryrun_multigpu({n}, {device}): OK, loss={out[0]['metrics']['total_loss']:.4f}, "
          "weights identical on every rank")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args()
    dryrun_multigpu(a.n, "cpu" if a.cpu else "cuda")
