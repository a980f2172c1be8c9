"""DeepSolo spotter pretraining step (port of ``gomatching_tpu/engine/pretrain.py``).

Parity: the training side of ``TransformerPureDetector``
(third_party/adet/modeling/text_spotter.py:106-265) as the JAX package runs it:
full-model AdamW with the backbone LR multiplier, SetCriterion losses over the final +
aux decoder layers + encoder proposals, full-model grad-norm clip.

One step: forward once; the cost matrices, detached, go to the host, where the port's
Hungarian solves them; the losses are computed from the same outputs with those
matches; backward (through the B3/B4 kernels on CUDA); clip; optimizer and LR schedule
step. (On an accelerator the JAX pretrainer runs the forward twice, once for the costs
and once with loss and gradient, because its TPU client has no host callbacks; the
math is the same.)
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.gomatching import build_pretrain_model
from ..weights import init_weights_, load_weights
from .optim import build_optimizer, clip_by_global_norm_, clip_max_norm
from .spotter_losses import SpotterCriterion, solve_padded


def build_spotter_targets(record: Dict, max_gt: int, num_points: int, voc_size: int):
    """Padded SpotterCriterion targets from one loaded dataset record
    (``data/datasets.py`` load_video_json fields), coordinates normalized to [0, 1].
    Returns a dict of (max_gt, ...) numpy arrays + 'valid'."""
    h, w = float(record["height"]), float(record["width"])
    annos = [a for a in record.get("annotations", []) if "beziers" in a]
    n = min(len(annos), max_gt)
    t_len = annos[0]["texts"].shape[0] if annos else 25
    out = {
        "valid": np.zeros((max_gt,), bool),
        "labels": np.zeros((max_gt,), np.int32),
        "ctrl_points": np.zeros((max_gt, num_points, 2), np.float32),
        "bd_points": np.zeros((max_gt, num_points, 4), np.float32),
        "texts": np.full((max_gt, t_len), voc_size, np.int32),
        "beziers": np.zeros((max_gt, 4, 2), np.float32),
    }
    wh = np.asarray([w, h], np.float32)
    for i, a in enumerate(annos[:n]):
        out["valid"][i] = True
        out["ctrl_points"][i] = np.asarray(a["polyline"], np.float32).reshape(num_points, 2) / wh
        out["bd_points"][i] = (np.asarray(a["boundary"], np.float32).reshape(num_points, 4)
                               / np.concatenate([wh, wh]))
        out["texts"][i] = a["texts"]
        out["beziers"][i] = np.asarray(a["beziers"], np.float32).reshape(4, 2) / wh
    return out


class SpotterPretrainer:
    """Full-model pretrainer (no freezing) on one device.

    ``device``: None runs on the current CUDA device and raises when there is none;
    pass ``"cpu"`` to run on the CPU. ``state_dict``: reference-keyed weights of the
    pretraining model; by default seeded random weights from ``generator`` (or
    ``SEED``, 0 when negative). ``stage_times``: when a dict, each step adds its host
    wall per stage to it, synchronizing the device at the stage boundaries.
    """

    def __init__(self, cfg, state_dict=None, device=None,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = build_pretrain_model(cfg)
        if state_dict is not None:
            load_weights(model, state_dict)
        else:
            gen = generator or torch.Generator().manual_seed(max(int(cfg.SEED), 0))
            init_weights_(model, gen)
        self.model = model.to(self.device).train()
        self.criterion = SpotterCriterion(cfg)
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.max_norm = clip_max_norm(cfg)
        self.stage_times: Optional[Dict[str, float]] = None

    def to_device(self, images: np.ndarray, targets: Dict) -> Tuple[torch.Tensor, Dict]:
        """(B, H, W, 3) normalized float images and padded numpy targets -> tensors."""
        dev = self.device
        imgs = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev)
        tg = {}
        for k, v in targets.items():
            v = np.asarray(v)
            t = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
            tg[k] = t.to(dev)
        return imgs, tg

    def _mark(self, stage: str, t0: float) -> float:
        if self.stage_times is None:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stage_times[stage] = self.stage_times.get(stage, 0.0) + now - t0
        return now

    def forward_backward(self, images: torch.Tensor, targets: Dict):
        """Forward, costs, host Hungarian, losses and backward; leaves the gradients in
        ``.grad``. Returns (losses incl. 'total_loss', as tensors; matches)."""
        t0 = time.perf_counter()
        out = self.model(images)
        t0 = self._mark("forward", t0)
        costs = {k: (c.cpu().numpy(), nv.cpu().numpy())
                 for k, (c, nv) in self.criterion.costs(out, targets).items()}
        t0 = self._mark("costs", t0)
        matches = {k: torch.from_numpy(solve_padded(c, nv)).to(self.device)
                   for k, (c, nv) in costs.items()}
        t0 = self._mark("hungarian", t0)
        losses = self.criterion(out, targets, num_inst=targets["valid"].sum().float(),
                                matches=matches)
        total = torch.stack(list(losses.values())).sum()
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        losses["total_loss"] = total
        self._mark("loss+backward", t0)
        return losses, matches

    def step(self, images: np.ndarray, targets: Dict) -> Dict[str, float]:
        """One full-model training step on host arrays; returns the float losses."""
        imgs, tg = self.to_device(images, targets)
        losses, _ = self.forward_backward(imgs, tg)
        t0 = time.perf_counter()
        if self.max_norm is not None:
            clip_by_global_norm_(self.model.parameters(), self.max_norm)
        self.optimizer.step()
        self.scheduler.step()
        values = torch.stack([v.detach() for v in losses.values()]).cpu().tolist()
        self._mark("clip+update", t0)
        return dict(zip(losses, values))
