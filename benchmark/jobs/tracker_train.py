"""Tracker training: ``Trainer.step`` back to back on seeded clips held on the host.

Set-up: the configuration, seeded weights on the device, the trainer, the proposal
thresholds (the fused-score quantile that keeps ``kept_per_frame`` of the queries, on the
reference's spot of the first clip), a pool of seeded uint8 RGB clips with their GT, and
the first ``checked_steps`` steps, one on each of the first clips, through the window's
own call: they warm every shape up, and what they do is what the comparison checks
(each step's loss, the first step's gradient as AdamW holds it, the head's change over
the steps). The window then runs ``Trainer.step`` on the pool's clips in turn, each
uploaded from the host as a loader would hand it over, until ``seconds`` have passed;
``train_ms_per_iter`` is the window's wall time over its steps.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import check_train, counts, tracing
from ..reference.model import ReferenceModel
from ..reference.train import normalize, spot
from ..weights import make_state_dict
from .video import check_cfg

SPAN_NAMES = ("spot", "host", "update")


def synth_clip(rng, t: int, h: int, w: int, npts: int, n_inst: int):
    """A random uint8 clip (t, h, w, 3) and GT shaped like the video mapper's: per frame
    ``n_inst`` boxes with straight-line control points, normalized; instance ids from 1,
    as the video mapper numbers them."""
    images = rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    gt_ctrl, gt_boxes, gt_ids = [], [], []
    for _ in range(t):
        cx, cy = rng.uniform(0.15, 0.85, n_inst), rng.uniform(0.15, 0.85, n_inst)
        bw, bh = rng.uniform(0.05, 0.2, n_inst), rng.uniform(0.03, 0.08, n_inst)
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)
        s = np.linspace(0, 1, npts, dtype=np.float32)
        ctrl = np.stack([boxes[:, None, 0] + s[None] * (boxes[:, 2] - boxes[:, 0])[:, None],
                         np.broadcast_to(((boxes[:, 1] + boxes[:, 3]) / 2)[:, None],
                                         (n_inst, npts))], -1).astype(np.float32)
        gt_ctrl.append(ctrl)
        gt_boxes.append(boxes)
        gt_ids.append(np.arange(1, n_inst + 1, dtype=np.int64))  # dense ids from 1
    return images, {"gt_ctrl": gt_ctrl, "gt_boxes": gt_boxes, "gt_ids": gt_ids}


def port_cfg(config: Dict, seed: int, extra_opts=()):
    from gomatching_tpu_torch.config import setup_train_cfg

    port = config["port"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    opts = list(port["opts"]) + list(config["train"]["opts"]) + ["SEED", str(seed % 2**31)]
    return setup_train_cfg(os.path.join(root, port["config_file"]), opts + list(extra_opts))


def check_train_cfg(cfg, tr: Dict) -> None:
    """The trainer's settings are the ones the configuration file states."""
    s, a, t = cfg.SOLVER, cfg.MODEL.ASSO_HEAD, cfg.MODEL.TRANSFORMER
    got = {
        "freeze_type": cfg.MODEL.FREEZE_TYPE, "asso_dropout": a.DROPOUT,
        "train_len": cfg.INPUT.VIDEO.TRAIN_LEN, "train_size": cfg.INPUT.TRAIN_SIZE,
        "upload_uint8": bool(cfg.TPU.TRAIN_UPLOAD_UINT8),
        "upload_format": cfg.TPU.TRAIN_UPLOAD_FORMAT,
        "solver": {"base_lr": s.BASE_LR, "weight_decay": s.WEIGHT_DECAY,
                   "warmup_iters": s.WARMUP_ITERS, "warmup_factor": s.WARMUP_FACTOR,
                   "max_iter": s.MAX_ITER, "clip": s.CLIP_GRADIENTS.CLIP_VALUE,
                   "scheduler": s.LR_SCHEDULER_NAME, "optimizer": s.OPTIMIZER},
        "loss": {"focal_alpha": t.LOSS.FOCAL_ALPHA, "focal_gamma": t.LOSS.FOCAL_GAMMA,
                 "asso_weight": a.ASSO_WEIGHT, "asso_weight_local": a.ASSO_WEIGHT_LOCAL,
                 "neg_unmatched": bool(a.NEG_UNMATCHED)},
    }
    bad = {k: (v, tr.get(k)) for k, v in got.items() if tr.get(k) != v}
    if bad:
        raise ValueError(f"the trainer's configuration differs from the benchmark's: {bad}")


def train_step_flops(m: Dict, T: int, size: int) -> int:
    """One step: the frozen spot of the clip (no reid), then the head's forward and
    backward (counted as three forwards): rescoring, reid of every slot, the long pass
    over all T x nq slots and the T - 1 short passes over two frames' slots."""
    nq, npts, C = m["num_queries"], m["num_points"], m["hidden_dim"]
    fc = m["asso_fc_dim"]
    reid = 2 * nq * (npts * C * fc + (m["asso_num_fc"] - 1) * fc * fc)
    spot_f = counts.spot_flops(size, size, m)["total"] - reid
    head = T * reid + (2 * T * nq * npts * C if m["with_rescore"] else 0)
    head += counts.matcher_flops(T * nq, m, False) + (T - 1) * counts.matcher_flops(2 * nq, m, True)
    return T * spot_f + 3 * head


class Stretch:
    """A stretch of checked steps: the trainer's state where it starts (copies of the
    head's parameters and AdamW's moments) and, per step, what the program produced: its
    reference points and host fields (through the trainer's recording wrappers), its
    batch and loss; AdamW's first moment after the first step, and the head's change
    over the stretch."""

    def __init__(self, name: str, trainer, pool, step: int, n: int):
        self.name, self.trainer, self.pool, self.n = name, trainer, pool, n
        self.named = dict(trainer.model.named_parameters())
        self.start = dict(self._state(), step=step)
        self.clips: list = []
        self.kept = {"ref_points": [], "host": [], "batch": [], "loss": []}
        trainer.bench_kept = self.kept

    def _state(self) -> Dict:
        st = self.trainer.optimizer.state
        out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
        for n in self.trainer.trainable_names:
            p = self.named[n]
            out["params"][n] = p.detach().clone()
            for key in ("exp_avg", "exp_avg_sq"):
                # a leaf the optimizer holds no state for has none yet
                out[key][n] = st[p][key].detach().clone() if key in st[p] else torch.zeros_like(p)
        return out

    def stepped(self, out: Dict, clip: int) -> bool:
        """Keep one step's loss and batch; True once the stretch is complete."""
        k = self.kept
        k["loss"].append(out["total_loss"])
        k["batch"].append(self.trainer.last_batch)
        self.clips.append(clip)
        st = self.trainer.optimizer.state
        if len(k["loss"]) == 1:
            # the first moment after the step is b1 x the one before + (1 - b1) x the
            # clipped gradient
            k["grad"] = {}
            for n in self.trainer.trainable_names:
                p = self.named[n]
                m1 = st[p]["exp_avg"].detach() if "exp_avg" in st[p] else torch.zeros_like(p)
                k["grad"][n] = (m1 - 0.9 * self.start["exp_avg"][n]) / (1 - 0.9)
        if len(k["loss"]) < self.n:
            return False
        k["change"] = {n: self.named[n].detach() - self.start["params"][n]
                       for n in self.trainer.trainable_names}
        self.trainer.bench_kept = None
        return True

    def to_host(self) -> None:
        """Move the copies to the host (the set-up stretch's, before the window)."""
        move = lambda d: {n: v.cpu() for n, v in d.items()}  # noqa: E731
        self.start = {k: (move(v) if isinstance(v, dict) else v) for k, v in self.start.items()}
        self.kept["grad"], self.kept["change"] = move(self.kept["grad"]), move(self.kept["change"])

    def judged(self, device, from_seed: bool) -> Dict:
        """The stretch as ``check_train.readings`` takes it; ``from_seed``: the reference
        starts from the seed's weights, else from the copied state."""
        pool = self.pool
        return {"name": self.name, "start": None if from_seed else self.start,
                "program": self.kept,
                "clips": [torch.from_numpy(pool[c][0]).to(device) for c in self.clips],
                "targets": [pool[c][1] for c in self.clips]}


def record_steps(trainer) -> None:
    """Instance wrappers that keep the reference points and host fields of each step
    while a stretch is being recorded (``trainer.bench_kept``)."""
    spotter = trainer.model.detection_transformer
    select, fields = spotter.select_proposals, trainer.host_fields
    trainer.bench_kept = None

    def select_rec(enc_class, enc_coords):
        out = select(enc_class, enc_coords)
        if trainer.bench_kept is not None:
            trainer.bench_kept["ref_points"].append(out.detach().clone())
        return out

    def fields_rec(spot_out):
        out = fields(spot_out)
        if trainer.bench_kept is not None:
            trainer.bench_kept["host"].append(out)
        return out

    spotter.select_proposals, trainer.host_fields = select_rec, fields_rec


def run(ctx: Dict) -> Dict:
    from gomatching_tpu_torch.engine.train import Trainer

    m, tr, seed, device = ctx["model"], ctx["traffic"], ctx["seed"], ctx["device"]
    trc = ctx["config"]["train"]
    cfg = port_cfg(ctx["config"], seed, ctx.get("extra_opts", ()))
    check_cfg(cfg, m)
    check_train_cfg(cfg, trc)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(m.get("tf32"))
    T, size = int(trc["train_len"]), int(trc["train_size"])
    sd = make_state_dict(m, seed, device)
    trainer = Trainer(cfg, state_dict=sd, device=device)
    rng = np.random.default_rng([int(seed), 3])
    pool = [synth_clip(rng, T, size, size, m["num_points"], int(tr["gt_per_frame"]))
            for _ in range(int(tr["pool_clips"]))]
    # proposal thresholds from the reference's spot of the first clip; the reference's
    # seconds are not set-up's
    t_ref = time.perf_counter()
    with torch.device(device):
        ref = ReferenceModel(m)
    ref.load_state_dict({k: v.float() for k, v in sd.items()})
    ref.eval()
    del sd
    x = normalize(torch.from_numpy(pool[0][0]).to(device), m["pixel_mean"], m["pixel_std"])
    raw = spot(ref, x)
    fused = raw["pred_logits"].float().mean(2)[..., 0].sigmoid()
    if raw["re_pred_logits"] is not None:
        fused = torch.maximum(fused, raw["re_pred_logits"].float().mean(2)[..., 0].sigmoid())
    q = 1.0 - tr["kept_per_frame"] / m["num_queries"]
    thresh = float(np.quantile(fused.cpu().numpy(), q))
    trainer.train_thresh = trainer.asso_thresh = thresh
    del x, raw, fused
    ref.cpu()
    ref_s = time.perf_counter() - t_ref
    # the first steps, checked, which are the warm-up too
    n_checked = int(tr["checked_steps"])
    record_steps(trainer)
    first = Stretch("set-up", trainer, pool, 0, n_checked)
    for k in range(n_checked):
        first.stepped(trainer.step(*_clip_args(pool, k)), k % len(pool))
    first.to_host()
    # the stretch checked inside the window starts at a share of it drawn from the seed
    lo, hi = tr["window_check_at"]
    check_at = float(np.random.default_rng([int(seed), 4]).uniform(lo, hi))
    inner = None

    spans = tracing.Spans()
    prof = None
    if ctx["trace"]:
        trainer.spot = spans.wrap("spot", trainer.spot)
        trainer.prepare_batch = spans.wrap("host", trainer.prepare_batch)
        trainer.update = spans.wrap("update", trainer.update)
        prof = tracing.profile_window(ctx["trace_dir"])
        prof.__enter__()
    phase = {"spot": 0.0, "host": 0.0, "update": 0.0}
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t0"] - ref_s
    print(f"set-up (s): {setup_s:.3f} (the reference's {ref_s:.3f} apart), threshold "
          f"{thresh!r}, checked losses {first.kept['loss']}", file=sys.stderr)
    t_start = time.perf_counter()
    deadline = t_start + ctx["seconds"]
    at = t_start + check_at * ctx["seconds"]
    win = torch.profiler.record_function(tracing.WINDOW)
    win.__enter__()
    iters = failed = 0
    recording = False
    # the window runs on until the stretch inside it is complete
    while time.perf_counter() < deadline or recording:
        k = n_checked + iters
        if inner is None and time.perf_counter() >= at:
            inner = Stretch("window", trainer, pool, k, n_checked)
            recording = True
        out = trainer.step(*_clip_args(pool, k))
        iters += 1
        failed += int(not np.isfinite(out["total_loss"]))
        for key in phase:
            phase[key] += trainer.phase_t[key]
        if recording:
            recording = not inner.stepped(out, k % len(pool))
    t_end = time.perf_counter()
    win.__exit__(None, None, None)
    window_s = t_end - t_start
    memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    trace_stats = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(ctx["trace_dir"], f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        del prof
        trace_stats = tracing.reduce_trace(path, SPAN_NAMES)
        os.remove(path)
    dropout_seed = trainer.model.roi_heads.dropout_seed
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.to(device)
    stretches = [first.judged(device, True), inner.judged(device, False) if inner
                 else {"name": "window", "program": None}]
    checks = check_train.readings(ref, stretches, m, trc, thresh, dropout_seed,
                                  ctx.get("control"))
    peaks = ctx["peaks"]
    return {
        "attempted": iters, "failed": failed,
        "end_to_end": {"train_ms_per_iter": window_s * 1e3 / max(iters, 1), "setup_s": setup_s},
        "memory_peak_bytes": int(memory_peak), "checks": checks,
        "records": {
            "kind": "train", "iters": iters, "window_s": window_s, "phase_s": phase,
            "trace": trace_stats, "flops": train_step_flops(m, T, size) * iters,
            "peak_flops": peaks[m["precision"]], "model": m,
        },
    }


def _clip_args(pool, k: int):
    """Step ``k``'s arguments to ``Trainer.step``: the pool's clips in turn."""
    images, targets = pool[k % len(pool)]
    return images, None, targets
