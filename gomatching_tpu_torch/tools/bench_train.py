"""Training throughput on one card (the counterpart of ``tools/bench_train.py``).

    python -m gomatching_tpu_torch.tools.bench_train [--iters 8] [--size 736] [--frames 4]
        [--pretrain] [--impl tiled|vmem|both] [--cpu] [--config-file FILE] [--opts ...]

Measures, on seeded random weights at the configuration's widths (by default the flagship
GoMatching ICDAR15 one):

  1. the tracker training step (``Trainer.step``: the frozen spot, the host matching, the
     update of ``roi_heads``) on a synthetic ``--frames``-frame uint8 clip of ``--size``
     squared (``synth_clip``, the same bits as JAX's): one untimed first step, then
     ``--iters`` iterations, each timing the clip's copy to the device (synchronized)
     apart from the step, whose ``phase_t`` splits it into spot, host and update; the
     median, min and max ms/iter, the loss, the split, the hours 30 000 iterations would
     take against the reference's ~3 h on one RTX 3090 (BASELINE.md:21) and the peak
     device memory;
  2. with ``--pretrain``, the image-spotter pretraining step (``SpotterPretrainer.step``)
     on JAX's synthetic image and record. The port's pretraining has one route, the exact
     samplers B1-B4 (models/gomatching.py), so every ``--impl`` value runs that step once.

Runs on the current CUDA device (TF32 off) and raises without one unless given ``--cpu``.
The first line names the card and its power limit. ``--overlap`` (JAX's spot-ahead
upload loop) is TPU transport, which the port does not carry (ROADMAP.md's ground rules):
it raises. A developer tool: it writes no benchmark record.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "GoMatching_ICDAR15.yaml")
REFERENCE_HOURS = 3.0  # 30 000 iterations on one RTX 3090 (BASELINE.md:21)
ITERATIONS_30K = 30000


def synth_clip(rng, t, h, w, npts=25, n_inst=8):
    """A synthetic raw uint8 clip (t, h, w, 3) and GT targets shaped like the video
    mapper's (tools/bench_train.py:33-63, the same draws from ``rng`` in the same order)."""
    images = rng.randint(0, 256, (t, h, w, 3)).astype(np.uint8)
    gt_ctrl, gt_boxes, gt_ids, gt_texts = [], [], [], []
    for _ in range(t):
        n = n_inst
        cx = rng.uniform(0.15, 0.85, n)
        cy = rng.uniform(0.15, 0.85, n)
        bw = rng.uniform(0.05, 0.2, n)
        bh = rng.uniform(0.03, 0.08, n)
        boxes = np.stack([
            (cx - bw / 2) * w, (cy - bh / 2) * h,
            (cx + bw / 2) * w, (cy + bh / 2) * h,
        ], 1).astype(np.float32)
        tt = np.linspace(0, 1, npts, dtype=np.float32)
        ctrl = np.stack([
            (boxes[:, None, 0] + tt[None] * (boxes[:, 2] - boxes[:, 0])[:, None]),
            np.broadcast_to(((boxes[:, 1] + boxes[:, 3]) / 2)[:, None], (n, npts)),
        ], -1).astype(np.float32)
        gt_ctrl.append(ctrl)
        gt_boxes.append(boxes)
        gt_ids.append(np.arange(n, dtype=np.int64))
        gt_texts.append(["word"] * n)
    return images, {
        "gt_ctrl": [c / np.asarray([w, h], np.float32) for c in gt_ctrl],
        "gt_boxes": [b / np.asarray([w, h, w, h], np.float32) for b in gt_boxes],
        "gt_ids": gt_ids,
        "gt_texts": gt_texts,
    }


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return "device: cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> Optional[int]:
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _fmt_peak(peak: Optional[int]) -> str:
    return "n/a (CPU)" if peak is None else f"{peak / 2**30:.2f} GiB"


def bench_tracker(cfg, iters: int, frames: int, size: int, rng, device) -> Dict:
    """The tracker step on ``synth_clip``; returns its numbers (ms, losses, split, peak)."""
    import torch

    from ..engine.train import Trainer, encode_train_clip

    trainer = Trainer(cfg, device=device)
    h = w = size
    images, targets = synth_clip(rng, frames, h, w, npts=cfg.MODEL.TRANSFORMER.NUM_POINTS)
    if cfg.TPU.TRAIN_UPLOAD_FORMAT == "yuv420":
        images = encode_train_clip(images, cfg.INPUT.FORMAT)
    hw = np.tile(np.asarray([h, w], np.float32)[None], (frames, 1))

    t0 = time.perf_counter()
    first = trainer.step(images, hw, targets)
    first_s = time.perf_counter() - t0

    _reset_peak(device)
    host = torch.from_numpy(images)
    up, step, phases, m = [], [], [], first
    for _ in range(iters):
        t0 = time.perf_counter()
        dev = host.to(device)
        _sync(device)
        t1 = time.perf_counter()
        m = trainer.step(dev, hw, targets)
        t2 = time.perf_counter()
        up.append(t1 - t0)
        step.append(t2 - t1)
        phases.append(dict(trainer.phase_t))
    total = [u + s for u, s in zip(up, step)]
    sec = float(np.median(total))
    split = {k: float(np.median([p[k] for p in phases])) * 1e3 for k in ("spot", "host", "update")}
    out = {"ms": sec * 1e3, "min_ms": min(total) * 1e3, "max_ms": max(total) * 1e3,
           "first_s": first_s, "first_loss": first["total_loss"], "loss": m["total_loss"],
           "upload_ms": float(np.median(up)) * 1e3, "split_ms": split,
           "hours_30k": sec * ITERATIONS_30K / 3600, "peak_bytes": _peak(device)}
    print(f"# tracker step: first step {first_s:.1f} s; median {out['ms']:.1f} ms/iter "
          f"(min {out['min_ms']:.1f}, max {out['max_ms']:.1f}) over {iters} iterations; "
          f"loss {m['total_loss']:.4f} (first step {first['total_loss']:.4f})")
    print(f"#   split: upload {out['upload_ms']:.1f} ({images.dtype} {tuple(images.shape)}, "
          f"{images.nbytes / 1e6:.1f} MB), spot {split['spot']:.1f}, host {split['host']:.1f}, "
          f"update {split['update']:.1f} ms")
    print(f"# projected {ITERATIONS_30K // 1000}k iters: {out['hours_30k']:.2f} h  "
          f"(reference: ~{REFERENCE_HOURS:.0f} h on 1x RTX 3090, BASELINE.md:21)")
    print(f"# peak device memory over the timed iterations: {_fmt_peak(out['peak_bytes'])}")
    return out


def pretrain_record(size: int, voc_size: int) -> Dict:
    """JAX's synthetic pretraining record (tools/bench_train.py:157-166): six boxes whose
    annotations carry no ``beziers``, so its targets hold no instance."""
    return {
        "height": size, "width": size,
        "annotations": [
            {"poly": [0.1 * size, 0.2 * size, 0.5 * size, 0.2 * size,
                      0.5 * size, 0.3 * size, 0.1 * size, 0.3 * size],
             "bbox": [0.1 * size, 0.2 * size, 0.4 * size, 0.1 * size],
             "texts": [3, 4, 5] + [voc_size] * 22}
            for _ in range(6)
        ],
    }


def bench_pretrain(cfg, impls: List[str], iters: int, size: int, rng, device) -> Dict:
    """The image-pretraining step on JAX's synthetic input; returns its numbers."""
    from ..engine.pretrain import SpotterPretrainer, build_spotter_targets

    t = cfg.MODEL.TRANSFORMER
    trainer = SpotterPretrainer(cfg, device=device)
    img = rng.randn(1, size, size, 3).astype(np.float32)
    targets = build_spotter_targets(pretrain_record(size, t.VOC_SIZE), cfg.TPU.MAX_GT,
                                    t.NUM_POINTS, t.VOC_SIZE)
    targets = {k: v[None] for k, v in targets.items()}
    t0 = time.perf_counter()
    first = trainer.step(img, targets)
    first_s = time.perf_counter() - t0
    _reset_peak(device)
    times, m = [], first
    for _ in range(iters):
        t0 = time.perf_counter()
        m = trainer.step(img, targets)
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    out = {"ms": sec * 1e3, "min_ms": min(times) * 1e3, "max_ms": max(times) * 1e3,
           "first_s": first_s, "first_loss": first["total_loss"], "loss": m["total_loss"],
           "peak_bytes": _peak(device), "impls": list(impls)}
    print(f"# pretrain step [{'/'.join(impls)}: every --impl value runs the exact B1-B4, the "
          f"port's one pretraining route]: first step {first_s:.1f} s; median "
          f"{out['ms']:.1f} ms/iter (min {out['min_ms']:.1f}, max {out['max_ms']:.1f}) over "
          f"{iters} iterations at {size}x{size}; loss {m['total_loss']:.4f}")
    print(f"# peak device memory over the timed iterations: {_fmt_peak(out['peak_bytes'])}")
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    import torch

    from .. import resolve_device
    from ..config import setup_train_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--size", type=int, default=736,
                    help="square input size (the flagship trains around short side "
                    "640-896, GoMatching_ICDAR15.yaml)")
    ap.add_argument("--frames", type=int, default=4,
                    help="clip length (INPUT.VIDEO.TRAIN_LEN default 4)")
    ap.add_argument("--overlap", action="store_true",
                    help="JAX's double-buffered loop: TPU transport, not in the port")
    ap.add_argument("--pretrain", action="store_true")
    ap.add_argument("--impl", default="both", choices=("tiled", "vmem", "both"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--config-file", default=CONFIG)
    ap.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.overlap:
        raise ValueError("--overlap: JAX's spot-ahead upload loop is TPU transport, which the "
                         "port does not carry (ROADMAP.md ground rules: no overlap upload); "
                         "drop the flag")

    device = resolve_device("cpu" if args.cpu else None)
    print(card_line(device))
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = setup_train_cfg(args.config_file, ["MODEL.WEIGHTS", "''"] + list(args.opts))
    rng = np.random.RandomState(0)
    if args.pretrain:
        impls = ["tiled", "vmem"] if args.impl == "both" else [args.impl]
        return {"pretrain": bench_pretrain(cfg, impls, args.iters, args.size, rng, device)}
    return {"tracker": bench_tracker(cfg, args.iters, args.frames, args.size, rng, device)}


if __name__ == "__main__":
    main()
