"""Training CLI of the port: DeepSolo image-spotter pretraining (``--task spotter``).

    python -m gomatching_tpu_torch.train_net --config-file configs/GoMatching_ICDAR15.yaml \\
        --task spotter [--cpu] [--max-iter N] [--opts KEY VALUE ...]

Counterpart of the JAX ``train_net.py`` ``pretrain_main`` (:130-204): records of
``DATASETS.TRAIN`` -> per step one random record (a ``RandomState`` seeded by ``SEED``)
-> rotate + instance-aware crop -> resize to a ``INPUT.TRAIN_SIZE`` square canvas ->
normalize -> padded targets -> ``SpotterPretrainer.step``; a checkpoint
``OUTPUT_DIR/checkpoints/spotter_{iter:07d}.pth`` every ``SOLVER.CHECKPOINT_PERIOD``
iterations and at the last. Runs on the CUDA card unless ``--cpu``.

Not in the port yet (each raises ``NotImplementedError``): ``--task tracker`` (ROADMAP
A9), ``MODEL.META_ARCHITECTURE TransformerPureVideoDetector`` (video pretraining: its
padded clips need the level masks), Swin/ViTAEv2 backbones (A10), ``--num-gpus`` > 1
(A12) and ``--resume``. ``TPU.TRAIN_UPLOAD_UINT8`` and the other transport keys parse
and are ignored.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-gpus", "--num-chips", type=int, default=1, dest="num_gpus")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--max-iter", type=int, default=-1, help="override SOLVER.MAX_ITER")
    p.add_argument("--task", choices=("tracker", "spotter"), default="tracker")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    return p


def _check_supported(args, cfg) -> None:
    if args.task == "tracker":
        raise NotImplementedError("--task tracker (GoMatching tracker training) is not "
                                  "ported yet (ROADMAP A9)")
    if cfg.MODEL.META_ARCHITECTURE == "TransformerPureVideoDetector":
        raise NotImplementedError("video spotter pretraining (TransformerPureVideoDetector) "
                                  "is not ported yet: its padded clips need the level masks")
    if args.num_gpus != 1:
        raise NotImplementedError("--num-gpus other than 1 is not ported yet (ROADMAP A12)")
    if args.resume:
        raise NotImplementedError("--resume is not ported yet")


def pretrain_main(args, cfg) -> List[dict]:
    """The image-pretraining loop; returns each step's losses, its host wall
    ``step_s`` from reading the image through the optimizer step (which ends in a device
    sync when it fetches the losses; a checkpoint's write is not in it), and ``data_s``,
    the part of it spent reading, augmenting and normalizing the image and building
    the targets."""
    import cv2

    from .data.datasets import load_video_json, resolve_dataset
    from .data.image_augment import augment_pretrain_record
    from .engine.checkpoint import save_checkpoint
    from .engine.pretrain import SpotterPretrainer, build_spotter_targets

    t = cfg.MODEL.TRANSFORMER
    trainer = SpotterPretrainer(cfg, device="cpu" if args.cpu else None)
    records = []
    for name in cfg.DATASETS.TRAIN:
        image_root, json_file = resolve_dataset(name)
        records.extend(load_video_json(json_file, image_root, t.NUM_POINTS, voc_size=t.VOC_SIZE))
    print(f"pretraining on {len(records)} images")
    max_iter = args.max_iter if args.max_iter > 0 else cfg.SOLVER.MAX_ITER
    size = cfg.INPUT.TRAIN_SIZE
    mean = np.asarray(cfg.MODEL.PIXEL_MEAN)
    std = np.asarray(cfg.MODEL.PIXEL_STD)
    rng = np.random.RandomState(cfg.SEED if cfg.SEED > 0 else 0)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    history = []
    for i in range(max_iter):
        t0 = time.perf_counter()
        rec = records[int(rng.randint(len(records)))]
        img = cv2.imread(rec["file_name"])
        if img is None:
            continue
        if cfg.INPUT.FORMAT == "RGB":
            img = img[:, :, ::-1]
        # adet image-mapper chain: rotate -> instance-aware crop -> resize
        # (dataset_mapper.py:93-110)
        img, annos = augment_pretrain_record(
            img, rec, rng, rotate=cfg.INPUT.ROTATE, crop_enabled=cfg.INPUT.CROP.ENABLED,
            crop_frac=tuple(cfg.INPUT.CROP.SIZE), crop_instance=cfg.INPUT.CROP.CROP_INSTANCE,
            angle=45.0 if t.BOUNDARY_HEAD else 90.0,
        )
        aug_rec = {"height": img.shape[0], "width": img.shape[1], "annotations": annos}
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        images = ((img.astype(np.float32) - mean) / std)[None]
        targets = build_spotter_targets(aug_rec, cfg.TPU.MAX_GT, t.NUM_POINTS, t.VOC_SIZE)
        data_s = time.perf_counter() - t0
        metrics = trainer.step(images, {k: v[None] for k, v in targets.items()})
        history.append(dict(metrics, step_s=time.perf_counter() - t0, data_s=data_s))
        if not np.isfinite(metrics["total_loss"]):
            raise FloatingPointError(f"loss diverged at iteration {i + 1}: {metrics}")
        if (i + 1) % 20 == 0:
            print(f"iter {i + 1}/{max_iter} total {metrics['total_loss']:.4f}")
        if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or (i + 1) == max_iter:
            save_checkpoint(os.path.join(ckpt_dir, f"spotter_{i + 1:07d}.pth"), trainer.model)
    return history


def main(argv: Optional[List[str]] = None):
    from .config import setup_train_cfg

    args = get_parser().parse_args(argv)
    cfg = setup_train_cfg(args.config_file, args.opts)
    _check_supported(args, cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return pretrain_main(args, cfg)


if __name__ == "__main__":
    main()
