"""Training CLI of the port: GoMatching tracker training (``--task tracker``, the
default) and DeepSolo image-spotter pretraining (``--task spotter``).

    python -m gomatching_tpu_torch.train_net --config-file configs/GoMatching_ICDAR15.yaml \\
        [--task tracker|spotter] [--cpu] [--resume] [--max-iter N] [--opts KEY VALUE ...]

``--task tracker`` is the counterpart of the JAX ``train_net.py`` tracker loop
(:239-487), single card and sequential: ``MODEL.WEIGHTS`` (the JAX package's ``.npz``
params, a torch checkpoint, or '' for seeded random weights; the rescoring head takes
the spotter classifier's weights unless the path names a ``_rescore`` checkpoint) ->
``Trainer`` (only ``roi_heads`` trains) -> per iteration one clip of
``DATASETS.TRAIN`` from the video clip loader -> ``Trainer.step``. It writes
``OUTPUT_DIR/config.yaml``, a ``metrics.json`` line every 20 iterations and at the last
(detectron2's PeriodicWriter), and every ``SOLVER.CHECKPOINT_PERIOD`` iterations and at
the last ``checkpoints/model_{iter:07d}_rescore.pth`` (the whole model) beside
``checkpoints/state_{iter:07d}.pth`` (the trainer's and the loader's state), from
which ``--resume`` continues.

The clip goes to the device as uint8 with each frame's true size (``TPU.TRAIN_UPLOAD_UINT8``
True, the default): it is normalized there and the spotter sees the padding masks; with
``TPU.TRAIN_UPLOAD_FORMAT`` yuv420 it goes as planar I420 (when both sides of the canvas
are even) and is decoded there first (JAX train_net.py:348-351).
With ``TRAIN_UPLOAD_UINT8`` False the host normalizes and, as in JAX, no size is passed,
so nothing is masked. ``TPU.TRAIN_OVERLAP_UPLOAD`` parses and is not read (a transport
feature; JAX's own test shows it is numerically the sequential loop). ``MODEL.PRECISION``
bfloat16 runs the frozen spotter in bf16; the checkpoints hold its f32 weights.

``--task spotter`` is JAX ``pretrain_main`` (:130-204): records of ``DATASETS.TRAIN`` ->
per step one random record (a ``RandomState`` seeded by ``SEED``) -> rotate +
instance-aware crop -> resize to a ``INPUT.TRAIN_SIZE`` square canvas -> normalize ->
padded targets -> ``SpotterPretrainer.step``; a checkpoint
``OUTPUT_DIR/checkpoints/spotter_{iter:07d}.pth`` every ``SOLVER.CHECKPOINT_PERIOD``
iterations and at the last.

Pretraining runs f32 whatever ``MODEL.PRECISION`` says, as JAX's does.

Both run on the CUDA card unless ``--cpu``. Not in the port yet (each raises
``NotImplementedError``): ``TPU.SAMPLING_IMPL`` pallas with ``MODEL.PRECISION`` bfloat16
(ROADMAP A13c), ``MODEL.META_ARCHITECTURE TransformerPureVideoDetector`` (video
pretraining, A11b), Swin/ViTAEv2 backbones (A10), ``--num-gpus`` > 1 (A12), FREEZE_TYPEs
that train more than ``roi_heads``, and ``--resume`` of spotter pretraining.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

LOG_PERIOD = 20  # iterations per metrics.json line (detectron2's PeriodicWriter)


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
    if cfg.MODEL.META_ARCHITECTURE == "TransformerPureVideoDetector":
        raise NotImplementedError("video spotter pretraining (TransformerPureVideoDetector) "
                                  "is not ported yet (ROADMAP A11b)")
    if args.num_gpus != 1:
        raise NotImplementedError("--num-gpus other than 1 is not ported yet (ROADMAP A12)")
    if args.resume and args.task == "spotter":
        raise NotImplementedError("--resume of spotter pretraining is not ported yet")


# ---------------------------------------------------------------------------
# tracker training
# ---------------------------------------------------------------------------


def normalize_clip(sample, pixel_mean, pixel_std, pad_multiple: int = 32, raw: bool = False):
    """Stack a clip's frames on one zero-padded canvas (T, Hp, Wp, 3), each side the
    largest frame's rounded up to ``pad_multiple`` (ImageList.from_tensors); returns it
    with each frame's true (h, w) as a (T, 2) array. ``raw``: uint8 pixels, normalized
    on the device (``TPU.TRAIN_UPLOAD_UINT8``); else normalized float32.

    JAX ``normalize_clip`` (train_net.py:50) pads to the LAST frame's size, which a
    GEN_IMAGE_MOTION clip, whose frames change size, does not fit; where every frame
    has one size, as every video clip's has, the two give the same canvas."""
    frame_hw = np.asarray([img.shape[:2] for img in sample.images], np.int64)
    hp, wp = (-(-frame_hw.max(0) // pad_multiple) * pad_multiple).tolist()
    t = len(sample.images)
    if raw:
        batch = np.zeros((t, hp, wp, 3), np.uint8)
        for i, img in enumerate(sample.images):
            batch[i, :img.shape[0], :img.shape[1]] = np.clip(np.rint(img), 0, 255)
        return batch, frame_hw
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    batch = np.zeros((t, hp, wp, 3), np.float32)
    for i, img in enumerate(sample.images):
        batch[i, :img.shape[0], :img.shape[1]] = (img - mean) / std
    return batch, frame_hw


def targets_from_sample(sample) -> Dict[str, list]:
    """GT normalized to [0, 1] by each frame's own size (GoMatching.prepare_targets,
    gom_lstmatcher.py:192-211, _get_boxes_time :478-495)."""
    out: Dict[str, list] = {"gt_ctrl": [], "gt_boxes": [], "gt_ids": sample.gt_ids,
                            "gt_texts": sample.gt_texts}
    for img, ctrl, boxes in zip(sample.images, sample.gt_ctrl, sample.gt_boxes):
        h, w = img.shape[:2]
        out["gt_ctrl"].append(ctrl / np.asarray([w, h], np.float32))
        out["gt_boxes"].append(boxes / np.asarray([w, h, w, h], np.float32))
    return out


def init_rescoring_from_classifier(state_dict: Dict) -> Dict:
    """Copy the spotter classifier ``ctrl_point_class`` into the rescoring head
    (train_net.py:97-105; JAX train_net.py:89), in state_dict names."""
    import torch

    sd = dict(state_dict)
    for leaf in ("weight", "bias"):
        sd[f"roi_heads.rescoring_head.{leaf}"] = torch.as_tensor(
            sd[f"detection_transformer.ctrl_point_class.0.{leaf}"]).clone()
    return sd


def tracker_main(args, cfg) -> List[dict]:
    """The tracker-training loop; returns each iteration's losses with ``step_s``, its
    host wall from taking the clip to the losses' copy after the optimizer step (a
    checkpoint's write not included), ``data_s``, the part spent reading, augmenting and
    stacking the clip and building its targets, ``phase_t`` (the step's wall by phase),
    ``frames`` and ``image_hw`` (the canvas), and ``proposals`` and ``matched``, the
    proposal slots that passed the thresholds and those matched to a GT track."""
    import torch

    from .data.loader import build_train_loader
    from .engine.checkpoint import (latest_train_state, load_train_state, save_checkpoint,
                                    save_train_state)
    from .engine.optim import build_schedule
    from .engine.predictor import model_weights
    from .engine.train import Trainer, encode_train_clip
    from .weights import init_state_dict

    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    sd = model_weights(cfg)
    if sd is None:
        print("MODEL.WEIGHTS is '': training from seeded random weights")
        sd = init_state_dict(cfg, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
    if cfg.MODEL.ROI_HEADS.WITH_RESR and "_rescore" not in cfg.MODEL.WEIGHTS:
        sd = init_rescoring_from_classifier(sd)
    trainer = Trainer(cfg, sd, device="cpu" if args.cpu else None)
    n_train = sum(p.numel() for p in trainer.trainable)
    n_total = sum(p.numel() for p in trainer.model.parameters())
    print(f"trainable params: {n_train / 1e6:.2f}M / total {n_total / 1e6:.2f}M")

    loader = build_train_loader(cfg)
    max_iter = args.max_iter if args.max_iter > 0 else cfg.SOLVER.MAX_ITER
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    start_iter = 0
    if args.resume:
        path, step = latest_train_state(ckpt_dir)
        if path is not None:
            state = load_train_state(path)
            trainer.load_state_dict(state)
            loader.load_state_dict(state["loader"])
            start_iter = step
            print(f"resumed from {path} at iteration {step}")

    raw = bool(cfg.TPU.TRAIN_UPLOAD_UINT8)
    i420 = raw and cfg.TPU.TRAIN_UPLOAD_FORMAT == "yuv420"
    schedule = build_schedule(cfg)
    it = iter(loader)
    history = []
    window: List[dict] = []
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json"), "a") as mf:
        for i in range(start_iter, max_iter):
            t0 = time.perf_counter()
            sample = next(it)
            images, frame_hw = normalize_clip(sample, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                              raw=raw)
            canvas = tuple(images.shape[1:3])
            if i420:
                images = encode_train_clip(images, cfg.INPUT.FORMAT)
            targets = targets_from_sample(sample)
            data_s = time.perf_counter() - t0
            # as in JAX (train_net.py:344-350): the frames' sizes go with the uint8 wire
            metrics = trainer.step(images, frame_hw if raw else None, targets)
            step_s = time.perf_counter() - t0
            if not np.isfinite(metrics["total_loss"]):
                raise FloatingPointError(f"loss diverged at iteration {i + 1}: {metrics}")
            batch = trainer.last_batch
            history.append(dict(metrics, step_s=step_s, data_s=data_s,
                                phase_t=dict(trainer.phase_t), frames=len(images),
                                image_hw=canvas,
                                proposals=int(batch["prop_valid"].sum()),
                                matched=int((batch["match_cues"] >= 0).sum())))
            window.append(history[-1])
            if (i + 1) % LOG_PERIOD == 0 or i + 1 == max_iter:
                lr = schedule(i)  # the rate this iteration's update used, as JAX logs it
                line = {"iteration": i + 1, "lr": lr,
                        "data_time": sum(h["data_s"] for h in window) / len(window),
                        "time": sum(h["step_s"] - h["data_s"] for h in window) / len(window),
                        **metrics}
                mf.write(json.dumps(line) + "\n")
                mf.flush()
                print(f"iter {i + 1}/{max_iter} loss {metrics['total_loss']:.4f} "
                      f"res {metrics.get('loss_res', 0.0):.4f} "
                      f"long {metrics['loss_long_asso']:.4f} "
                      f"short {metrics['loss_short_asso']:.4f} lr {lr:.2e}")
                window = []
            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or i + 1 == max_iter:
                save_checkpoint(os.path.join(ckpt_dir, f"model_{i + 1:07d}_rescore.pth"),
                                trainer.model_state_dict())
                save_train_state(ckpt_dir, i + 1,
                                 dict(trainer.state_dict(), loader=loader.state_dict()))
                print(f"saved checkpoint at iteration {i + 1}")
    return history


# ---------------------------------------------------------------------------
# spotter pretraining
# ---------------------------------------------------------------------------


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
    if args.task == "tracker":
        return tracker_main(args, cfg)
    return pretrain_main(args, cfg)


if __name__ == "__main__":
    main()
