"""Training CLI of the port: GoMatching tracker training (``--task tracker``, the
default) and DeepSolo spotter pretraining (``--task spotter``), on images or, with
``MODEL.META_ARCHITECTURE TransformerPureVideoDetector``, on video clips.

    python -m gomatching_tpu_torch.train_net --config-file configs/GoMatching_ICDAR15.yaml \\
        [--task tracker|spotter] [--cpu] [--resume] [--max-iter N] [--num-gpus N] \\
        [--num-machines M --machine-rank R --dist-url tcp://host:port] [--opts KEY VALUE ...]

``--task tracker`` is the counterpart of the JAX ``train_net.py`` tracker loop
(:239-487), sequential on one card by default: ``MODEL.WEIGHTS`` (the JAX package's ``.npz``
params, a torch checkpoint, or '' for seeded random weights; the rescoring head takes
the spotter classifier's weights unless the path names a ``_rescore`` checkpoint) ->
``Trainer`` (``MODEL.FREEZE_TYPE`` says what trains; the shipped configs train
``roi_heads``) -> per iteration one clip of ``DATASETS.TRAIN`` from the video clip loader
-> ``Trainer.step``. It writes ``OUTPUT_DIR/config.yaml``, a ``metrics.json`` line every
20 iterations and at the last (detectron2's PeriodicWriter) with the same numbers as
tensorboard scalars under ``OUTPUT_DIR/tb`` (JAX train_net.py:322-329, :371-374; skipped
with one printed line where ``torch.utils.tensorboard`` does not import), and every
``SOLVER.CHECKPOINT_PERIOD`` iterations and at the last
``checkpoints/model_{iter:07d}_rescore.pth`` (the whole model) beside
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
iterations and at the last. With ``TransformerPureVideoDetector`` it is JAX
``pretrain_video_main`` (:100-127): per step one clip of the video clip loader, on one
padded canvas with each frame's true size (the spotter's padding masks), per-frame
targets (``build_video_spotter_targets``), the same checkpoints.

Pretraining runs f32 whatever ``MODEL.PRECISION`` says, as JAX's does. Every trunk
(``MODEL.BACKBONE.NAME``: ResNet, Swin-T/S, ViTAEv2-S) trains and infers; a Swin trunk
drops paths in pretraining at ``SWIN.DROP_PATH_RATE``.

Both run on the CUDA card unless ``--cpu``.

**Data parallel** (JAX train_net.py:276-286, :444-476): with ``--num-gpus`` N > 1 (0: every
visible card; under ``--cpu`` a count of CPU processes) and ``--num-machines`` M, tracker
training runs N x M ranks, one process per card (``parallel/launch.py``: NCCL on cards,
gloo on the CPU). ``--machine-rank`` and ``--dist-url`` (``tcp://host:port``,
``host:port`` or ``auto``, the launcher's ``MASTER_ADDR`` / ``MASTER_PORT``) join the
machines, as the reference's DDP launch (train_net.py:198-208); with one machine
``auto`` takes a free local port. Each rank reads its own share of the one seeded clip
stream (the reference's sampler); per iteration the ranks exchange their clips' sizes,
pad to the common canvas and frame count (``normalize_clip(canvas=, pad_t=)``, the
padding frames masked by ``frame_valid``) and take ``Trainer.step_multi``, whose
gradient and losses are averaged over the ranks. Rank 0 alone writes ``config.yaml``,
``metrics.json`` (the averaged losses), tensorboard and the checkpoints; the train state
holds every rank's loader state, and ``--resume`` restores each rank's own and refuses a
state written by another number of ranks. ``--task spotter`` runs on one device whatever
``--num-gpus`` says, and ignores ``--resume``, as JAX's ``pretrain_main`` does; each
prints one line saying so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

LOG_PERIOD = 20  # iterations per metrics.json line (detectron2's PeriodicWriter)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num-gpus", "--num-chips", type=int, default=1, dest="num_gpus",
                   help="data-parallel processes on this machine; 0 = every visible card")
    p.add_argument("--num-machines", type=int, default=1,
                   help="machines of a multi-machine run (the reference's DDP launch)")
    p.add_argument("--machine-rank", type=int, default=0, help="this machine's index")
    p.add_argument("--dist-url", default="auto",
                   help="rendezvous: tcp://host:port, host:port, or auto (MASTER_ADDR / "
                   "MASTER_PORT; one machine: a free local port)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--max-iter", type=int, default=-1, help="override SOLVER.MAX_ITER")
    p.add_argument("--task", choices=("tracker", "spotter"), default="tracker")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    return p


# ---------------------------------------------------------------------------
# tracker training
# ---------------------------------------------------------------------------


def normalize_clip(sample, pixel_mean, pixel_std, pad_multiple: int = 32, raw: bool = False,
                   canvas: Optional[Sequence[int]] = None, pad_t: int = 0):
    """Stack a clip's frames on one zero-padded canvas (T, Hp, Wp, 3), each side the
    largest frame's rounded up to ``pad_multiple`` (ImageList.from_tensors); returns it
    with each frame's true (h, w) as a (T, 2) array. ``raw``: uint8 pixels, normalized
    on the device (``TPU.TRAIN_UPLOAD_UINT8``); else normalized float32. ``canvas`` (h, w)
    and ``pad_t`` force at least that canvas and frame count (JAX train_net.py:50-73),
    so that the clips of a data-parallel step share one shape: the extra frames are zero
    and take the last frame's size.

    JAX ``normalize_clip`` pads to the LAST frame's size, which a GEN_IMAGE_MOTION clip,
    whose frames change size, does not fit; where every frame has one size, as every
    video clip's has, the two give the same canvas."""
    frame_hw = np.asarray([img.shape[:2] for img in sample.images], np.int64)
    hp, wp = np.maximum(frame_hw.max(0), canvas if canvas is not None else 0).tolist()
    hp, wp = -(-hp // pad_multiple) * pad_multiple, -(-wp // pad_multiple) * pad_multiple
    t = max(len(sample.images), pad_t)
    frame_hw = np.concatenate([frame_hw, np.repeat(frame_hw[-1:], t - len(frame_hw), 0)])
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


def targets_from_sample(sample, pad_t: int = 0) -> Dict[str, list]:
    """GT normalized to [0, 1] by each frame's own size (GoMatching.prepare_targets,
    gom_lstmatcher.py:192-211, _get_boxes_time :478-495). ``pad_t``: empty GT for the
    padding frames up to that count and ``frame_valid`` marking the real ones (JAX
    train_net.py:463-471)."""
    out: Dict[str, list] = {"gt_ctrl": [], "gt_boxes": [], "gt_ids": list(sample.gt_ids),
                            "gt_texts": list(sample.gt_texts)}
    for img, ctrl, boxes in zip(sample.images, sample.gt_ctrl, sample.gt_boxes):
        h, w = img.shape[:2]
        out["gt_ctrl"].append(ctrl / np.asarray([w, h], np.float32))
        out["gt_boxes"].append(boxes / np.asarray([w, h, w, h], np.float32))
    t_real = len(sample.images)
    if pad_t > t_real:
        npts = out["gt_ctrl"][0].shape[1] if out["gt_ctrl"] else 25
        for _ in range(pad_t - t_real):
            out["gt_ctrl"].append(np.zeros((0, npts, 2), np.float32))
            out["gt_boxes"].append(np.zeros((0, 4), np.float32))
            out["gt_ids"].append(np.zeros((0,), np.int64))
            out["gt_texts"].append([])
    if pad_t:
        out["frame_valid"] = np.arange(max(pad_t, t_real)) < t_real
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
    stacking the clip and building its targets, ``wait_s``, the part spent waiting for the
    other ranks' clip sizes (0 on one rank), ``phase_t`` (the step's wall by phase),
    ``frames`` and ``image_hw`` (the canvas), and ``proposals`` and ``matched``, the
    proposal slots that passed the thresholds and those matched to a GT track. In a
    process group (data parallel) each rank runs this loop on its own clips; the losses
    are the averages over the ranks, the rest this rank's."""
    import torch
    import torch.distributed as dist

    from .data.loader import build_train_loader
    from .engine.checkpoint import (latest_train_state, load_train_state, save_checkpoint,
                                    save_train_state)
    from .engine.optim import build_schedule
    from .engine.predictor import model_weights
    from .engine.train import Trainer, encode_train_clip
    from .parallel.mesh import (gather_objects, gather_shapes, host_group, is_main,
                                rank_and_world)
    from .weights import init_state_dict

    group = dist.group.WORLD if dist.is_initialized() else None
    rank, world = rank_and_world(group)
    main = is_main(group)
    hgroup = host_group(group) if group is not None else None
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path, start_iter, state = None, 0, None
    if args.resume:
        path, start_iter = latest_train_state(ckpt_dir)
        if path is not None:
            state = load_train_state(path)
            # a state of one rank written before the data-parallel loop holds "loader" alone
            loaders = state.get("loaders", [state["loader"]])
            if len(loaders) != world:
                raise ValueError(f"{path} was written by {len(loaders)} ranks; this run has "
                                 f"{world}: resume with --num-gpus x --num-machines = "
                                 f"{len(loaders)}")
    if main:
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    sd = model_weights(cfg)
    if sd is None:
        if main:
            print("MODEL.WEIGHTS is '': training from seeded random weights")
        sd = init_state_dict(cfg, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
    if cfg.MODEL.ROI_HEADS.WITH_RESR and "_rescore" not in cfg.MODEL.WEIGHTS:
        sd = init_rescoring_from_classifier(sd)
    trainer = Trainer(cfg, sd, device="cpu" if args.cpu else None, group=group)
    if main:
        n_train = sum(p.numel() for p in trainer.trainable)
        n_total = sum(p.numel() for p in trainer.model.parameters())
        print(f"trainable params: {n_train / 1e6:.2f}M / total {n_total / 1e6:.2f}M"
              + (f"; data parallel over {world} ranks" if world > 1 else ""))

    loader = build_train_loader(cfg, rank, world)
    max_iter = args.max_iter if args.max_iter > 0 else cfg.SOLVER.MAX_ITER
    if state is not None:
        trainer.load_state_dict(state)
        loader.load_state_dict(loaders[rank])
        if main:
            print(f"resumed from {path} at iteration {start_iter}")

    raw = bool(cfg.TPU.TRAIN_UPLOAD_UINT8)
    i420 = raw and cfg.TPU.TRAIN_UPLOAD_FORMAT == "yuv420"
    schedule = build_schedule(cfg)
    it = iter(loader)
    history = []
    window: List[dict] = []
    tb = tensorboard_writer(cfg.OUTPUT_DIR) if main else None
    mf = open(os.path.join(cfg.OUTPUT_DIR, "metrics.json"), "a") if main else None
    try:
        for i in range(start_iter, max_iter):
            t0 = time.perf_counter()
            sample = next(it)
            wait_s = 0.0
            if world == 1:
                images, frame_hw = normalize_clip(sample, cfg.MODEL.PIXEL_MEAN,
                                                  cfg.MODEL.PIXEL_STD, raw=raw)
                targets = targets_from_sample(sample)
            else:
                # every rank's clip on the common canvas and frame count (JAX :450-473)
                tw = time.perf_counter()
                shapes = gather_shapes((len(sample.images),
                                        *np.max([im.shape[:2] for im in sample.images], 0)),
                                       hgroup)
                wait_s = time.perf_counter() - tw
                t_max = max(sh[0] for sh in shapes)
                canvas = (max(sh[1] for sh in shapes), max(sh[2] for sh in shapes))
                images, frame_hw = normalize_clip(sample, cfg.MODEL.PIXEL_MEAN,
                                                  cfg.MODEL.PIXEL_STD, raw=raw, canvas=canvas,
                                                  pad_t=t_max)
                targets = targets_from_sample(sample, pad_t=t_max)
            canvas_hw = tuple(images.shape[1:3])
            if i420:
                images = encode_train_clip(images, cfg.INPUT.FORMAT)
            data_s = time.perf_counter() - t0 - wait_s
            if world == 1:
                # as in JAX (train_net.py:344-350): the frames' sizes go with the uint8 wire
                metrics = trainer.step(images, frame_hw if raw else None, targets)
            else:
                # JAX's data-parallel loop passes the sizes on either wire (:472)
                metrics = trainer.step_multi([(images, frame_hw, targets)])
            step_s = time.perf_counter() - t0
            if not np.isfinite(metrics["total_loss"]):
                raise FloatingPointError(f"loss diverged at iteration {i + 1}: {metrics}")
            history.append(dict(metrics, step_s=step_s, data_s=data_s, wait_s=wait_s,
                                phase_t=dict(trainer.phase_t), frames=len(images),
                                image_hw=canvas_hw,
                                proposals=sum(int(b["prop_valid"].sum())
                                              for b in trainer.last_batches),
                                matched=sum(int((b["match_cues"] >= 0).sum())
                                            for b in trainer.last_batches)))
            window.append(history[-1])
            if main and ((i + 1) % LOG_PERIOD == 0 or i + 1 == max_iter):
                lr = schedule(i)  # the rate this iteration's update used, as JAX logs it
                line = {"iteration": i + 1, "lr": lr,
                        "data_time": sum(h["data_s"] for h in window) / len(window),
                        "time": sum(h["step_s"] - h["data_s"] for h in window) / len(window),
                        **metrics}
                mf.write(json.dumps(line) + "\n")
                mf.flush()
                if tb is not None:
                    for k, v in line.items():
                        if isinstance(v, (int, float)):
                            tb.add_scalar(k, v, i + 1)
                    tb.flush()
                print(f"iter {i + 1}/{max_iter} loss {metrics['total_loss']:.4f} "
                      f"res {metrics.get('loss_res', 0.0):.4f} "
                      f"long {metrics['loss_long_asso']:.4f} "
                      f"short {metrics['loss_short_asso']:.4f} lr {lr:.2e}")
                window = []
            if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or i + 1 == max_iter:
                loaders = [loader.state_dict()]
                if world > 1:
                    loaders = gather_objects(loaders[0], hgroup)
                    # the replicas must hold the same bits; a divergence is a fault, never
                    # repaired by a broadcast
                    if len(set(gather_objects(trainer.replica_digest(), hgroup))) != 1:
                        raise RuntimeError(f"the ranks' weights differ at iteration {i + 1}")
                if main:
                    save_checkpoint(os.path.join(ckpt_dir, f"model_{i + 1:07d}_rescore.pth"),
                                    trainer.model_state_dict())
                    save_train_state(ckpt_dir, i + 1, dict(trainer.state_dict(),
                                                           loader=loaders[0], loaders=loaders))
                    print(f"saved checkpoint at iteration {i + 1}")
    finally:
        if mf is not None:
            mf.close()
        if tb is not None:
            tb.close()
    return history


def tensorboard_writer(output_dir: str):
    """A ``SummaryWriter`` at ``output_dir/tb`` (the reference's TensorboardXWriter,
    train_net.py:79-87), or None, with one printed line, where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"tensorboard scalars skipped: {e}")
        return None
    return SummaryWriter(os.path.join(output_dir, "tb"))


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


def pretrain_video_main(args, cfg) -> List[dict]:
    """The video-pretraining loop (JAX ``pretrain_video_main``, train_net.py:100-127):
    clips of the video clip loader on a padded canvas with each frame's true size,
    per-frame targets, ``checkpoints/spotter_{iter:07d}.pth``. Returns each step's losses
    with ``step_s``, ``data_s``, ``frames`` and ``image_hw`` (the canvas)."""
    from .data.loader import build_train_loader
    from .engine.checkpoint import save_checkpoint
    from .engine.pretrain import SpotterPretrainer, build_video_spotter_targets

    t = cfg.MODEL.TRANSFORMER
    trainer = SpotterPretrainer(cfg, device="cpu" if args.cpu else None)
    loader = build_train_loader(cfg)
    max_iter = args.max_iter if args.max_iter > 0 else cfg.SOLVER.MAX_ITER
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    raw = bool(cfg.TPU.TRAIN_UPLOAD_UINT8)
    it = iter(loader)
    history = []
    for i in range(max_iter):
        t0 = time.perf_counter()
        sample = next(it)
        images, frame_hw = normalize_clip(sample, cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD,
                                          raw=raw)
        targets = build_video_spotter_targets(sample, cfg.TPU.MAX_GT, t.NUM_POINTS,
                                              t.VOC_SIZE)
        data_s = time.perf_counter() - t0
        metrics = trainer.step(images, targets, image_hw=frame_hw)
        history.append(dict(metrics, step_s=time.perf_counter() - t0, data_s=data_s,
                            frames=len(images), image_hw=tuple(images.shape[1:3])))
        if not np.isfinite(metrics["total_loss"]):
            raise FloatingPointError(f"loss diverged at iteration {i + 1}: {metrics}")
        if (i + 1) % 20 == 0:
            print(f"iter {i + 1}/{max_iter} total {metrics['total_loss']:.4f}")
        if (i + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or (i + 1) == max_iter:
            save_checkpoint(os.path.join(ckpt_dir, f"spotter_{i + 1:07d}.pth"), trainer.model)
    return history


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` and train. A tracker run over more than one rank launches one
    process per rank of this machine (unless this process already belongs to a process
    group of that size), with no deadline: it lasts as long as its iterations do. It
    returns the history of this machine's local rank 0 (global rank machine_rank x
    num_gpus): its losses are the averages over every rank, its times, frames and
    proposals that rank's own."""
    import torch.distributed as dist

    from .config import setup_train_cfg
    from .parallel.launch import launch, resolve_num_gpus

    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_parser().parse_args(argv)
    cfg = setup_train_cfg(args.config_file, args.opts)
    if args.task == "spotter":
        # JAX builds no mesh for pretraining (train_net.py:246-247) and its pretrain_main
        # never reads --resume
        if args.num_gpus != 1 or args.num_machines != 1:
            print(f"--task spotter runs on one device, as JAX's pretraining does: "
                  f"--num-gpus {args.num_gpus} --num-machines {args.num_machines} ignored")
        if args.resume:
            print("--task spotter: --resume is ignored, as JAX's pretrain_main ignores it")
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        if cfg.MODEL.META_ARCHITECTURE == "TransformerPureVideoDetector":
            return pretrain_video_main(args, cfg)
        return pretrain_main(args, cfg)
    num_gpus = resolve_num_gpus(args.num_gpus, args.cpu)
    world = num_gpus * args.num_machines
    if world > 1 and not dist.is_initialized():
        results = launch(main, num_gpus, args.num_machines, args.machine_rank, args.dist_url,
                         args=(argv,), device="cpu" if args.cpu else None)
        return results[0]
    if dist.is_initialized() and dist.get_world_size() != world:
        raise ValueError(f"this process group has {dist.get_world_size()} ranks; the flags "
                         f"ask for {world}")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return tracker_main(args, cfg)


if __name__ == "__main__":
    main()
