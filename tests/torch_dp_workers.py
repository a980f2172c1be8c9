"""What the spawned ranks of the port's data-parallel tests run (``parallel.launch`` pickles
a function by its module, so the ranks import this small module, not a test module that
imports JAX)."""

import os
import time

import numpy as np
import torch


def collectives(values):
    """This rank's global rank and world, ``all_reduce_mean_`` of two tensors holding
    ``values[rank]``, ``gather_shapes`` of a (rank, 5 + rank, 7) shape, and
    ``host_group`` under a backend that reports itself as NCCL (as on cards): one gloo
    group, made at the first call and returned by the second, that gathers."""
    from gomatching_tpu_torch.parallel import mesh

    rank, world = mesh.rank_and_world()
    tensors = [torch.full((3,), float(values[rank])), torch.full((2, 2), 10.0 * values[rank])]
    mesh.all_reduce_mean_(tensors)
    get_backend = mesh.dist.get_backend
    mesh.dist.get_backend = lambda group=None: "nccl"
    try:
        first, again = mesh.host_group(), mesh.host_group()
    finally:
        mesh.dist.get_backend = get_backend
    return {"rank": rank, "world": world, "mean": [t.tolist() for t in tensors],
            "shapes": mesh.gather_shapes((rank, 5 + rank, 7)), "main": mesh.is_main(),
            "host_group": (first is again and first is not mesh.dist.group.WORLD,
                           get_backend(first), mesh.gather_objects(rank, first))}


def sleep_then_return(seconds):
    time.sleep(seconds)
    return "finished"


def raise_on_rank1():
    from gomatching_tpu_torch.parallel import mesh

    if mesh.rank_and_world()[0] == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.gather_shapes((1, 2, 3))  # rank 0 waits for rank 1 in a collective
    return "finished"


def hang_on_rank1():
    from gomatching_tpu_torch.parallel import mesh

    if mesh.rank_and_world()[0] == 1:
        time.sleep(3600)
    return "finished"


def train_steps(config, opts, variants):
    """For each (name, extra opts, clips) of ``variants``: a ``Trainer`` on the group from
    the seeded weights of ``opts``, one ``step_multi`` on this rank's clip ``clips[rank]``;
    returns per variant the averaged losses, this rank's own loss of its clip (before the
    average), the updated roi_heads and the replica digest."""
    import torch.distributed as dist

    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.engine.train import Trainer

    rank = dist.get_rank()
    out = {}
    for name, extra, clips in variants:
        cfg = setup_train_cfg(config, list(opts) + list(extra))
        tr = Trainer(cfg, device="cpu", group=dist.group.WORLD)
        local = []
        loss = tr.loss

        def recording(batch, qf, _loss=loss):
            total, losses = _loss(batch, qf)
            local.append(float(total))
            return total, losses

        tr.loss = recording
        metrics = tr.step_multi([clips[rank]])
        out[name] = {"metrics": metrics, "local": local, "digest": tr.replica_digest(),
                     "head": {k: v.clone()
                              for k, v in tr.model.roi_heads.state_dict().items()}}
    return out


def predict(config, opts, frames, out_dir):
    """The port's ``VideoPredictor`` on the group over ``frames``: the untracked
    detections of ``spot_frames``, then ``process_video``'s tracks, the XML written by
    rank 0 alone into ``out_dir``; returns this rank's detections and tracks, and the
    error of a predictor with ``TPU.SPOT_BATCH`` 3."""
    import torch.distributed as dist

    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results

    try:
        VideoPredictor(setup_eval_cfg(config, list(opts) + ["TPU.SPOT_BATCH", "3"]),
                       device="cpu", group=dist.group.WORLD)
        odd_batch = "accepted"
    except ValueError as e:
        odd_batch = str(e)
    cfg = setup_eval_cfg(config, list(opts))
    pred = VideoPredictor(cfg, device="cpu", group=dist.group.WORLD)
    dets = pred.spot_frames([f.copy() for f in frames])
    tracked = pred.process_video([f.copy() for f in frames], window=4)
    if dist.get_rank() == 0:
        os.makedirs(out_dir, exist_ok=True)
        write_video_results(annotate(pred, tracked), os.path.join(out_dir, "video.json"),
                            os.path.join(out_dir, "video.xml"))
    return {"dets": [(d.scores, d.boxes, d.recs) for d in dets],
            "ids": [np.asarray(f.track_ids) for f in tracked], "odd_batch": odd_batch}
