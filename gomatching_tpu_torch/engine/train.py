"""GoMatching tracker training: freeze partition, the three-phase step (port of
``gomatching_tpu/engine/train.py``).

Parity targets (as the JAX package realizes them):
  - ``check_if_freeze_model`` (gomatching/modeling/freeze_layers.py:3-172) as JAX
    ``split_params`` (:77-106) partitions the model: ExceptROIheads / ExceptROIheadsID
    train ``roi_heads`` (the GoMatching recipe), ROIheads everything else, Backbone /
    BackboneBottomup all but the trunk, '' everything; the cascade policies raise. The
    trainable part requires grad and enters the optimizer. The spot is detached, so the
    tracker losses reach only ``roi_heads``: a trainable spotter parameter gets a zero
    gradient each step, which AdamW's decoupled decay alone moves (``optax.adamw``
    updates every leaf of its tree), with its moments staying 0;
  - ``build_custom_optimizer`` (costom_solver.py:20-77) through ``engine/optim.py``:
    AdamW, WarmupCosineLR, and the full-model clip over the trainable parameters only,
    before AdamW, as the optax chain of JAX ``build_optimizer`` :174-226 runs it;
  - the training forward of ``GoMatching.forward`` (gom_lstmatcher.py:213-266): the
    frozen spotter under ``torch.no_grad()`` -> rescore + loss_res -> thresholded
    proposals -> long and short association losses.

One ``Trainer.step``:
  1. spot: the whole clip in one detached forward (its deformable sampling on the B1/B2
     kernels on CUDA) with the CURRENT parameters: ``re_pred_logits`` from the rescoring
     head, and a trainable spotter's decayed weights; the fields the host phase reads
     come back in one copy. Under ``MODEL.PRECISION`` bfloat16 the frozen members of
     ``backbone`` and ``detection_transformer`` run in bf16, exactly as in production
     inference when both are frozen, and every trainable part in f32 (JAX
     train.py:246-260), a bf16 output promoted where it meets f32 weights; a clip on the
     I420 wire
     (``TPU.TRAIN_UPLOAD_FORMAT`` yuv420, ``encode_train_clip``) is decoded, put in
     ``INPUT.FORMAT``'s channel order and normalized on the device (:295-312);
  2. host: score fusion, the two thresholds, boxes, the 4GM Hungarian
     (``match_rescore``) and the association targets, all numpy (``prepare_batch``);
  3. update: the losses on the spot's query features, backward into ``roi_heads``,
     clip, AdamW and the LR schedule; the losses come back in one copy.
``phase_t`` holds each step's host wall by phase; each phase ends in a copy to the host,
so the device has finished its work when the phase's clock stops.

``Trainer.step_multi`` is JAX's data-parallel step (train.py:648-728): several clips on
one padded canvas and frame count, their padding frames masked by ``frame_valid``, the
loss the mean over clips of each clip's loss (each normalized by its own ``num_inst``).
With a process group of N ranks, each holding as many clips, the gradient and the losses
are then averaged over the ranks in one all-reduce, before the clip and AdamW, so N ranks
of one clip each compute what one process computes with all N clips.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..data.preprocess import decode_i420, encode_i420
from ..models.gomatching import FROZEN_SUBMODULES, build_model, compute_dtype
from ..models.resnet import FrozenBN
from ..parallel.mesh import all_reduce_mean_, gather_objects, host_group, rank_and_world
from ..weights import init_weights_, load_weights
from .losses import asso_ce_loss, build_asso_targets, match_rescore, rescore_loss
from .optim import build_optimizer, clip_by_global_norm_, clip_max_norm

DROPOUT_KEY = 17  # JAX folds the step into PRNGKey(17) for the matchers' dropout


def clip_dropout_seed(step: int, clip: int) -> int:
    """The dropout seed of a clip in a data-parallel step, from (17, step, the clip's
    index over all ranks): JAX folds the clip index into ``fold_in(PRNGKey(17), step)``
    (train.py:661-667); the bits differ, the schedule of randomness is the same."""
    return int(np.random.SeedSequence([DROPOUT_KEY, step, clip]).generate_state(1)[0])

# FREEZE_TYPEs that train only the tracker head (freeze_layers.py:3-37; identical for
# this architecture); every shipped config sets one of them
ROI_HEADS_ONLY = ("ExceptROIheads", "ExceptROIheadsID")
SUBMODULES = ("backbone", "detection_transformer", "roi_heads")


def trainable_submodules(freeze_type: str) -> Tuple[str, ...]:
    """The top-level submodules a FREEZE_TYPE trains (JAX ``split_params``,
    train.py:77-106). The cascade-classifier policies (freeze_layers.py:75-137) name a
    CenterNet2 ``roi_heads.box_predictor`` the GoMatching architecture lacks, and raise
    as in JAX."""
    if freeze_type in ROI_HEADS_ONLY:
        return ("roi_heads",)
    if freeze_type == "ROIheads":
        return ("backbone", "detection_transformer")
    if freeze_type in ("Backbone", "BackboneBottomup"):
        return ("detection_transformer", "roi_heads")
    if freeze_type == "":
        return SUBMODULES
    raise NotImplementedError(
        f"MODEL.FREEZE_TYPE={freeze_type!r} targets CenterNet2 submodules absent from the "
        "GoMatching architecture")


def freeze_partition(model: nn.Module, freeze_type: str) -> List[str]:
    """Leave the parameters of the submodules ``freeze_type`` trains requiring grad, the
    rest not; return the names of the trainable ones. A trainable trunk's FrozenBN tensors
    become parameters, as they are in JAX's tree (and so decay like its other leaves)."""
    train = trainable_submodules(freeze_type)
    if "backbone" in train:
        for mod in model.backbone.modules():
            if isinstance(mod, FrozenBN) and "weight" in mod._buffers:
                mod.make_trainable_()
    names = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] in train)
        if p.requires_grad:
            names.append(name)
    return names


def encode_train_clip(images_u8: np.ndarray, input_format: str = "RGB") -> np.ndarray:
    """HOST: a uint8 clip (T, H, W, 3) in ``input_format``'s channel order -> planar I420
    (T, H*3//2, W) for the ``TPU.TRAIN_UPLOAD_FORMAT`` yuv420 wire (JAX train.py:63-75).
    The clip comes back unchanged when a side is odd; ``Trainer.spot`` tells the two
    apart by their rank."""
    h, w = images_u8.shape[1:3]
    if h % 2 or w % 2:
        return images_u8
    x = images_u8[..., ::-1] if input_format == "RGB" else images_u8
    return encode_i420(np.ascontiguousarray(x))


def normalize_wire_frames(images: torch.Tensor, pixel_mean: Sequence[float],
                          pixel_std: Sequence[float],
                          image_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 frames (B, H, W, 3) -> normalized float32 on their device, the padding of
    the canvas zeroed again from ``image_hw`` (B, 2) true (h, w): the reference's order,
    normalize per image then zero-pad (gom_lstmatcher.py:159-169; JAX train.py:41)."""
    x = images.float()
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if image_hw is not None:
        _, h, w = x.shape[:3]
        hw = image_hw.float()
        rows = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
        cols = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
        valid = (rows < hw[:, 0, None, None]) & (cols < hw[:, 1, None, None])
        x = x * valid[..., None].float()
    return x


def decode_wire(images: torch.Tensor, input_format: str, pixel_mean: Sequence[float],
                pixel_std: Sequence[float], image_hw: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """A planar I420 training clip (T, H*3//2, W) uint8 -> normalized float32 frames
    (T, H, W, 3) on its device: decoded to BGR, put in ``input_format``'s channel order,
    then normalized with the padding zeroed again (JAX ``Trainer._decode_wire``,
    train.py:295-305)."""
    x = decode_i420(images)
    if input_format == "RGB":
        x = x.flip(-1)
    return normalize_wire_frames(x, pixel_mean, pixel_std, image_hw)


# the spot fields the host phase reads, in their order on the packed copy's last axis
_HOST_FIELDS = ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points")


class Trainer:
    """GoMatching tracker training on one device, the spotter frozen.

    ``device``: None runs on the current CUDA device and raises when there is none; pass
    ``"cpu"`` to run on the CPU. ``state_dict``: reference-keyed weights of the whole
    model; by default seeded random weights (``SEED``, 0 when negative). ``group``: a
    ``torch.distributed`` process group whose ranks train one replica each
    (``step_multi``); every rank must start from the same weights, which is checked.
    """

    def __init__(self, cfg, state_dict=None, device=None, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        model = build_model(cfg)
        if state_dict is None:
            init_weights_(model, torch.Generator().manual_seed(max(int(cfg.SEED), 0)))
        else:
            load_weights(model, state_dict)
        self.trainable_names = freeze_partition(model, cfg.MODEL.FREEZE_TYPE)
        train = trainable_submodules(cfg.MODEL.FREEZE_TYPE)
        # the spot runs in eval mode; the head in train mode (its dropout)
        self.model = model.to(self.device).eval()
        self.model.roi_heads.train()
        # MODEL.PRECISION casts the FROZEN members of backbone and detection_transformer
        # (JAX train.py:253-260): each keeps its f32 originals, which checkpoints hold
        # (frozen_f32); a trainable part stays f32. The trainer reads none of the
        # inference keys (TPU.ASSOC_PRECISION, TPU.UPLOAD_FORMAT), as JAX's does not
        dtype = compute_dtype(cfg)
        self.cast_members = tuple(k for k in FROZEN_SUBMODULES if k not in train)
        self.frozen_f32: Optional[Dict[str, torch.Tensor]] = None
        if dtype != torch.float32:
            self.frozen_f32 = {k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()
                               if k.split(".")[0] in self.cast_members}
        self.model.cast_frozen_(dtype, self.cast_members)
        self.input_format = cfg.INPUT.FORMAT  # channel order of the clips
        named = dict(self.model.named_parameters())
        self.trainable = [named[n] for n in self.trainable_names]
        self.optimizer, self.scheduler = build_optimizer(cfg, self.model)
        self.max_norm = clip_max_norm(cfg)
        a, t = cfg.MODEL.ASSO_HEAD, cfg.MODEL.TRANSFORMER
        self.asso_thresh = a.ASSO_THRESH
        self.train_thresh = t.INFERENCE_TH_TRAIN
        self.asso_weight = a.ASSO_WEIGHT
        self.asso_weight_local = a.ASSO_WEIGHT_LOCAL
        self.neg_unmatched = a.NEG_UNMATCHED
        self.focal_alpha = t.LOSS.FOCAL_ALPHA
        self.focal_gamma = t.LOSS.FOCAL_GAMMA
        self.with_rescore = cfg.MODEL.ROI_HEADS.WITH_RESR
        # with NO_POS_EMB False the reference applies the interpolated box (+ temporal)
        # embeddings in forward_train too (_forward_transformer, lstmatcher.py:338-346)
        self.use_pos_emb = not a.NO_POS_EMB
        self.with_temp_emb = a.WITH_TEMP_EMB
        self.pixel_mean = list(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = list(cfg.MODEL.PIXEL_STD)
        self.step_count = 0
        self.phase_t: Dict[str, float] = {}  # the last step's host wall by phase
        self.last_batches: List[Dict[str, np.ndarray]] = []  # its host-built batches
        if group is not None:
            digests = gather_objects(self.replica_digest(), host_group(group))
            if len(set(digests)) != 1:
                raise ValueError("the ranks start from different trainable weights")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def spot(self, images: np.ndarray, image_hw: Optional[np.ndarray] = None
             ) -> Dict[str, Optional[torch.Tensor]]:
        """The frozen spot forward of a clip on the device: uint8 frames (T, H, W, 3) are
        normalized there and their padding zeroed from ``image_hw`` (T, 2); a uint8 I420
        clip (T, H*3//2, W) is decoded to BGR, put in ``INPUT.FORMAT``'s order and then
        treated the same (JAX ``_decode_wire``, train.py:295-305); float frames are taken
        as normalized. ``image_hw`` None: no padding masks."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        hw = None if image_hw is None else torch.from_numpy(
            np.asarray(image_hw, np.float32)).to(self.device)
        if x.ndim == 3:
            x = decode_wire(x, self.input_format, self.pixel_mean, self.pixel_std, hw)
        elif x.dtype == torch.uint8:
            x = normalize_wire_frames(x, self.pixel_mean, self.pixel_std, hw)
        return self.model.spot(x, hw)

    def host_fields(self, spot_out: Dict) -> Dict[str, Optional[np.ndarray]]:
        """The fields ``prepare_batch`` reads, copied to the host in one transfer."""
        fields = [f for f in _HOST_FIELDS if spot_out.get(f) is not None]
        packed = torch.cat([spot_out[f].float() for f in fields], -1).cpu().numpy()
        out: Dict[str, Optional[np.ndarray]] = dict.fromkeys(_HOST_FIELDS)
        pos = 0
        for f in fields:
            n = spot_out[f].shape[-1]
            out[f] = packed[..., pos:pos + n]
            pos += n
        return out

    def prepare_batch(self, spot_out: Dict[str, Optional[np.ndarray]], targets: Dict,
                      frame_valid: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Host phase (JAX train.py:456): score fusion, the proposal thresholds, boxes,
        the rescore Hungarian and the association targets. ``frame_valid`` (T,) marks the
        real frames of a clip padded to a longer one (``step_multi``): the padding
        frames' proposals are dropped, and with no GT they add nothing to any loss."""
        logits = np.asarray(spot_out["pred_logits"], np.float32)  # (T, nq, npts, 1)
        T, nq = logits.shape[:2]
        scores = 1 / (1 + np.exp(-logits.mean(2)[..., 0]))
        re = None
        fused = scores
        if self.with_rescore and spot_out["re_pred_logits"] is not None:
            re = np.asarray(spot_out["re_pred_logits"], np.float32)
            fused = np.maximum(scores, 1 / (1 + np.exp(-re.mean(2)[..., 0])))
        # the detection threshold then the association threshold (gom_lstmatcher.py:608,
        # lstmatcher.py:276-278)
        prop_valid = (fused > self.train_thresh) & (fused > self.asso_thresh)
        if frame_valid is not None:
            prop_valid &= np.asarray(frame_valid, bool)[:, None]
        # boxes from the boundary points' extremes, normalized
        pts = np.asarray(spot_out["pred_bd_points"], np.float32).reshape(T, nq, -1, 2)
        boxes = np.stack([pts[..., 0].min(-1), pts[..., 1].min(-1), pts[..., 0].max(-1),
                          pts[..., 1].max(-1)], axis=-1)
        num_inst = max(sum(len(g) for g in targets["gt_ctrl"]), 1)

        res_match_mask = np.zeros((T, nq), np.float32)
        if re is not None:
            # the 4GM matcher cost with the configured weights (matcher.py:255-261)
            lw = self.cfg.MODEL.TRANSFORMER.LOSS
            matches = match_rescore(
                re, np.asarray(spot_out["pred_ctrl_points"]), targets["gt_ctrl"],
                class_weight=lw.POINT_CLASS_WEIGHT, coord_weight=lw.POINT_COORD_WEIGHT,
                focal_alpha=lw.FOCAL_ALPHA, focal_gamma=lw.FOCAL_GAMMA)
            for t, (qi, _) in enumerate(matches):
                res_match_mask[t, qi] = 1.0

        asso_gt, match_cues, track_valid = build_asso_targets(
            boxes, prop_valid, targets["gt_boxes"], targets["gt_ids"], nq)
        asso_gt_pairs = np.zeros((max(T - 1, 1), nq, 2), np.int64)
        track_valid_pairs = np.zeros((max(T - 1, 1), nq), bool)
        for t in range(T - 1):
            asso_gt_pairs[t], _, track_valid_pairs[t] = build_asso_targets(
                boxes[t:t + 2], prop_valid[t:t + 2], targets["gt_boxes"][t:t + 2],
                targets["gt_ids"][t:t + 2], nq)
        out = {
            "prop_valid": prop_valid,
            "res_match_mask": res_match_mask,
            "num_inst": np.float32(num_inst),
            "asso_gt": asso_gt,
            "match_cues": match_cues,
            "track_valid": track_valid,
            "asso_gt_pairs": asso_gt_pairs,
            "track_valid_pairs": track_valid_pairs,
        }
        if self.use_pos_emb:
            # normalized xyxy proposal boxes and frame-time fractions for the
            # interpolated positional embeddings
            out["prop_boxes"] = np.asarray(boxes, np.float32)
            out["prop_times"] = np.broadcast_to(
                (np.arange(T, dtype=np.float32) / T)[:, None], (T, nq)).copy()
        return out

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.dtype.kind in "iu":
                v = v.astype(np.int64)
            elif v.dtype.kind == "f":
                v = v.astype(np.float32)
            out[k] = torch.as_tensor(v).to(self.device)
        return out

    # ------------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor], query_features: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The tracker losses of one clip (JAX ``_loss_fn`` :342) on the spot's query
        features (T, nq, npts, C): the rescore focal loss, reid over every slot, the
        long pass over all T * nq tokens and the T - 1 adjacent-pair short passes, each
        with ASSO_HEAD.DROPOUT in the matchers."""
        model = self.model
        head = model.roi_heads
        qf = query_features.float()  # bf16 from a bf16 spotter; the head is f32
        T, nq = qf.shape[:2]
        pv = batch["prop_valid"]
        losses: Dict[str, torch.Tensor] = {}
        if self.with_rescore:
            losses["loss_res"] = rescore_loss(head.rescore(qf), batch["res_match_mask"],
                                              batch["num_inst"], self.focal_alpha,
                                              self.focal_gamma)
        reid = head.reid(qf)  # (T, nq, F)
        boxes = batch["prop_boxes"] if self.use_pos_emb else None  # (T, nq, 4)
        times = batch["prop_times"] if self.use_pos_emb and self.with_temp_emb else None

        long_logits = model.associate(
            reid.reshape(1, T * nq, -1), pv.reshape(1, T * nq), False,
            None if boxes is None else boxes.reshape(1, T * nq, 4),
            None if times is None else times.reshape(1, T * nq), train=True)
        loss_long = asso_ce_loss(long_logits.reshape(T * nq, T, nq), pv.reshape(-1), pv,
                                 batch["asso_gt"], batch["match_cues"].reshape(-1),
                                 batch["track_valid"], self.neg_unmatched)
        losses["loss_long_asso"] = self.asso_weight * loss_long

        # a 2-frame pass has time fractions (0, 1/2), like the inference tracker's
        # pos inputs over [prev, cur]
        pair_times = None if times is None else torch.cat(
            [qf.new_zeros(nq), qf.new_full((nq,), 0.5)]).reshape(1, 2 * nq)
        loss_short = qf.new_zeros(())
        for t in range(T - 1):
            lg = model.associate(
                reid[t:t + 2].reshape(1, 2 * nq, -1), pv[t:t + 2].reshape(1, 2 * nq), True,
                None if boxes is None else boxes[t:t + 2].reshape(1, 2 * nq, 4),
                pair_times, train=True)
            loss_short = loss_short + asso_ce_loss(
                lg.reshape(2 * nq, 2, nq), pv[t:t + 2].reshape(-1), pv[t:t + 2],
                batch["asso_gt_pairs"][t], batch["match_cues"][t:t + 2].reshape(-1),
                batch["track_valid_pairs"][t], self.neg_unmatched)
        losses["loss_short_asso"] = self.asso_weight_local * loss_short / max(T - 1, 1)
        total = sum(losses.values())
        return total, losses

    def update(self, batch: Dict[str, np.ndarray], query_features: torch.Tensor
               ) -> Dict[str, float]:
        """Loss, backward into roi_heads, the clip over the trainable parameters, AdamW
        and the LR schedule; returns the losses (one copy to the host)."""
        total, losses = self.loss(self.to_device(batch), query_features)
        self.optimizer.zero_grad(set_to_none=True)
        if total.requires_grad:  # under FREEZE_TYPE ROIheads no loss reaches a trainable one
            total.backward()
        losses["total_loss"] = total
        values = torch.stack([v.detach() for v in losses.values()])
        self.apply_gradients(values)
        return dict(zip(losses, values.cpu().tolist()))

    def apply_gradients(self, losses: torch.Tensor) -> float:
        """The tail of every update, after ``backward()``: a zero gradient for each
        trainable parameter the losses did not reach (optax updates every trainable leaf,
        so weight decay still applies to the detached spot's, or to the head's beyond
        this clip), under a process group one all-reduce averaging the gradients and
        ``losses`` in place over the ranks, then the global-norm clip, AdamW and the LR
        schedule (JAX's ``tx`` chain). Returns the all-reduce's host wall (0 without a
        group)."""
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        allreduce_s = 0.0
        if self.group is not None:
            self._sync()
            t0 = time.perf_counter()
            all_reduce_mean_([p.grad for p in self.trainable] + [losses], self.group)
            self._sync()
            allreduce_s = time.perf_counter() - t0
        if self.max_norm is not None:
            clip_by_global_norm_(self.trainable, self.max_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.step_count += 1
        return allreduce_s

    def step(self, images: np.ndarray, image_hw: Optional[np.ndarray], targets: Dict
             ) -> Dict[str, float]:
        """One training iteration on one clip: spot, host phase, update. JAX's
        single-device ``step``, which the one-rank loop keeps: its dropout draws from one
        generator that persists across steps (and a resumed run's state), where
        ``step_multi`` seeds one per clip from the step and the clip's index."""
        t0 = time.perf_counter()
        spot_out = self.spot(images, image_hw)
        host = self.host_fields(spot_out)
        t1 = time.perf_counter()
        batch = self.prepare_batch(host, targets)
        self.last_batches = [batch]
        t2 = time.perf_counter()
        metrics = self.update(batch, spot_out["query_features"])
        t3 = time.perf_counter()
        self.phase_t = {"spot": t1 - t0, "host": t2 - t1, "update": t3 - t2}
        return metrics

    def step_multi(self, clips: Sequence[Tuple[np.ndarray, Optional[np.ndarray], Dict]]
                   ) -> Dict[str, float]:
        """One data-parallel iteration over this process's ``clips``, each (images,
        image_hw or None, targets) on one canvas and frame count (the caller pads; a
        ``targets["frame_valid"]`` masks the padding frames). The loss is the mean over
        the clips of each clip's loss; under a process group the gradient of that mean
        and the losses are averaged over the ranks (all holding as many clips) before the
        global-norm clip and AdamW (JAX ``step_multi``, train.py:686-728, and its
        ``_sharded_update_fn``). Returns the losses averaged over every clip of every
        rank. ``image_hw`` None: each frame fills the canvas (JAX :700-706)."""
        rank = rank_and_world(self.group)[0] if self.group is not None else 0
        t0 = time.perf_counter()
        spots = []
        for images, image_hw, _ in clips:
            if image_hw is None and np.ndim(images) == 4:
                image_hw = np.tile(np.asarray(images.shape[1:3], np.float32)[None],
                                   (len(images), 1))
            out = self.spot(images, image_hw)
            spots.append((out["query_features"], self.host_fields(out)))
        t1 = time.perf_counter()
        batches = [self.prepare_batch(host, targets, frame_valid=targets.get("frame_valid"))
                   for (_, host), (_, _, targets) in zip(spots, clips)]
        self.last_batches = batches
        t2 = time.perf_counter()
        n = len(clips)
        head = self.model.roi_heads
        self.optimizer.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for i, ((qf, _), batch) in enumerate(zip(spots, batches)):
            head.dropout_generator = torch.Generator(device=self.device).manual_seed(
                clip_dropout_seed(self.step_count, rank * n + i))
            total, losses = self.loss(self.to_device(batch), qf)
            if total.requires_grad:
                (total / n).backward()
            losses["total_loss"] = total
            for k, v in losses.items():
                sums[k] = sums.get(k, 0) + v.detach()
        means = torch.stack([v / n for v in sums.values()])
        allreduce_s = self.apply_gradients(means)
        metrics = dict(zip(sums, means.cpu().tolist()))
        t3 = time.perf_counter()
        self.phase_t = {"spot": t1 - t0, "host": t2 - t1, "update": t3 - t2 - allreduce_s,
                        "allreduce": allreduce_s}
        return metrics

    @property
    def last_batch(self) -> Dict[str, np.ndarray]:
        """The host-built batch of the last step's (last) clip."""
        return self.last_batches[-1]

    def _sync(self) -> None:
        """Wait for the device, so that a phase's clock stops when its work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def replica_digest(self) -> str:
        """A digest of the trainable parameters' bytes: equal on two replicas only when
        their weights are the same bits."""
        h = hashlib.sha256()
        for p in self.trainable:
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    # ------------------------------------------------------------------
    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state_dict for a checkpoint, the frozen spotter in the f32 it
        was loaded in (JAX train_net.py:386-394 saves ``frozen_f32``)."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        if self.frozen_f32 is not None:
            sd.update(self.frozen_f32)
        return sd

    def state_dict(self) -> Dict:
        """What a resumed run needs: the head, the trainable parameters outside it (a
        FREEZE_TYPE that trains the spotter: they decay each step), the optimizer and
        schedule, the step and the dropout generator's state."""
        gen = self.model.roi_heads.dropout_generator
        named = dict(self.model.named_parameters())
        return {
            "step": self.step_count,
            "roi_heads": {k: v.detach().cpu() for k, v in
                          self.model.roi_heads.state_dict().items()},
            "spotter": {n: named[n].detach().cpu() for n in self.trainable_names
                        if not n.startswith("roi_heads.")},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "dropout_rng": None if gen is None else gen.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.model.roi_heads.load_state_dict(state["roi_heads"], strict=True)
        named = dict(self.model.named_parameters())
        spotter = state.get("spotter", {})
        if set(spotter) != {n for n in self.trainable_names if not n.startswith("roi_heads.")}:
            raise ValueError("the train state's trainable spotter parameters are not this "
                             "trainer's (another MODEL.FREEZE_TYPE?)")
        for n, v in spotter.items():
            named[n].copy_(v)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step_count = int(state["step"])
        if state.get("dropout_rng") is not None:
            head = self.model.roi_heads
            head.dropout_generator = torch.Generator(device=self.device)
            head.dropout_generator.set_state(state["dropout_rng"])
