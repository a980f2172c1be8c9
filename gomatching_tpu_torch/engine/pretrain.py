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

Video pretraining (TransformerPureVideoDetector) batches a clip's frames through the same
step with each frame's true size (``image_hw``): the spotter then sees padding masks, its
encoder samples through B1 and differentiates through B3 (the unmasked encoder of image
pretraining takes B2 and B4). A uint8 clip (``TPU.TRAIN_UPLOAD_UINT8``) is normalized on
the device with its padding zeroed again, as JAX's ``_forward`` does (pretrain.py:138-151).
A Swin trunk with ``SWIN.DROP_PATH_RATE`` > 0 draws its drop-path from a
``torch.Generator`` seeded anew each step from (23, step), where JAX folds the step into
``PRNGKey(23)`` (:168-173): the same schedule of randomness, other bits.
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
from .train import normalize_wire_frames

DROP_PATH_SEED = 23  # JAX's PRNGKey(23), pretrain.py:170


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


def build_video_spotter_targets(sample, max_gt: int, num_points: int, voc_size: int):
    """Per-frame padded SpotterCriterion targets of a video ``ClipSample``
    (``data/mapper.py``), stacked on the frame axis: a dict of (T, max_gt, ...) arrays
    (JAX ``build_video_spotter_targets``, pretrain.py:57-95). The reference's video
    pretraining meta-arch (video_text_spotter.py:106) is the image one with a clip's
    frames as its batch. Coordinates are normalized by each frame's size, which for a
    video clip is ``sample.image_hw``, JAX's divisor; the mapper's boundary rows
    (2 * npts, 2) become the loss's (npts, 4) (top xy, bottom xy)."""
    T = len(sample.images)
    t_len = (sample.gt_texts[0].shape[1]
             if len(sample.gt_texts) and np.ndim(sample.gt_texts[0]) == 2 else 25)
    out = {
        "valid": np.zeros((T, max_gt), bool),
        "labels": np.zeros((T, max_gt), np.int32),
        "ctrl_points": np.zeros((T, max_gt, num_points, 2), np.float32),
        "bd_points": np.zeros((T, max_gt, num_points, 4), np.float32),
        "texts": np.full((T, max_gt, t_len), voc_size, np.int32),
        "beziers": np.zeros((T, max_gt, 4, 2), np.float32),
    }
    for t, img in enumerate(sample.images):
        h, w = img.shape[:2]
        wh = np.asarray([w, h], np.float32)
        for i in range(min(len(sample.gt_ctrl[t]), max_gt)):
            out["valid"][t, i] = True
            out["ctrl_points"][t, i] = sample.gt_ctrl[t][i] / wh
            out["bd_points"][t, i] = (sample.gt_boundary[t][i].reshape(num_points, 4)
                                      / np.concatenate([wh, wh]))
            out["texts"][t, i] = sample.gt_texts[t][i]
            out["beziers"][t, i] = sample.gt_beziers[t][i] / wh
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
        self.pixel_mean = list(cfg.MODEL.PIXEL_MEAN)
        self.pixel_std = list(cfg.MODEL.PIXEL_STD)
        self.use_drop_path = (cfg.MODEL.BACKBONE.NAME == "build_swin_backbone"
                              and cfg.MODEL.SWIN.DROP_PATH_RATE > 0.0)
        self.step_count = 0

    def drop_path_generator(self) -> Optional[torch.Generator]:
        """This step's drop-path random source, or None when nothing drops."""
        if not self.use_drop_path:
            return None
        gen = torch.Generator(device=self.device)
        return gen.manual_seed((DROP_PATH_SEED << 32) + self.step_count)

    def image_hw(self, image_hw) -> Optional[torch.Tensor]:
        """The frames' true (h, w) (B, 2) on the device, or None."""
        return None if image_hw is None else torch.as_tensor(
            np.asarray(image_hw, np.float32)).to(self.device)

    def to_device(self, images: np.ndarray, targets: Dict, image_hw=None
                  ) -> Tuple[torch.Tensor, Dict]:
        """(B, H, W, 3) images and padded numpy targets -> tensors. Float images are taken
        as normalized; uint8 images are normalized on the device, their padding zeroed
        again from ``image_hw`` (B, 2), the frames' true (h, w)."""
        dev = self.device
        hw = self.image_hw(image_hw)
        if np.asarray(images).dtype == np.uint8:
            imgs = normalize_wire_frames(torch.from_numpy(np.ascontiguousarray(images)).to(dev),
                                         self.pixel_mean, self.pixel_std, hw)
        else:
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

    def forward_backward(self, images: torch.Tensor, targets: Dict,
                         image_hw: Optional[torch.Tensor] = None):
        """Forward, costs, host Hungarian, losses and backward; leaves the gradients in
        ``.grad``. ``image_hw`` (B, 2): the frames' true sizes, which mask the padding.
        Returns (losses incl. 'total_loss', as tensors; matches)."""
        t0 = time.perf_counter()
        out = self.model(images, image_hw, self.drop_path_generator())
        t0 = self._mark("forward", t0)
        costs = {k: (c.cpu().numpy(), nv.cpu().numpy())
                 for k, (c, nv) in self.criterion.costs(out, targets).items()}
        t0 = self._mark("costs", t0)
        matches = {k: torch.from_numpy(solve_padded(c, nv)).to(self.device)
                   for k, (c, nv) in costs.items()}
        t0 = self._mark("hungarian", t0)
        # a clip may hold frames without text: JAX divides by max(num_inst, 1)
        losses = self.criterion(out, targets,
                                num_inst=targets["valid"].sum().float().clamp(min=1.0),
                                matches=matches)
        total = torch.stack(list(losses.values())).sum()
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        losses["total_loss"] = total
        self._mark("loss+backward", t0)
        return losses, matches

    def step(self, images: np.ndarray, targets: Dict, image_hw=None) -> Dict[str, float]:
        """One full-model training step on host arrays; returns the float losses.
        ``image_hw`` (B, 2): each frame's true (h, w) on the padded canvas (video
        pretraining), or None (image pretraining: nothing padded)."""
        imgs, tg = self.to_device(images, targets, image_hw)
        losses, _ = self.forward_backward(imgs, tg, self.image_hw(image_hw))
        t0 = time.perf_counter()
        if self.max_norm is not None:
            clip_by_global_norm_(self.model.parameters(), self.max_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.step_count += 1
        values = torch.stack([v.detach() for v in losses.values()]).cpu().tolist()
        self._mark("clip+update", t0)
        return dict(zip(losses, values))
