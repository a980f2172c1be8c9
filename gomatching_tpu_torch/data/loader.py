"""Training clip loader (port of ``gomatching_tpu/data/loader.py``).

Parity: ``build_vts_train_loader`` and its samplers (gomatching/data/
vts_dataset_dataloader.py:27-159, custom_dataset_dataloader.py:77-151). Videos are the
sampling unit; each step takes one clip (IMS_PER_BATCH / world size is 1 in every
shipped config). Under data parallelism rank r of N takes elements r, r + N, ... of the
one seeded stream of videos, as the reference's samplers do; its clip's augmentation
draws from the mapper's generator, seeded ``SEED + r``.

Samplers: TrainingSampler (a uniform shuffle per epoch, forever), MultiDatasetSampler
(ratio-weighted draws across the dataset sources) and RepeatFactorTrainingSampler
(category-frequency repeat factors, detectron2 semantics). The draws are the JAX
loader's, in the same order. The loader's position and random states are a
``state_dict``, so a resumed run continues the clip sequence where it stopped.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from .datasets import group_by_video, load_video_json, resolve_dataset
from .mapper import ClipMapper, ClipSample


class VideoClipLoader:
    def __init__(self, dataset_names, mapper: ClipMapper, datasets_root: str = "datasets",
                 num_points: int = 25, sampler: str = "TrainingSampler",
                 dataset_ratio: Optional[List[float]] = None, repeat_threshold: float = 0.0,
                 seed: int = 0, rank: int = 0, world_size: int = 1):
        self.mapper = mapper
        self.videos: List[List[Dict]] = []
        self.sources: List[int] = []
        for si, name in enumerate(dataset_names):
            image_root, json_file = resolve_dataset(name, datasets_root)
            records = load_video_json(json_file, image_root, num_points)
            for _, frames in sorted(group_by_video(records).items()):
                self.videos.append(frames)
                self.sources.append(si)
        if not self.videos:
            raise ValueError(f"no videos found for {dataset_names}")
        self.sampler = sampler
        self.rank = rank
        self.world_size = world_size
        self.rng = np.random.RandomState(seed)
        self.weights = None
        if sampler == "MultiDatasetSampler" and dataset_ratio:
            src = np.asarray(self.sources)
            counts = np.bincount(src, minlength=len(dataset_names)).astype(np.float64)
            ratio = np.asarray(dataset_ratio[:len(counts)], np.float64)
            w = ratio[src] / np.maximum(counts[src], 1)
            self.weights = w / w.sum()
        elif sampler == "RepeatFactorTrainingSampler":
            # per-video repeat factor max(1, sqrt(t / f_c)) over the categories it
            # holds, f_c the share of videos holding category c
            cat_count: Dict[int, int] = {}
            vid_cats: List[set] = []
            for frames in self.videos:
                cats = {a.get("category_id", 0) for f in frames
                        for a in f.get("annotations", [])} or {0}
                vid_cats.append(cats)
                for c in cats:
                    cat_count[c] = cat_count.get(c, 0) + 1
            freq = {c: cnt / len(self.videos) for c, cnt in cat_count.items()}
            rf = np.asarray([max(max(1.0, np.sqrt(repeat_threshold / max(freq[c], 1e-9)))
                                 for c in cats) for cats in vid_cats])
            self.weights = rf / rf.sum()
        self._order: Optional[np.ndarray] = None  # the stream's current epoch
        self._pos = 0  # where in it this rank's next video is

    def _epoch(self) -> np.ndarray:
        n = len(self.videos)
        if self.weights is None:
            return self.rng.permutation(n)
        return self.rng.choice(n, size=n, replace=True, p=self.weights)

    def _next_index(self) -> int:
        """This rank's next video: elements rank, rank + world, ... of the one stream of
        epochs that every rank draws from the same seed (detectron2's samplers slice
        their infinite stream so, ``islice(indices, rank, None, world)``); with one rank,
        the JAX loader's sequence."""
        if self._order is None:
            self._order, self._pos = self._epoch(), self.rank
        while self._pos >= len(self._order):
            self._pos -= len(self._order)
            self._order = self._epoch()
        self._pos += self.world_size
        return int(self._order[self._pos - self.world_size])

    def __iter__(self) -> Iterator[ClipSample]:
        while True:
            yield self.mapper(self.videos[self._next_index()])

    def state_dict(self) -> Dict:
        """The sampler's and the mapper's random states and the position in the epoch,
        as plain Python values."""
        def rng_state(rng):
            name, keys, pos, has_gauss, cached = rng.get_state()
            return [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]

        return {"rng": rng_state(self.rng), "mapper_rng": rng_state(self.mapper.rng),
                "order": None if self._order is None else self._order.tolist(),
                "pos": self._pos}

    def load_state_dict(self, state: Dict) -> None:
        for rng, (name, keys, pos, has_gauss, cached) in (
                (self.rng, state["rng"]), (self.mapper.rng, state["mapper_rng"])):
            rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, cached))
        order = state["order"]
        self._order = None if order is None else np.asarray(order, np.int64)
        self._pos = int(state["pos"])


def build_train_loader(cfg, rank: int = 0, world_size: int = 1) -> VideoClipLoader:
    mapper = ClipMapper(
        train_size=cfg.INPUT.TRAIN_SIZE, scale_range=cfg.INPUT.SCALE_RANGE,
        train_len=cfg.INPUT.VIDEO.TRAIN_LEN, sample_range=cfg.INPUT.VIDEO.SAMPLE_RANGE,
        dynamic_scale=cfg.INPUT.VIDEO.DYNAMIC_SCALE,
        gen_image_motion=cfg.INPUT.VIDEO.GEN_IMAGE_MOTION,
        not_clamp_box=cfg.INPUT.NOT_CLAMP_BOX, input_format=cfg.INPUT.FORMAT,
        train_h=cfg.INPUT.TRAIN_H, train_w=cfg.INPUT.TRAIN_W,
        num_points=cfg.MODEL.TRANSFORMER.NUM_POINTS,
        seed=cfg.SEED + rank if cfg.SEED >= 0 else None,
    )
    return VideoClipLoader(
        cfg.DATASETS.TRAIN, mapper, num_points=cfg.MODEL.TRANSFORMER.NUM_POINTS,
        sampler=("MultiDatasetSampler" if cfg.DATALOADER.SOURCE_AWARE
                 else cfg.DATALOADER.SAMPLER_TRAIN),
        dataset_ratio=cfg.DATALOADER.DATASET_RATIO,
        repeat_threshold=cfg.DATALOADER.REPEAT_THRESHOLD,
        seed=max(cfg.SEED, 0), rank=rank, world_size=world_size,
    )
