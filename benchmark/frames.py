"""Seeded synthetic video: a random canvas panning a fixed number of pixels a frame,
so that detections persist from frame to frame and tracks form.

Every seed gets the same multiset of video lengths, in its own order, and its own
canvases; a frame is a view of the video's canvas, made again from (seed, video, frame)
when the comparison needs it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

WARM_UP = 2**31  # the video index of the warm-up video's canvas


def video_order(lengths: Sequence[int], seed: int) -> List[int]:
    """The traffic's video lengths in this seed's order."""
    rng = np.random.default_rng([int(seed), 0])
    return [int(lengths[i]) for i in rng.permutation(len(lengths))]


def canvas(seed: int, video: int, hw) -> np.ndarray:
    """The video's BGR canvas, twice as wide as a frame (two copies side by side)."""
    h, w = hw
    rng = np.random.default_rng([int(seed), 1, int(video)])
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return np.concatenate([base, base], 1)


def frame(canvas_2w: np.ndarray, t: int, pan_px: int) -> np.ndarray:
    """Frame ``t``: the canvas rolled right by ``pan_px * t`` pixels (a view)."""
    w = canvas_2w.shape[1] // 2
    s = (-pan_px * t) % w
    return canvas_2w[:, s:s + w]


def spot_calls(n_frames: int, window: int, batch: int) -> List[tuple]:
    """(first frame, count) of each spot call ``process_video`` makes over a video of
    ``n_frames`` frames: windows of ``window`` frames, each in batches of ``batch``."""
    calls = []
    for w0 in range(0, n_frames, window):
        n = min(window, n_frames - w0)
        for s in range(0, n, batch):
            calls.append((w0 + s, min(batch, n - s)))
    return calls
