"""Test-time frame preprocessing (port of gomatching_tpu/data/preprocess.py:50-89).

detectron2 ``ResizeShortestEdge`` sizing (the reference predictors'
ResizeShortestEdge(MIN_SIZE_TEST, MAX_SIZE_TEST); text_track_visualizer.py:295),
then resize + normalize on the device. Frames arrive BGR uint8 (cv2); INPUT.FORMAT=RGB
flips channels; normalization is (x - PIXEL_MEAN) / PIXEL_STD.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def compute_test_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """ResizeShortestEdge output size (d2 rounding): shorter edge -> ``short``,
    capped so the longer edge <= ``max_size``."""
    scale = short / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    return int(newh + 0.5), int(neww + 0.5)


def device_preprocess(raw_u8: torch.Tensor, target_hw: Tuple[int, int],
                      pixel_mean: Sequence[float], pixel_std: Sequence[float],
                      input_format: str = "RGB") -> torch.Tensor:
    """uint8 BGR (B, H, W, 3) -> normalized float32 (B, h, w, 3) on the same device.

    Bilinear with half-pixel centres and antialiasing: PIL's BILINEAR (the
    reference's resize) widens its triangle filter on downscale, as
    ``F.interpolate(antialias=True)`` does; on upscale antialiasing has no effect.
    The counterpart of ``jax.image.resize(..., antialias=True)``.
    """
    x = raw_u8
    if input_format == "RGB":
        x = x.flip(-1)
    x = x.permute(0, 3, 1, 2).float()  # (B, 3, H, W)
    h, w = target_hw
    if (x.shape[2], x.shape[3]) != (h, w):
        x = F.interpolate(x, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)[None, :, None, None]
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)[None, :, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)
