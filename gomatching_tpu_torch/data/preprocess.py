"""Test-time frame preprocessing (port of gomatching_tpu/data/preprocess.py:50-137).

detectron2 ``ResizeShortestEdge`` sizing (the reference predictors'
ResizeShortestEdge(MIN_SIZE_TEST, MAX_SIZE_TEST); text_track_visualizer.py:295),
then resize + normalize on the device. Frames arrive BGR uint8 (cv2); INPUT.FORMAT=RGB
flips channels; normalization is (x - PIXEL_MEAN) / PIXEL_STD.

The I420 wire (``TPU.UPLOAD_FORMAT`` / ``TPU.TRAIN_UPLOAD_FORMAT`` yuv420): the host
encodes frames to planar I420 with cv2 (``encode_i420``, half the bytes of BGR) and the
device decodes them back to BGR (``decode_i420``), with the JAX package's codec.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
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
    """BGR (B, H, W, 3), uint8 or float in [0, 255] (an I420 frame decoded by
    ``decode_i420``) -> normalized float32 (B, h, w, 3) on the same device.

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


def encode_i420(batch_u8: np.ndarray) -> np.ndarray:
    """HOST: BGR uint8 (B, H, W, 3) -> planar I420 (B, H*3//2, W) uint8 with cv2's
    BGR2YUV_I420 (studio-swing BT.601; JAX preprocess.py:92-109). H and W must be even."""
    import cv2

    return np.stack([cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_BGR2YUV_I420)
                     for f in batch_u8])


def decode_i420(yuv_u8: torch.Tensor) -> torch.Tensor:
    """DEVICE: planar I420 (B, H*3//2, W) uint8 -> BGR float32 (B, H, W, 3) in [0, 255],
    rounded: the inverse of cv2's studio-swing BT.601 with nearest (2x) chroma, as
    cv2.COLOR_YUV2BGR_I420 upsamples (JAX preprocess.py:111-137).

    Each chroma term is a fused multiply-add rounded once to f32, as XLA compiles JAX's
    ``yf + c * v``: computed in float64, where the product of an 8-bit integer and an f32
    constant plus an f32 is exact, then rounded to f32. So the port gives the same bits on
    every device (an unfused f32 sum lands on the other side of a .5 for about 1 value in
    30000)."""
    B, h32, W = yuv_u8.shape
    H = h32 * 2 // 3
    y = yuv_u8[:, :H].double()
    # split the chroma by bytes, not buffer rows: for H % 4 != 0 the U plane ends
    # mid-row of the (H*3/2, W) buffer
    nc = H * W // 4
    chroma = yuv_u8[:, H:].reshape(B, 2 * nc)
    u = chroma[:, :nc].reshape(B, H // 2, W // 2).double()
    v = chroma[:, nc:].reshape(B, H // 2, W // 2).double()
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0

    def f32(x):  # round to f32, kept in float64 for the next exact step
        return torch.as_tensor(x, dtype=torch.float32).double()

    def fma(a, c, acc):  # a * c + acc, rounded once to f32
        return f32(a * f32(c) + acc)

    yf = f32((y - 16.0) * f32(1.1644))
    r = fma(v, 1.5960, yf)
    g = fma(v, -0.8130, fma(u, -0.3918, yf))
    b = fma(u, 2.0172, yf)
    return torch.stack([b, g, r], -1).float().round().clamp(0.0, 255.0)
