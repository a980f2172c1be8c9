"""Greedy NMS over the query-slot axis as one hand-written kernel (``csrc/nms.cu``).

``GoMatchingModel.detect`` keeps, in each frame of a spot batch, the valid slots that
torchvision's greedy NMS keeps. The plain version (``utils/boxes.nms_mask``, here
``nms_mask_plain``) runs the recurrence as N steps of batched tensor ops, about five
launches a step; the kernel does the whole batch in one launch: ranks by counting, an
IoU bitmask in shared memory, and a one-warp scan (the source's note). It replaces no
TPU kernel: the JAX package's ``nms_mask`` is a ``lax.fori_loop`` left to
XLA. On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises; there is no fallback. Each launch adds one to
``launch_counts[NMS]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..utils.boxes import nms_mask as nms_mask_plain
from .deform_attn import _on_cpu

NMS = "nms_mask"
MAX_N = 1024  # NMS_MAX_N of the .cu file: 32 keep words, one a lane of the scanning warp

# launches of the kernel in this process (plain CPU calls do not count)
launch_counts: Dict[str, int] = {NMS: 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"nms_mask": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _P]}


def reset_launch_counts() -> None:
    launch_counts[NMS] = 0


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """boxes (B, N, 4) xyxy, scores (B, N), valid (B, N) -> keep (B, N) bool, valid and
    kept by greedy NMS at IoU > ``iou_threshold`` (compared in f32, as torch compares an
    f32 tensor with a Python float). The kernel takes float32 boxes and scores, bool
    valid, all contiguous on one CUDA device, and N <= MAX_N."""
    if _on_cpu(boxes, scores, valid):
        return nms_mask_plain(boxes, scores, valid, iou_threshold)
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2] \
            or valid.shape != scores.shape:
        raise ValueError(f"{NMS}: boxes (B, N, 4), scores and valid (B, N) expected, got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{NMS}: boxes and scores must be float32 and valid bool, got "
                        f"{boxes.dtype}, {scores.dtype}, {valid.dtype}")
    B, N = scores.shape
    if N > MAX_N:
        raise ValueError(f"{NMS}: the kernel takes at most {MAX_N} slots a frame, got {N}")
    if not all(t.is_contiguous() for t in (boxes, scores, valid)):
        raise ValueError(f"{NMS}: boxes, scores and valid must be contiguous")
    keep = torch.empty(B, N, dtype=torch.bool, device=boxes.device)  # every slot written
    if B == 0 or N == 0:
        return keep
    from ._build import load

    fn = load("nms.cu", _SIGNATURES).nms_mask
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, N,
                float(iou_threshold), stream)
    if rc != 0:
        raise RuntimeError(f"{NMS}: CUDA launch failed with cudaError {rc}")
    launch_counts[NMS] += 1
    return keep
