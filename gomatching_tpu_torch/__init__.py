"""PyTorch/CUDA port of gomatching_tpu (GoMatching-class video text spotting).

Module paths mirror ``gomatching_tpu`` so each counterpart is easy to find; module
and parameter names follow the reference torch ``state_dict`` keys, so reference
checkpoints load with ``load_state_dict``. The port imports ``torch`` and never
``jax`` or anything of ``gomatching_tpu``.

Entry points run on CUDA unless the caller asks for the CPU (``device="cpu"``);
with no GPU and no explicit CPU request they raise instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the current CUDA device, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or --cpu) to run "
                "the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
