"""Torch checkpoints of the port: ``{"model": state_dict}`` under the reference's
``state_dict`` keys (the JAX package writes ``.npz`` params instead)."""

from __future__ import annotations

import os
import pickle
from typing import Dict

import torch
import torch.nn as nn


def save_checkpoint(path: str, model: nn.Module) -> None:
    """Write ``{"model": state_dict}`` (CPU tensors) to ``path``, through a temporary
    file renamed into place."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": sd}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, what: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """The state_dict of a torch checkpoint (``{"model": ...}``, ``{"state_dict":
    ...}`` or a bare state_dict). A missing file, or one that is not a torch
    checkpoint (such as the JAX package's ``.npz`` params), raises; ``what`` names the
    file in the message."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what} {path!r} does not exist")
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
        raise ValueError(f"{what} {path!r} is not a torch checkpoint") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{what} {path!r} holds a {type(ckpt).__name__}, not a state_dict")
    return ckpt.get("model", ckpt.get("state_dict", ckpt))
