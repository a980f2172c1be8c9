"""Torch checkpoints of the port: ``{"model": state_dict}`` under the reference's
``state_dict`` keys; the tracker trainer's states for ``--resume``
(``checkpoints/state_{step:07d}.pth``); and the JAX package's ``.npz`` params (flat
arrays under '/'-joined tree paths, gomatching_tpu/engine/checkpoint.py:28-53), read
back into their tree for ``weights.params_from_jax``. The JAX package's train states
are orbax directories, which need JAX to read: the port resumes only from its own."""

from __future__ import annotations

import os
import pickle
import re
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def _save(obj, path: str) -> None:
    """``torch.save`` through a temporary file renamed into place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, model) -> None:
    """Write ``{"model": state_dict}`` (CPU tensors) of ``model``, a module or a state_dict,
    to ``path``."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    _save({"model": {k: v.detach().cpu() for k, v in sd.items()}}, path)


_STATE = re.compile(r"state_(\d{7})\.pth$")


def save_train_state(ckpt_dir: str, step: int, state: Dict[str, Any]) -> None:
    """Write a trainer state (tensors and plain values) as
    ``ckpt_dir/state_{step:07d}.pth``."""
    _save(state, os.path.join(ckpt_dir, f"state_{step:07d}.pth"))


def latest_train_state(ckpt_dir: str) -> Tuple[Optional[str], int]:
    """(path, step) of the newest train state in ``ckpt_dir``, or (None, 0)."""
    found = sorted((int(m.group(1)), name) for name in
                   (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])
                   if (m := _STATE.fullmatch(name)))
    if not found:
        return None, 0
    step, name = found[-1]
    return os.path.join(ckpt_dir, name), step


def load_train_state(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


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


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}} (the JAX package's ``_unflatten``)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_jax_params(path: str, what: str = "params") -> Dict[str, Any]:
    """The params tree of a JAX ``.npz`` (``save_params``'s format). A missing file, or
    one that is not an ``.npz`` archive, raises; ``what`` names the file in the message."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what} {path!r} does not exist")
    try:
        with np.load(path, allow_pickle=False) as data:
            return _unflatten({k: data[k] for k in data.files})
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        raise ValueError(f"{what} {path!r} is not an .npz archive of JAX params") from e
