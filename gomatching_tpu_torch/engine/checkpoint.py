"""Torch checkpoints of the port: ``{"model": state_dict}`` under the reference's
``state_dict`` keys; the tracker trainer's states for ``--resume``
(``checkpoints/state_{step:07d}.pth``); and the JAX package's ``.npz`` params (flat
arrays under '/'-joined tree paths, gomatching_tpu/engine/checkpoint.py:28-53), read
back into their tree for ``weights.params_from_jax`` and written by ``save_params``.
The JAX package's train states are orbax directories, which need JAX to read: the port
resumes only from its own.

``load_checkpoint`` reads every checkpoint form that ``tools/convert_torch_weights.py``
reads (:304-310), without running code from the file: a detectron2 ``.pkl`` (a latin1
pickle of ``{'model': {name: ndarray}, ...}``, AdetCheckpointer's model-zoo format)
through an unpickler that knows only numpy's array globals, and any other path through
``torch.load(weights_only=True)`` with numpy's array and scalar globals allowed, so that
an optimizer state or iteration count held as numpy loads. A file that names any other
global is refused without it being imported or called."""

from __future__ import annotations

import collections
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


# numpy's pickling globals, each under every module name a numpy (1.x: numpy.core, 2.x:
# numpy._core) writes it with; the objects come from numpy's own reducers, so nothing is
# imported by the names a file gives. ``_frombuffer`` is protocol 5's array form and
# ``_codecs.encode`` protocol 2's bytes (Python 3 writers), both needed by numpy arrays.
_reconstruct = np.zeros(1, np.float32).__reduce__()[0]
_scalar = np.float32(0).__reduce__()[0]
_frombuffer = np.zeros(1, np.float32).__reduce_ex__(5)[0]


def _latin1_encode(text: str, encoding: str = "latin1") -> bytes:
    """``_codecs.encode`` as protocol 2 pickles of bytes use it, and no other way."""
    if not isinstance(text, str) or encoding not in ("latin1", "latin-1"):
        raise ValueError(f"_codecs.encode({type(text).__name__}, {encoding!r}) is not "
                         "the bytes of a numpy array")
    return text.encode("latin1")


_CORE = ("numpy.core.multiarray", "numpy._core.multiarray")
_NUMPY_GLOBALS = {
    **{(m, "_reconstruct"): _reconstruct for m in _CORE},
    **{(m, "scalar"): _scalar for m in _CORE},
    **{(m, name): obj for m in ("numpy", *_CORE)
       for name, obj in (("ndarray", np.ndarray), ("dtype", np.dtype))},
    **{(m, "_frombuffer"): _frombuffer for m in ("numpy.core.numeric", "numpy._core.numeric")},
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("_codecs", "encode"): _latin1_encode,
}


class _ArrayUnpickler(pickle.Unpickler):
    """Resolves only ``_NUMPY_GLOBALS``; any other global raises ValueError naming it,
    before anything of it is imported or called."""

    def __init__(self, f, what: str):
        super().__init__(f, encoding="latin1")
        self.what = what

    def find_class(self, module: str, name: str):
        obj = _NUMPY_GLOBALS.get((module, name))
        if obj is None:
            raise ValueError(f"{self.what} names the global {module}.{name}, which a "
                             "checkpoint of numpy arrays does not need; refused without "
                             "importing it")
        return obj


def load_pickle(path: str, what: str = "checkpoint") -> Any:
    """A detectron2 ``.pkl`` read as the repository's converter reads it
    (``pickle.load(f, encoding="latin1")``), through ``_ArrayUnpickler``."""
    try:
        with open(path, "rb") as f:
            return _ArrayUnpickler(f, f"{what} {path!r}").load()
    except (pickle.UnpicklingError, EOFError, AttributeError, TypeError, IndexError) as e:
        raise ValueError(f"{what} {path!r} is not a pickle of numpy arrays") from e


# numpy's globals that a torch checkpoint's non-tensor state may hold (an optimizer's
# scalars, an iteration count), under the names numpy 1.x and 2.x write
_TORCH_NUMPY_GLOBALS = [
    np.ndarray, np.dtype, *(type(np.dtype(c)) for c in "?bBhHiIlLqQefdgFD"),
    *((_reconstruct, f"{m}._reconstruct") for m in _CORE),
    *((_scalar, f"{m}.scalar") for m in _CORE),
]


def load_torch(path: str, what: str = "checkpoint") -> Any:
    """``torch.load(weights_only=True)`` with numpy's array and scalar globals allowed;
    a file that names any other global raises ValueError naming it."""
    try:
        with torch.serialization.safe_globals(_TORCH_NUMPY_GLOBALS):
            return torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
        try:
            unsafe = torch.serialization.get_unsafe_globals_in_checkpoint(path)
        except (ValueError, RuntimeError):  # not a torch zip archive at all
            unsafe = []
        if unsafe:
            raise ValueError(f"{what} {path!r} names the globals {unsafe}, which a checkpoint "
                             "does not need; refused without running them") from e
        raise ValueError(f"{what} {path!r} is not a torch checkpoint") from e


def load_checkpoint(path: str, what: str = "checkpoint") -> Dict[str, torch.Tensor]:
    """The state_dict of a checkpoint (``{"model": ...}``, ``{"state_dict": ...}`` or a
    bare state_dict): a ``.pkl`` through ``load_pickle``, any other path through
    ``load_torch``; numpy arrays become tensors, the other top-level keys (a ``.pkl``'s
    ``__author__`` and ``matching_heuristics``, an optimizer, an iteration) are ignored.
    A missing file, or one that is neither (such as the JAX package's ``.npz`` params),
    raises; ``what`` names the file in the message."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what} {path!r} does not exist")
    ckpt = load_pickle(path, what) if path.endswith(".pkl") else load_torch(path, what)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{what} {path!r} holds a {type(ckpt).__name__}, not a state_dict")
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return {k: torch.from_numpy(np.array(v)) if isinstance(v, (np.ndarray, np.generic)) else v
            for k, v in sd.items()}


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': {'c': x}}} -> {'a/b/c': x} (the JAX package's ``_flatten``)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_params(path: str, tree: Dict[str, Any]) -> None:
    """A params tree as the JAX package's ``.npz`` (``save_params``, checkpoint.py:39-43):
    ``np.savez`` of the arrays under '/'-joined paths."""
    np.savez(path, **flatten_params(tree))


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
