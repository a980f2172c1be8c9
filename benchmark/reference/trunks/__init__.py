"""The reference's trunks, one file each: ``<name>.py`` in this folder, which a
configuration names by ``model["backbone"]`` (``resnet`` where the key is absent). A
trunk file gives:

- ``build(m) -> nn.Module``: normalized NCHW float32 frames in, ``[res3, res4, res5]``
  NCHW out, in plain torch; any padding the trunk needs is its own;
- ``channels(m)``: the widths of those three maps, which feed the input projections;
- ``init_rules(module) -> {name: rule}``: the initialisers of the tensors of ``module``
  (the built trunk, by ``state_dict`` name) that the generic rules of
  ``weights.make_state_dict`` do not cover, a rule being ``("normal", fan_in)``,
  ``("const", value)`` or ``("tensor", values)``;
- ``flops(h, w, m) -> (ops, [three (h, w)])``: the trunk's operations at an (h, w) input
  and the sizes of its three maps, worked out from shapes (``counts.py``'s rule);
- ``port_fields(cfg) -> dict``: the port's resolved trunk in the configuration's keys,
  which ``jobs/video.check_cfg`` compares; ``backbone`` is the trunk file's name where
  the port builds that trunk;
- ``STREAM_LAYERS``: the trunk's blocks whose outputs carry the residual stream, which
  the bfloat16 control rounds to float8.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, List

FOLDER = os.path.dirname(os.path.abspath(__file__))
DEFAULT = "resnet"
_LOADED: Dict[str, object] = {}


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def available() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(FOLDER)
                  if f.endswith(".py") and not f.startswith("_"))


def name_of(m: Dict) -> str:
    return m.get("backbone", DEFAULT)


def load(name: str):
    """The trunk file ``<name>.py`` of ``FOLDER``, loaded once."""
    if name not in available():
        raise ValueError(f"no trunk {name!r}: {FOLDER} has {available()}")
    path = os.path.join(FOLDER, f"{name}.py")
    if path not in _LOADED:
        # a module of this package, so that a trunk file imports its siblings relatively
        spec = importlib.util.spec_from_file_location(f"{__name__}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def of(m: Dict):
    """The trunk file a configuration's model names."""
    return load(name_of(m))
