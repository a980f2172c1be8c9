"""Seeded random weights, made on the device in one draw.

The same state_dict (reference keys) goes to the port and to the plain reference. The
scheme follows the reference's initialisers: every linear and convolution kernel
N(0, 1/fan_in) with zero biases, norms at identity, FrozenBN at identity, the sampling
offsets' radial grid bias, N(0, 1) level and point embeddings and the prior-probability
class bias; the trunk's other tensors as its file's ``init_rules`` says. Unlike a freshly
initialised DeepSolo, the sampling-offset and attention kernels are drawn too
(N(0, 1/fan_in)), so that where the samplers read depends on the content, as in a
trained model.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from .reference import trunks
from .reference.model import FrozenBN, MSDeformAttn, MultiHeadAttention, ReferenceModel

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def offset_grid_bias(heads: int, levels: int, points: int) -> torch.Tensor:
    thetas = np.arange(heads, dtype=np.float32) * (2.0 * math.pi / heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    grid = grid * (np.arange(points, dtype=np.float32) + 1)[None, None, :, None]
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


def make_state_dict(model_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state_dict of the whole model, drawn from ``seed`` on ``device`` with
    one ``randn`` call; shared heads get one tensor under each of their keys."""
    with torch.device("meta"):
        skel = ReferenceModel(model_cfg)
    rules = {}  # id(tensor) -> (kind, fan_in or payload)
    for mod in skel.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            rules[id(mod.weight)] = ("normal", mod.weight[0].numel())
            if mod.bias is not None:
                rules[id(mod.bias)] = ("const", 0.0)
        elif isinstance(mod, MultiHeadAttention):
            rules[id(mod.in_proj_weight)] = ("normal", mod.in_proj_weight.shape[1])
            rules[id(mod.in_proj_bias)] = ("const", 0.0)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            rules[id(mod.weight)] = ("const", 1.0)
            rules[id(mod.bias)] = ("const", 0.0)
        elif isinstance(mod, FrozenBN):
            for k, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                         ("running_var", 1.0)):
                rules[id(getattr(mod, k))] = ("const", v)
    trunk = skel.backbone[0].backbone
    tensors = trunk.state_dict(keep_vars=True)
    for name, rule in trunks.of(model_cfg).init_rules(trunk).items():
        rules[id(tensors[name])] = rule
    for mod in skel.modules():
        if isinstance(mod, MSDeformAttn):
            rules[id(mod.sampling_offsets.bias)] = (
                "tensor", offset_grid_bias(mod.n_heads, mod.n_levels, mod.n_points))
    sp = skel.detection_transformer
    rules[id(sp.transformer.level_embed)] = ("normal", 1)
    rules[id(sp.point_embed.weight)] = ("normal", 1)
    for head in (sp.bezier_proposal_class, sp.ctrl_point_class[0], sp.ctrl_point_text[0]):
        rules[id(head.bias)] = ("const", PRIOR_BIAS)

    named = list(skel.state_dict(keep_vars=True).items())
    unique = {}
    for name, t in named:
        if id(t) not in rules:
            raise KeyError(f"no initialiser for {name} of the reference model")
        unique.setdefault(id(t), t)
    n_normal = sum(t.numel() for k, t in unique.items() if rules[k][0] == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    draw = torch.randn(n_normal, generator=gen, device=device, dtype=torch.float32)
    made, offset = {}, 0
    for k, t in unique.items():
        kind, arg = rules[k]
        if kind == "normal":
            made[k] = draw[offset:offset + t.numel()].view(t.shape) * (arg ** -0.5)
            offset += t.numel()
        elif kind == "const":
            made[k] = torch.full(t.shape, arg, dtype=torch.float32, device=device)
        else:
            made[k] = arg.to(device).view(t.shape)
    return {name: made[id(t)] for name, t in named}
