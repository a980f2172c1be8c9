"""Optimizer, LR schedule and gradient clip of the trainers (port of
``warmup_cosine_schedule`` and ``build_optimizer``, gomatching_tpu/engine/train.py:163-225).

Parity with the JAX package (which follows build_custom_optimizer,
costom_solver.py:20-77, except where noted):

- parameter groups: the top-level module ``backbone`` at ``BACKBONE_MULTIPLIER``, any
  parameter whose reference name contains a ``CUSTOM_MULTIPLIER_NAME`` keyword at
  ``CUSTOM_MULTIPLIER``, the rest at 1;
- AdamW (``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8) decays EVERY parameter, norms and
  biases included (``WEIGHT_DECAY_NORM`` is not read); SGD (``optax.sgd``) has momentum
  and no weight decay;
- ``WarmupCosineLR`` is linear warm-up then cosine; any other scheduler name is
  ``optax.piecewise_constant_schedule`` over ``STEPS`` with no warm-up;
- the full-model clip scales by ``max / norm`` when norm > max, as
  ``optax.clip_by_global_norm`` does (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to
  the norm, so it is written out here).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn


def warmup_cosine_schedule(base_lr: float, max_iter: int, warmup_iters: int = 1000,
                           warmup_factor: float = 1e-3) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_iters:
            return base_lr * (warmup_factor + (1 - warmup_factor) * step / warmup_iters)
        return base_lr * 0.5 * (1 + math.cos(math.pi * min(max(step / max_iter, 0.0), 1.0)))

    return schedule


def multistep_schedule(base_lr: float, steps: Iterable[int], gamma: float) -> Callable[[int], float]:
    """``optax.piecewise_constant_schedule(base_lr, {step: gamma})``: scaled by gamma
    once ``step`` reaches each boundary."""
    bounds = sorted({int(s) for s in steps})

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in bounds)

    return schedule


def build_schedule(cfg) -> Callable[[int], float]:
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        return warmup_cosine_schedule(s.BASE_LR, s.MAX_ITER, s.WARMUP_ITERS, s.WARMUP_FACTOR)
    return multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA)


def param_groups(model: nn.Module, cfg) -> List[Dict]:
    """The three LR groups (empty ones dropped), each parameter once."""
    s = cfg.SOLVER
    custom = list(s.CUSTOM_MULTIPLIER_NAME)
    groups: Dict[str, List[nn.Parameter]] = {"backbone": [], "custom": [], "rest": []}
    for name, p in model.named_parameters():
        if name.split(".")[0] == "backbone":
            groups["backbone"].append(p)
        elif any(k in name for k in custom):
            groups["custom"].append(p)
        else:
            groups["rest"].append(p)
    mult = {"backbone": s.BACKBONE_MULTIPLIER, "custom": s.CUSTOM_MULTIPLIER, "rest": 1.0}
    return [{"params": ps, "lr": s.BASE_LR * mult[k], "name": k}
            for k, ps in groups.items() if ps]


def build_optimizer(cfg, model: nn.Module) -> Tuple[torch.optim.Optimizer,
                                                    torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, LambdaLR): each group's LR is its multiplier times the schedule;
    ``scheduler.step()`` after each ``optimizer.step()``."""
    s = cfg.SOLVER
    groups = param_groups(model, cfg)
    if s.OPTIMIZER.upper() == "ADAMW":
        opt = torch.optim.AdamW(groups, lr=s.BASE_LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=s.WEIGHT_DECAY)
    else:
        opt = torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM)
    schedule = build_schedule(cfg)
    base = s.BASE_LR
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / base if base else 0.0)
    return opt, sched


def clip_max_norm(cfg) -> Optional[float]:
    """The full-model clip's max norm, or None when there is none (JAX applies only
    the ``full_model`` clip type)."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    return float(c.CLIP_VALUE) if c.ENABLED and c.CLIP_TYPE == "full_model" else None


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / norm when their global L2 norm exceeds
    max_norm (``optax.clip_by_global_norm``); returns the norm before clipping. No
    host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
