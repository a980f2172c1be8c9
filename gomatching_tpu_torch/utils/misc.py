"""Small numeric helpers (port of gomatching_tpu/utils/misc.py).

Parity: third_party/adet/utils/misc.py:115-131 (inverse_sigmoid).
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)
