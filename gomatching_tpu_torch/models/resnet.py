"""ResNet backbone with detectron2 module names (port of gomatching_tpu/models/resnet.py).

Parity target: detectron2 ``build_resnet_backbone`` as the flagship configs set it
(depth 50, FrozenBN, STRIDE_IN_1X1=False so the 3x3 conv carries the stride, outputs
res3/res4/res5). Names follow the reference ``state_dict``: ``stem.conv1``,
``res{2..5}.{block}.conv{1,2,3}`` / ``.shortcut``, each conv with its ``.norm``.

Layout: NCHW inside and at this module's boundary; ``GoMatchingModel.spot`` takes the
JAX package's NHWC frames and converts once.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBN(nn.Module):
    """BatchNorm with frozen statistics (detectron2 FrozenBatchNorm2d), NCHW."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def make_trainable_(self) -> "FrozenBN":
        """Turn the four tensors into parameters. The JAX package keeps them as
        parameters, so its spotter pretraining trains them (the reference's
        FrozenBatchNorm2d holds buffers); the port's pretraining follows JAX."""
        for k in ("weight", "bias", "running_mean", "running_var"):
            self.register_parameter(k, nn.Parameter(self._buffers.pop(k)))
        return self

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class ConvNorm(nn.Conv2d):
    """Bias-free conv with torch-style symmetric padding and a FrozenBN ``norm``
    child (detectron2's Conv2d(norm=...))."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)
        self.norm = FrozenBN(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (carries the stride) -> 1x1 bottleneck."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int, has_shortcut: bool):
        super().__init__()
        self.shortcut = ConvNorm(cin, cout, 1, stride) if has_shortcut else None
        self.conv1 = ConvNorm(cin, bottleneck, 1)
        self.conv2 = ConvNorm(bottleneck, bottleneck, 3, stride)
        self.conv3 = ConvNorm(bottleneck, cout, 1)

    def forward(self, x):
        identity = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + identity)


class Stem(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvNorm(3, channels, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """ResNet-50/101 trunk: NCHW images -> {res3, res4, res5} NCHW features."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res3", "res4", "res5"),
                 stem_channels: int = 64):
        super().__init__()
        blocks_per_stage = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        self.out_features = tuple(out_features)
        self.stem = Stem(stem_channels)
        cin, bottleneck, cout = stem_channels, stem_channels, stem_channels * 4
        for si, n_blocks in enumerate(blocks_per_stage):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and si > 0) else 1
                blocks.append(Bottleneck(cin, bottleneck, cout, stride, has_shortcut=(b == 0)))
                cin = cout
            self.add_module(f"res{si + 2}", nn.Sequential(*blocks))
            bottleneck *= 2
            cout *= 2

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.stem(x)
        outputs = {}
        for name in ("res2", "res3", "res4", "res5"):
            y = getattr(self, name)(y)
            if name in self.out_features:
                outputs[name] = y
        return outputs
