"""ResNet-50 / 101 with FrozenBN (detectron2 names; STRIDE_IN_1X1 False: the 3x3
convolution strides), as detectron2's ``build_resnet_backbone`` builds it for
GoMatching. The trunk of a configuration without a ``backbone`` key."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..model import FrozenBN
from . import conv_out

NAME = os.path.splitext(os.path.basename(__file__))[0]
BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class ConvNorm(nn.Conv2d):
    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)
        self.norm = FrozenBN(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride, has_shortcut):
        super().__init__()
        self.shortcut = ConvNorm(cin, cout, 1, stride) if has_shortcut else None
        self.conv1 = ConvNorm(cin, mid, 1)
        self.conv2 = ConvNorm(mid, mid, 3, stride)
        self.conv3 = ConvNorm(mid, cout, 1)

    def forward(self, x):
        identity = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + identity)


class Stem(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvNorm(3, c, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """NCHW images -> [res3, res4, res5]."""

    def __init__(self, depth: int = 50):
        super().__init__()
        blocks = BLOCKS[depth]
        self.stem = Stem(64)
        cin, mid, cout = 64, 64, 256
        for si, n in enumerate(blocks):
            layers = []
            for b in range(n):
                layers.append(Bottleneck(cin, mid, cout, 2 if (b == 0 and si > 0) else 1, b == 0))
                cin = cout
            self.add_module(f"res{si + 2}", nn.Sequential(*layers))
            mid *= 2
            cout *= 2

    def forward(self, x) -> List[torch.Tensor]:
        y = self.res2(self.stem(x))
        r3 = self.res3(y)
        r4 = self.res4(r3)
        return [r3, r4, self.res5(r4)]


STREAM_LAYERS = (Bottleneck,)


def build(m: Dict) -> nn.Module:
    return ResNet(m["resnet_depth"])


def channels(m: Dict) -> Tuple[int, int, int]:
    return (512, 1024, 2048)


def init_rules(module: nn.Module) -> Dict:
    return {}  # convolutions and FrozenBN only: the generic rules cover them


def flops(h: int, w: int, m: Dict) -> Tuple[int, Sequence[Tuple[int, int]]]:
    """At an (h, w) input -> (operations, [res3, res4, res5] map sizes)."""
    ops = 0

    def conv(hh, ww, cin, cout, k, s):
        nonlocal ops
        ho, wo = conv_out(hh, k, s, (k - 1) // 2), conv_out(ww, k, s, (k - 1) // 2)
        ops += 2 * ho * wo * cout * cin * k * k
        return ho, wo

    hh, ww = conv(h, w, 3, 64, 7, 2)
    hh, ww = conv_out(hh, 3, 2, 1), conv_out(ww, 3, 2, 1)  # max pool
    cin, mid, cout = 64, 64, 256
    sizes = []
    for si, n in enumerate(BLOCKS[m["resnet_depth"]]):
        for b in range(n):
            stride = 2 if (b == 0 and si > 0) else 1
            if b == 0:
                conv(hh, ww, cin, cout, 1, stride)
            conv(hh, ww, cin, mid, 1, 1)
            h2, w2 = conv(hh, ww, mid, mid, 3, stride)
            conv(h2, w2, mid, cout, 1, 1)
            hh, ww, cin = h2, w2, cout
        if si > 0:
            sizes.append((hh, ww))
        mid *= 2
        cout *= 2
    return ops, sizes


def port_fields(cfg) -> Dict:
    built = cfg.MODEL.BACKBONE.NAME
    return {"backbone": NAME if built == "build_resnet_backbone" else built,
            "resnet_depth": cfg.MODEL.RESNETS.DEPTH}
