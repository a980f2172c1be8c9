"""A trunk comes as one file of ``benchmark/reference/trunks/``, named by the
configuration: a toy trunk written elsewhere, with the trunk folder pointed there, builds
into the reference, draws its weights and has its operations counted, with no file of
the harness edited; a copy of the ResNet file under another name runs a tiny video cell
to correct; the port's trunk is compared, and an unknown name fails with the list."""

import os
import shutil

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, run
from benchmark.jobs import video
from benchmark.reference import trunks
from benchmark.reference.model import ReferenceModel, resize_hw
from benchmark.tests.tiny import TINY_MODEL, TINY_OPTS, tiny_context
from benchmark.weights import make_state_dict

# stride-8 patches with padding of its own, one attention over all of them with a
# parameter that no generic rule covers, then two stride-2 convolutions
TOY = '''
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import conv_out

WIDTHS = (24, 40, 56)
STREAM_LAYERS = ()


class Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = nn.Conv2d(3, WIDTHS[0], 8, stride=8)
        self.pos = nn.Parameter(torch.empty(WIDTHS[0]))
        self.qkv = nn.Linear(WIDTHS[0], 3 * WIDTHS[0])
        self.norm = nn.LayerNorm(WIDTHS[0])
        self.down1 = nn.Conv2d(WIDTHS[0], WIDTHS[1], 3, stride=2, padding=1)
        self.down2 = nn.Conv2d(WIDTHS[1], WIDTHS[2], 3, stride=2, padding=1)

    def forward(self, x):
        x = F.pad(x, (0, -x.shape[3] % 8, 0, -x.shape[2] % 8))
        y = self.embed(x)
        b, c, h, w = y.shape
        t = y.flatten(2).transpose(1, 2) + self.pos
        q, k, v = self.qkv(t).chunk(3, -1)
        t = self.norm(t + torch.matmul((q @ k.transpose(1, 2) / c ** 0.5).softmax(-1), v))
        r3 = t.transpose(1, 2).reshape(b, c, h, w)
        r4 = self.down1(r3)
        return [r3, r4, self.down2(r4)]


def build(m):
    return Toy()


def channels(m):
    return WIDTHS


def init_rules(module):
    return {"pos": ("normal", 1)}


def flops(h, w, m):
    h, w = -(-h // 8), -(-w // 8)
    n, c = h * w, WIDTHS[0]
    ops = 2 * n * c * 3 * 64 + 2 * n * c * 3 * c + 2 * 2 * n * n * c
    sizes = [(h, w)]
    for cin, cout in zip(WIDTHS, WIDTHS[1:]):
        a, b = sizes[-1]
        sizes.append((conv_out(a, 3, 2, 1), conv_out(b, 3, 2, 1)))
        ops += 2 * sizes[-1][0] * sizes[-1][1] * cout * cin * 9
    return ops, sizes


def port_fields(cfg):
    built = cfg.MODEL.BACKBONE.NAME
    return {"backbone": "toy" if built == "build_toy_backbone" else built}
'''


def icdar15_model(**kw) -> dict:
    m = run.load_json(run.HERE, "configs", "gomatching-icdar15-r50.json")["model"]
    return dict(m, **TINY_MODEL, **kw)


RESNET = os.path.join(os.path.dirname(trunks.__file__), "resnet.py")


@pytest.fixture
def folder(tmp_path, monkeypatch):
    """The trunk folder pointed at an empty directory of this test's own."""
    monkeypatch.setattr(trunks, "FOLDER", str(tmp_path))
    return tmp_path


@pytest.fixture
def toy(folder):
    (folder / "toy.py").write_text(TOY)
    return icdar15_model(backbone="toy")


def test_toy_trunk_builds_and_draws_its_weights(toy):
    ref = ReferenceModel(toy)
    assert type(ref.backbone[0].backbone).__name__ == "Toy"
    assert [p[0].in_channels for p in ref.detection_transformer.input_proj] == [24, 40, 56, 56]
    sd = make_state_dict(toy, 7, "cpu")
    ref.load_state_dict(sd, strict=True)
    pos = sd["backbone.0.backbone.pos"]
    assert pos.shape == (24,) and 0.3 < pos.std() < 3
    assert list(sd) == list(ref.state_dict())


def test_toy_trunk_without_its_rule(folder):
    (folder / "bare.py").write_text(TOY.replace('{"pos": ("normal", 1)}', "{}"))
    with pytest.raises(KeyError, match="backbone.0.backbone.pos"):
        make_state_dict(icdar15_model(backbone="bare"), 7, "cpu")


def test_toy_trunk_flops_match_the_counter(toy):
    ref = ReferenceModel(toy)
    ref.load_state_dict(make_state_dict(toy, 7, "cpu"))
    h, w = resize_hw(96, 128, toy["min_size_test"], toy["max_size_test"])
    x = torch.randn(1, h, w, 3)
    ops, sizes = trunks.of(toy).flops(h, w, toy)
    with FlopCounterMode(display=False) as fc:
        maps = ref.backbone[0].backbone(x.permute(0, 3, 1, 2))
    assert fc.get_total_flops() == ops
    assert [tuple(f.shape[2:]) for f in maps] == list(sizes)
    with FlopCounterMode(display=False) as fc:
        enc = ref.encode(x)
        ref.decode(enc, ref.select(enc), (h, w))
    want = counts.spot_flops(h, w, toy)
    assert fc.get_total_flops() == want["dense"]
    assert want["tokens"] == enc["memory"].shape[1]


def test_unknown_trunk_lists_the_trunks():
    for name in ("nope", "../model", "__init__"):
        with pytest.raises(ValueError, match=r"no trunk .* has \[.*'resnet'"):
            trunks.load(name)
    with pytest.raises(ValueError, match="resnet"):
        make_state_dict(icdar15_model(backbone="nope"), 7, "cpu")


def test_check_cfg_compares_the_trunk(toy, folder):
    shutil.copy(RESNET, folder / "resnet.py")
    config = run.load_json(run.HERE, "configs", "gomatching-icdar15-r50.json")
    m = icdar15_model()
    video.check_cfg(video.port_cfg(config, TINY_OPTS), m)
    # the port builds ResNet where the configuration names another trunk
    with pytest.raises(ValueError, match="backbone"):
        video.check_cfg(video.port_cfg(config, TINY_OPTS), toy)
    # the port builds another trunk where the configuration names ResNet
    vitae = video.port_cfg(config, TINY_OPTS + ["MODEL.BACKBONE.NAME", "build_vitaev2_backbone"])
    with pytest.raises(ValueError, match="build_vitaev2_backbone"):
        video.check_cfg(vitae, dict(m, backbone=trunks.DEFAULT))


def test_copy_of_resnet_runs_a_tiny_cell(folder):
    """The ResNet file under another name, alone in the trunk folder, named by the tiny
    cell's configuration: the port builds its own ResNet, the reference the copy's."""
    shutil.copy(RESNET, folder / "resnet_twin.py")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ctx, bench = tiny_context("icdar15-f32-video", seconds=1.5)
        ctx["model"] = dict(ctx["model"], backbone="resnet_twin")
        line = run.run_cell(ctx, bench)
    finally:
        torch.set_num_threads(n)
    assert line["correct"] is True and line["attempted"] > 0
    assert trunks.available() == ["resnet_twin"]
