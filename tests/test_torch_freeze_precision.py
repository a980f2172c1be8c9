"""FREEZE_TYPE Backbone under MODEL.PRECISION bfloat16, and the trainer's tensorboard
scalars: only the frozen trunk is cast, so a bf16 trunk feeds an f32 spotter, its
features promoted as flax promotes a bf16 input against f32 weights (JAX
engine/predictor.py:37-38, train.py:253-260). The spot against JAX's mixed-dtype spot
(``Trainer._spot_fn``, compiled with XLA:CPU's cheap options), the checkpoints' f32 copies
(``frozen_f32`` for the trunk, the decayed spotter as it is) and ``--resume``'s state;
``train_net``'s tensorboard event file.

Tolerance of the mixed spot: within twice JAX's own distance from the f32 spot of the
same weights (the port's f32 spot, which tests/test_torch_train_tracker.py holds to JAX's
within 1e-5), per output, as tests/test_torch_bf16.py bounds the bf16 spot.
"""

import json

import numpy as np
import torch

import jax

from test_torch_freeze_types import _cfgs
from test_torch_train_tracker import CANVAS, CONFIG, FAST_COMPILE, FRAME_HW, _seeded_params

FIELDS = ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points",
          "query_features")


def test_backbone_bf16_spot_matches_jax_mixed_dtype():
    from gomatching_tpu.engine.train import Trainer as JaxTrainer
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import params_from_jax

    jcfg, tcfg = _cfgs("Backbone", ["MODEL.PRECISION", "bfloat16"])
    params = _seeded_params(jax_build(jcfg), np.random.RandomState(1))
    images = np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params)
    args = (jtr.state.frozen, jtr.state.trainable, images, FRAME_HW)
    jout = jax.jit(jtr._spot_fn).lower(*args).compile(FAST_COMPILE)(*args)

    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    model = tr.model
    assert tr.cast_members == ("backbone",)
    assert all(p.dtype == torch.bfloat16 for p in model.backbone.parameters())
    assert all(b.dtype == torch.bfloat16 for b in model.backbone.buffers())
    assert all(p.dtype == torch.float32 for n, p in model.named_parameters()
               if not n.startswith("backbone."))
    out = tr.spot(images, FRAME_HW)
    _, f32cfg = _cfgs("Backbone")
    ref = Trainer(f32cfg, params_from_jax(params, f32cfg), device="cpu").spot(images, FRAME_HW)
    for k in FIELDS:
        got, want = out[k], np.asarray(jout[k])
        assert got.dtype == torch.float32 and want.dtype == np.float32, k
        drift = np.abs(want - ref[k].numpy()).max()
        assert drift > 0, k  # the trunk did run in bf16
        err = np.abs(got.numpy() - want).max()
        assert err <= 2 * drift, (k, err, drift)


def test_backbone_bf16_checkpoints_keep_f32(tmp_path):
    """After a step the checkpoint holds the trunk's f32 originals and the decayed f32
    spotter; the train state's spotter tensors restore into a fresh trainer."""
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.utils.synthetic import make_targets
    from gomatching_tpu_torch.weights import init_state_dict

    _, tcfg = _cfgs("Backbone", ["MODEL.PRECISION", "bfloat16"])
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(1))
    tr = Trainer(tcfg, sd, device="cpu")
    tr.step(np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8),
            FRAME_HW, make_targets(3, 5))
    ckpt = tr.model_state_dict()
    assert all(v.dtype == sd[k].dtype for k, v in ckpt.items())
    named = dict(tr.model.named_parameters())
    for k, v in ckpt.items():
        if k.startswith("backbone."):
            assert torch.equal(v, sd[k]), k
        elif k.startswith("detection_transformer.") and k in named:
            assert torch.equal(v, named[k].detach()), k
            assert torch.equal(v, sd[k]) == (not sd[k].any()), k  # decayed unless zero
    state = tr.state_dict()
    assert set(state["spotter"]) == {n for n in tr.trainable_names if n.startswith("detection_")}
    fresh = Trainer(tcfg, sd, device="cpu")
    fresh.load_state_dict(state)
    for n in state["spotter"]:
        assert torch.equal(dict(fresh.model.named_parameters())[n], named[n]), n



def test_tracker_cli_writes_tensorboard_scalars(tmp_path):
    """``train_net --task tracker`` under FREEZE_TYPE '' writes ``OUTPUT_DIR/tb``: an event
    file whose scalars are the numeric fields of each ``metrics.json`` line, at its
    iteration."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.data.datasets import register_dataset
    from test_torch_train_tracker_cli import TINY as CLI_TINY, _write_dataset

    register_dataset("synth_port_freeze_tb", *_write_dataset(tmp_path))
    out = tmp_path / "out"
    train_net.main(["--config-file", CONFIG, "--cpu", "--max-iter", "1", "--opts", *CLI_TINY,
                    "MODEL.FREEZE_TYPE", "''", "DATASETS.TRAIN", "('synth_port_freeze_tb',)",
                    "INPUT.TRAIN_SIZE", "64", "OUTPUT_DIR", str(out), "SEED", "3"])
    line = json.loads((out / "metrics.json").read_text().splitlines()[-1])
    events = EventAccumulator(str(out / "tb"))
    events.Reload()
    numeric = {k for k, v in line.items() if isinstance(v, (int, float))}
    assert set(events.Tags()["scalars"]) == numeric
    for k in numeric:
        (ev,) = events.Scalars(k)
        assert ev.step == line["iteration"] == 1
        np.testing.assert_allclose(ev.value, line[k], rtol=1e-6, err_msg=k)
