"""The port refuses config values it would otherwise ignore.

The JAX predictor reads two inference keys that change its outputs and that the port
does not port yet: ``TPU.ASSOC_PRECISION`` (a bf16 association matcher,
gomatching_tpu/engine/predictor.py:146-147) and ``TPU.UPLOAD_FORMAT`` (a lossy I420 round
trip of every frame, predictor.py:140). A non-default value of either raises
NotImplementedError naming the key, before any weight is built; the shipped configs,
which set neither, still build a predictor. The tracker trainer likewise refuses
``TPU.TRAIN_UPLOAD_FORMAT`` yuv420 and the freeze policies that train more than
``roi_heads``, and builds from both shipped configs.
"""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name, *opts):
    from gomatching_tpu_torch.config import setup_eval_cfg

    return setup_eval_cfg(os.path.join(ROOT, "configs", f"{name}.yaml"),
                          ["MODEL.WEIGHTS", "''", *opts])


@pytest.mark.parametrize("key,value", [("TPU.ASSOC_PRECISION", "bfloat16"),
                                       ("TPU.UPLOAD_FORMAT", "yuv420")])
def test_predictor_refuses_unported_inference_keys(key, value):
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    cfg = _cfg("GoMatching_ICDAR15", key, value)
    with pytest.raises(NotImplementedError, match=re.escape(key) + ".*ROADMAP A13"):
        VideoPredictor(cfg, device="cpu")


@pytest.mark.parametrize("name", ["GoMatching_ICDAR15", "GoMatching_PP_ICDAR15"])
def test_shipped_configs_still_build_a_predictor(name):
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    cfg = _cfg(name)
    assert (cfg.TPU.ASSOC_PRECISION, cfg.TPU.UPLOAD_FORMAT) == ("", "rgb")
    predictor = VideoPredictor(cfg, device="cpu")
    assert predictor.model.hidden_dim == cfg.MODEL.TRANSFORMER.HIDDEN_DIM


def _train_cfg(name, *opts):
    from gomatching_tpu_torch.config import setup_train_cfg

    return setup_train_cfg(os.path.join(ROOT, "configs", f"{name}.yaml"),
                           ["MODEL.WEIGHTS", "''", *opts])


@pytest.mark.parametrize("key,value,match", [
    ("TPU.TRAIN_UPLOAD_FORMAT", "yuv420", r"TPU\.TRAIN_UPLOAD_FORMAT.*ROADMAP A13"),
    ("MODEL.FREEZE_TYPE", "ROIheads", r"MODEL\.FREEZE_TYPE='ROIheads'"),
    ("MODEL.FREEZE_TYPE", "''", r"MODEL\.FREEZE_TYPE=''"),
])
def test_trainer_refuses_unported_training_keys(key, value, match):
    """The tracker trainer refuses the yuv420 training wire (JAX: a lossy I420 round
    trip of every training frame) and freeze policies that train more than roi_heads."""
    from gomatching_tpu_torch.engine.train import Trainer

    with pytest.raises(NotImplementedError, match=match):
        Trainer(_train_cfg("GoMatching_ICDAR15", key, value), device="cpu")


@pytest.mark.parametrize("name", ["GoMatching_ICDAR15", "GoMatching_PP_ICDAR15"])
def test_shipped_configs_build_a_trainer(name):
    """Both shipped configs build a tracker trainer at full width whose optimizer holds
    exactly the roi_heads parameters, and whose training keys are the defaults the port
    reads (uint8 wire with masks; the overlap flag parses)."""
    from gomatching_tpu_torch.engine.train import Trainer

    cfg = _train_cfg(name)
    assert (cfg.TPU.TRAIN_UPLOAD_FORMAT, cfg.TPU.TRAIN_UPLOAD_UINT8) == ("rgb", True)
    assert cfg.TPU.TRAIN_OVERLAP_UPLOAD in (True, False)
    tr = Trainer(cfg, device="cpu")
    in_opt = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    heads = {id(p) for n, p in tr.model.named_parameters() if n.startswith("roi_heads.")}
    assert in_opt == heads and tr.trainable_names
    assert all(p.requires_grad == n.startswith("roi_heads.")
               for n, p in tr.model.named_parameters())
