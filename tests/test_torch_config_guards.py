"""The port refuses config values it would otherwise ignore.

The JAX predictor reads two inference keys that change its outputs and that the port
does not port yet: ``TPU.ASSOC_PRECISION`` (a bf16 association matcher,
gomatching_tpu/engine/predictor.py:146-147) and ``TPU.UPLOAD_FORMAT`` (a lossy I420 round
trip of every frame, predictor.py:140). A non-default value of either raises
NotImplementedError naming the key, before any weight is built; the shipped configs,
which set neither, still build a predictor.
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
