"""The port refuses config values it would otherwise ignore, and accepts those it reads.

``TPU.SAMPLING_IMPL`` pallas with ``MODEL.PRECISION`` bfloat16 raises NotImplementedError
(B5 has no bf16 variant yet, ROADMAP A13c) before any weight is built, in the predictor
and in the tracker trainer. The shipped configs still build a predictor and a trainer.
The tracker trainer refuses the freeze policies that train more than ``roi_heads``; it
reads neither of the inference keys ``TPU.ASSOC_PRECISION`` and ``TPU.UPLOAD_FORMAT``, as
JAX's ``Trainer`` does not, so it builds with both at their production values. The
pretraining model takes no compute dtype, as JAX's does not: it builds f32 under
``MODEL.PRECISION`` bfloat16.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name, *opts):
    from gomatching_tpu_torch.config import setup_eval_cfg

    return setup_eval_cfg(os.path.join(ROOT, "configs", f"{name}.yaml"),
                          ["MODEL.WEIGHTS", "''", *opts])


@pytest.mark.parametrize("build", ["predictor", "trainer"])
def test_pallas_bf16_is_refused(build):
    """'pallas' with MODEL.PRECISION bfloat16 raises NotImplementedError naming A13c."""
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.engine.train import Trainer

    opts = ["MODEL.PRECISION", "bfloat16", "TPU.SAMPLING_IMPL", "pallas"]
    with pytest.raises(NotImplementedError, match=r"TPU\.SAMPLING_IMPL='pallas'.*ROADMAP A13c"):
        if build == "predictor":
            VideoPredictor(_cfg("GoMatching_PP_ICDAR15", *opts), device="cpu")
        else:
            Trainer(_train_cfg("GoMatching_PP_ICDAR15", *opts), device="cpu")


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
    ("MODEL.FREEZE_TYPE", "ROIheads", r"MODEL\.FREEZE_TYPE='ROIheads'"),
    ("MODEL.FREEZE_TYPE", "''", r"MODEL\.FREEZE_TYPE=''"),
])
def test_trainer_refuses_unported_training_keys(key, value, match):
    """The tracker trainer refuses freeze policies that train more than roi_heads."""
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


@pytest.mark.parametrize("name", ["GoMatching_ICDAR15", "GoMatching_PP_ICDAR15"])
def test_trainer_reads_no_inference_key(name):
    """The tracker trainer builds with TPU.ASSOC_PRECISION bfloat16 and TPU.UPLOAD_FORMAT
    yuv420, the production values, and ignores them as JAX's Trainer does: the whole model
    stays f32 and the matchers train."""
    import torch

    from gomatching_tpu_torch.engine.train import Trainer

    tr = Trainer(_train_cfg(name, "TPU.ASSOC_PRECISION", "bfloat16",
                            "TPU.UPLOAD_FORMAT", "yuv420"), device="cpu")
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    matcher = "shared_matcher" if name == "GoMatching_PP_ICDAR15" else "long_term_matcher"
    assert any(n.startswith(f"roi_heads.{matcher}.") for n in tr.trainable_names)


def test_pretrain_model_builds_f32_under_bf16():
    """MODEL.PRECISION bfloat16 does not stop the pretraining model from building, and it
    builds f32 (tests/test_torch_bf16_chain.py runs one step of each precision)."""
    import torch

    from gomatching_tpu_torch.models.gomatching import build_pretrain_model

    model = build_pretrain_model(_train_cfg("GoMatching_ICDAR15", "MODEL.PRECISION", "bfloat16"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
