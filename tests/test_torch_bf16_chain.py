"""The production configuration of the port end to end on the CPU: tests/
test_production_parity.py's moving-rectangles clip through the production inference
chain (``MODEL.PRECISION`` bfloat16, ``TPU.UPLOAD_FORMAT`` yuv420, the default sampler,
the matcher following ``MODEL.PRECISION``) against JAX's f32 / RGB / 'xla' chain, under
that file's bounds (tests/test_production_parity.py:176-182: >= 15 matched pairs,
coverage >= 0.5, id consistency >= 0.8 over all pairs and >= 0.85 over tight ones), and
twice with identical ids; ``train_net --task tracker`` in the production training
configuration (bf16 spotter, ``TPU.TRAIN_UPLOAD_FORMAT`` yuv420), resumed."""

import functools
import os

import numpy as np
import pytest
import torch

from test_production_parity import TINY as PARITY_TINY, _clip, track_agreement
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
# XLA:CPU's cheap options (tests/test_torch_deform_attn_edges.py): the same programs, built
# in about two thirds of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
                "xla_cpu_use_fusion_emitters": False}


@pytest.fixture(scope="module")
def production_runs():
    """tests/test_production_parity.py's moving-rectangles clip through JAX's f32 / RGB /
    'xla' chain and twice through the port's production chain (bf16 spotter and matcher,
    yuv420, the default sampler), on the weights that file's chains run on: JAX's own
    init (``init_params``: ``model.init`` at PRNGKey(0)), carried to the port. JAX's
    programs compile with XLA:CPU's cheap options (the same programs)."""
    import jax
    import jax.numpy as jnp

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import VideoPredictor as JaxPredictor
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.weights import params_from_jax

    frames = _clip()
    ref_opts = ["MODEL.PRECISION", "float32", "TPU.UPLOAD_FORMAT", "rgb", "TPU.SAMPLING_IMPL", "xla"]
    prod_opts = ["MODEL.PRECISION", "bfloat16", "TPU.UPLOAD_FORMAT", "yuv420"]
    tcfg = setup_eval_cfg(CONFIG, PARITY_TINY + prod_opts)
    assert tcfg.TPU.SAMPLING_IMPL == "vmem" and tcfg.TPU.ASSOC_PRECISION == ""
    jcfg = jax_cfg(CONFIG, PARITY_TINY + ref_opts)
    key, x = jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))  # init_params' key and canvas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
        params = jax.tree.map(np.asarray, jax.jit(jax_build(jcfg).init)(key, x))
        ref = JaxPredictor(jcfg, params=params).process_video([f.copy() for f in frames])
    sd = params_from_jax(params, tcfg)
    prod = [VideoPredictor(tcfg, state_dict=sd, device="cpu").process_video(
        [f.copy() for f in frames]) for _ in range(2)]
    return ref, prod


def test_production_chain_matches_jax_reference(production_runs):
    """The port's production chain against JAX's f32 / RGB / 'xla' one: at least 15
    IoU-matched detections, coverage >= 0.5, id consistency >= 0.8 over all pairs and
    >= 0.85 over tight ones (tests/test_production_parity.py:176-182)."""
    ref, (prod, _) = production_runs
    assert len(ref) == len(prod) and sum(len(f) for f in ref) > 0
    cov, cons_all, cons_tight, n_pairs = track_agreement(ref, prod)
    print(f"\nport production chain vs JAX f32/rgb/xla: coverage={cov:.3f} "
          f"consistency all={cons_all:.3f} tight={cons_tight:.3f} over {n_pairs} pairs")
    assert n_pairs >= 15
    assert cov >= 0.5 and cons_all >= 0.8 and cons_tight >= 0.85, (cov, cons_all, cons_tight)


def test_production_chain_deterministic(production_runs):
    _, (a, b) = production_runs
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa.track_ids, fb.track_ids)
        np.testing.assert_array_equal(fa.ctrl_points, fb.ctrl_points)




def test_tracker_cli_production_training_resumes(tmp_path, monkeypatch):
    """``train_net --task tracker --cpu`` with MODEL.PRECISION bfloat16 and
    TPU.TRAIN_UPLOAD_FORMAT yuv420: every clip goes to the spot as uint8 I420 and the
    spotter runs bf16; the checkpoint holds the spotter in f32, equal to the weights the run
    started from, beside the moved f32 head; 2 iterations and a --resume for a third end at
    the same losses, checkpoint and optimizer moments as 3 iterations in one run."""
    from gomatching_tpu_torch import train_net
    from gomatching_tpu_torch.config import setup_train_cfg
    from gomatching_tpu_torch.data.datasets import register_dataset
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint, load_train_state
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import init_state_dict
    from test_torch_train_tracker_cli import TINY, _cli_args, _write_dataset

    register_dataset("synth_port_tracker", *_write_dataset(tmp_path))
    seen = []
    spot = Trainer.spot

    def record(self, images, image_hw=None):
        seen.append((images.dtype, images.ndim, self.model.compute_dtype))
        return spot(self, images, image_hw)

    monkeypatch.setattr(Trainer, "spot", record)
    prod = ["MODEL.PRECISION", "bfloat16", "TPU.TRAIN_UPLOAD_FORMAT", "yuv420",
            "MODEL.ASSO_HEAD.DROPOUT", "0.0", "SOLVER.WARMUP_FACTOR", "1.0"]
    full = train_net.main(_cli_args(tmp_path, "full", *prod, max_iter=3))
    assert all(np.isfinite(h["total_loss"]) for h in full)
    assert seen == [(np.uint8, 3, torch.bfloat16)] * 3
    train_net.main(_cli_args(tmp_path, "split", *prod, max_iter=2))
    rest = train_net.main(["--resume"] + _cli_args(tmp_path, "split", *prod, max_iter=3))
    assert len(rest) == 1
    for k in ("total_loss", "loss_res", "loss_long_asso", "loss_short_asso"):
        assert rest[0][k] == full[2][k], k
    ckpt = "checkpoints/model_0000003_rescore.pth"
    a, b = (load_checkpoint(str(tmp_path / d / ckpt)) for d in ("full", "split"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    init = train_net.init_rescoring_from_classifier(init_state_dict(
        setup_train_cfg(CONFIG, list(TINY)), torch.Generator().manual_seed(3)))
    assert set(a) == set(init) and all(v.dtype == init[k].dtype for k, v in a.items())
    moved = {k for k in a if not torch.equal(a[k], init[k])}
    assert moved == {k for k in a if k.startswith("roi_heads.")}
    sa, sb = (load_train_state(str(tmp_path / d / "checkpoints/state_0000003.pth"))
              for d in ("full", "split"))
    for i, st in sa["optimizer"]["state"].items():
        assert torch.equal(st["exp_avg"], sb["optimizer"]["state"][i]["exp_avg"])
