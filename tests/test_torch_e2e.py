"""The slice end to end: one synthetic clip through the JAX VideoPredictor
(SAMPLING_IMPL=xla, the exact sampler) and through the port's
VideoPredictor(device="cpu") on shared weights.

Expect identical per-frame validity masks, track ids and XML, and scores / boxes /
boundary points within a stated tolerance (f32 on both sides; the random-weight
scores of this seed are not tied, so threshold, NMS and Hungarian decisions agree).
The XML's quadrilaterals come from cv2.minAreaRect of each boundary polygon, which
can jump to another orientation under 1e-4 px noise when a random-weight polygon is
near-degenerate (about 1 object in 50 at other seeds); the weight seed (1) and frame
seed (0) here have no such polygon.

The GoMatching++ case (configs/GoMatching_PP_ICDAR15.yaml, the shared matcher) runs the
port with TPU.SAMPLING_IMPL 'pallas' (B5's op; its plain version here) against JAX's
'xla': the JAX spotter calls its Pallas kernel without interpret, so 'pallas' cannot
run there on the CPU, and 'xla' is the same function.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
CONFIG_PP = os.path.join(ROOT, "configs", "GoMatching_PP_ICDAR15.yaml")

# the tiny-config recipe of tests/test_inference_e2e.py
TINY_OPTS = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.TRANSFORMER.INFERENCE_TH_TEST", "0.0001",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "INPUT.MIN_SIZE_TEST", "64",
    "INPUT.MAX_SIZE_TEST", "128",
    "MODEL.WEIGHTS", "''",
    "TPU.SPOT_BATCH", "2",
    "TPU.SAMPLING_IMPL", "xla",
]


def _frames(n=7, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, (96, 128, 3), dtype=np.uint8)
    return [np.roll(base, 3 * t, axis=1) for t in range(n)]


def _predictors(config, port_sampling="xla"):
    """The JAX predictor (SAMPLING_IMPL xla) and the port's (``port_sampling``) on the
    same seeded weights."""
    from convert_torch_weights import convert

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import VideoPredictor as JaxPredictor
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.weights import init_state_dict

    tcfg = setup_eval_cfg(config, list(TINY_OPTS) + ["TPU.SAMPLING_IMPL", port_sampling])
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(1))
    jcfg = jax_cfg(config, list(TINY_OPTS))
    params, missing, _ = convert({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert not missing
    return JaxPredictor(jcfg, params=params), VideoPredictor(tcfg, state_dict=sd, device="cpu")


@pytest.fixture(scope="module")
def predictors():
    return _predictors(CONFIG)


def _xml(predictor, tracked, annotate_fn, write_fn, path):
    write_fn(annotate_fn(predictor, tracked), str(path) + ".json", str(path) + ".xml")
    with open(str(path) + ".xml") as f:
        return f.read()


def test_clip_matches_jax(predictors, tmp_path):
    _check_clip(*predictors, tmp_path)


def test_jax_npz_weights_load_and_match_jax(predictors, tmp_path):
    """MODEL.WEIGHTS naming the JAX package's .npz params (``save_params``'s format, the
    one every shipped config names) loads in the port to the same weights, and the clip
    gives JAX's ids and XML."""
    from gomatching_tpu.engine.checkpoint import save_params
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    jp, tp = predictors
    path = tmp_path / "params.npz"
    save_params(str(path), jp.params)
    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["MODEL.WEIGHTS", str(path)])
    loaded = VideoPredictor(cfg, device="cpu")
    got, want = loaded.model.state_dict(), tp.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _check_clip(jp, loaded, tmp_path)


def test_gomatching_pp_clip_matches_jax(tmp_path, monkeypatch):
    """GoMatching++ with the port on the 'pallas' sampler: every deformable-attention
    call goes to B5's op, and ids and XML equal JAX's."""
    import gomatching_tpu_torch.models.spotter as spotter_mod

    jp, tp = _predictors(CONFIG_PP, port_sampling="pallas")
    assert tp.model.roi_heads.variant == "shared" and jp.model.roi_head_variant == "shared"
    calls = []
    merged = spotter_mod.ms_deform_attn_merged
    monkeypatch.setattr(spotter_mod, "ms_deform_attn_merged",
                        lambda *a: calls.append(1) or merged(*a))
    _check_clip(jp, tp, tmp_path)
    assert calls and len(calls) % 2 == 0  # one encoder and one decoder call per spot batch


def _check_clip(jp, tp, tmp_path):
    from gomatching_tpu.evaluation.writer import write_video_results as jax_write
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results

    frames = _frames()
    # per-frame detections before tracking: identical validity, close values
    jd, td = jp.spot_frames([f.copy() for f in frames]), tp.spot_frames([f.copy() for f in frames])
    for i, (a, b) in enumerate(zip(jd, td)):
        assert len(a) == len(b) > 0, i
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5, err_msg=f"scores {i}")
        np.testing.assert_allclose(b.boxes, a.boxes, atol=2e-3, err_msg=f"boxes {i}")
        np.testing.assert_array_equal(b.recs, a.recs, err_msg=f"recs {i}")
        np.testing.assert_allclose(b.reid, np.asarray(jp._pool)[a.pool_rows] if a.reid is None
                                   else a.reid, rtol=1e-4, atol=1e-4, err_msg=f"reid {i}")

    ja = jp.process_video([f.copy() for f in frames], window=4)
    tb = tp.process_video([f.copy() for f in frames], window=4)
    assert len(ja) == len(tb) == len(frames)
    assert sum(len(f) for f in tb) > 0
    for i, (a, b) in enumerate(zip(ja, tb)):
        np.testing.assert_array_equal(b.track_ids, a.track_ids, err_msg=f"ids {i}")
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5, err_msg=f"scores {i}")
        np.testing.assert_allclose(b.bd, a.bd, atol=2e-3, err_msg=f"bd {i}")
        np.testing.assert_allclose(b.ctrl_points, a.ctrl_points, atol=2e-3, err_msg=f"ctrl {i}")
    # the JAX writer run on JAX results vs the port's writer on the port's results
    x_jax = _xml(jp, ja, annotate, jax_write, tmp_path / "jax")
    x_port = _xml(tp, tb, annotate, write_video_results, tmp_path / "port")
    assert x_port == x_jax
    # and the two writers agree byte for byte on the same detections
    assert _xml(jp, ja, annotate, write_video_results, tmp_path / "port_on_jax") == x_jax


@pytest.mark.parametrize("hw", [(64, 85), (160, 213)])
def test_device_preprocess_matches_jax(hw):
    """Resize (antialiased bilinear, down- and upscale) + normalize vs
    jax.image.resize; atol 1e-3 on normalized pixels (std 57 -> ~0.06 levels)."""
    import jax.numpy as jnp

    from gomatching_tpu.data.preprocess import device_preprocess as jax_pre
    from gomatching_tpu_torch.data.preprocess import device_preprocess

    raw = _frames(2)[0][None].repeat(2, 0)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    got = device_preprocess(torch.from_numpy(raw), hw, mean, std, "RGB").numpy()
    want = np.asarray(jax_pre(jnp.asarray(raw), hw, mean, std, "RGB"))
    assert got.shape == want.shape == (2, hw[0], hw[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_eval_cli_on_cpu(tmp_path):
    """python -m gomatching_tpu_torch.eval --cpu writes the XML/JSON/txt tree."""
    video = tmp_path / "videos" / "Video_1_1_1"
    video.mkdir(parents=True)
    for i, f in enumerate(_frames(6)):
        cv2.imwrite(str(video / f"{i + 1}.jpg"), f)
    out = tmp_path / "out"
    opts = [o for o in TINY_OPTS if o != "TPU.SAMPLING_IMPL" and o != "xla"]
    proc = subprocess.run(
        [sys.executable, "-m", "gomatching_tpu_torch.eval", "--config-file", CONFIG, "--cpu",
         "--input", str(tmp_path / "videos"), "--output", str(out), "--opts", *opts],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert (out / "preds" / "res_Video_1_1_1.xml").exists()
    assert (out / "preds" / "res_Video_1_1_1.txt").exists()
    assert (out / "jsons" / "Video_1_1_1.json").exists()
    assert "FPS" in proc.stdout
