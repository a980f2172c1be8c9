"""The I420 wire of the port (``TPU.UPLOAD_FORMAT`` and ``TPU.TRAIN_UPLOAD_FORMAT``
yuv420) against the JAX package: the host encode byte for byte, the device decode, the
fallback to BGR for odd sides, a tiny ICDAR15 clip through both predictors and the
training wire's normalized frames (tests/test_torch_train_precision.py holds one tracker
step on the I420 wire).

Tolerances: the decode is the same f32 formula on both sides, rounded to integers, so a
value can land on the other side of a .5 where the two sum in another order: at most 1
LSB, on at most 0.1% of the values. The training wire's normalized frames within rtol
2e-4, atol 1e-4 (the bound of tests/test_train_wire.py:66-68); the clip's ids and XML
identical."""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_e2e import CONFIG, TINY_OPTS, _frames
from test_torch_train_tracker import _cfgs


def _structured(b, h, w, seed=3):
    """Smooth colour gradients with sharp-edged patches: chroma edges that 4:2:0 drops."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(b):
        base = (128 + 60 * np.sin(gx / (13.0 + i)) + 40 * np.cos(gy / 17.0)).astype(np.uint8)
        fr = np.stack([base, base // 2 + 30, 255 - base], -1).astype(np.uint8)
        for _ in range(6):
            y0, x0 = rng.randint(0, h - 20), rng.randint(0, w - 40)
            fr[y0:y0 + 15, x0:x0 + 35] = rng.randint(0, 255, 3)
        fr = np.clip(fr.astype(int) + rng.randint(-4, 5, fr.shape), 0, 255)
        out.append(fr.astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("hw", [(96, 128), (98, 128), (70, 64)])
def test_encode_is_byte_equal_and_decode_matches_jax(hw):
    """encode_i420 equals JAX's byte for byte; decode_i420 of the same bytes differs from
    JAX's by at most 1 LSB on at most 0.1% of the values, also where H % 4 != 0 (98, 70:
    the U plane ends mid-row of the buffer), and stays within cv2's own round-trip error."""
    from gomatching_tpu.data.preprocess import decode_i420 as jax_decode
    from gomatching_tpu.data.preprocess import encode_i420 as jax_encode
    from gomatching_tpu_torch.data.preprocess import decode_i420, encode_i420

    frames = _structured(2, *hw)
    wire = encode_i420(frames)
    assert wire.dtype == np.uint8 and wire.shape == (2, hw[0] * 3 // 2, hw[1])
    np.testing.assert_array_equal(wire, jax_encode(frames))
    got = decode_i420(torch.from_numpy(wire)).numpy()
    want = np.asarray(jax_decode(jnp.asarray(wire)))
    assert got.shape == want.shape == frames.shape and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    cv_back = np.stack([cv2.cvtColor(w, cv2.COLOR_YUV2BGR_I420) for w in wire]).astype(np.float32)
    err, cv_err = np.abs(got - frames), np.abs(cv_back - frames)
    assert err.mean() <= cv_err.mean() + 0.5 and err.max() <= cv_err.max() + 4


def test_odd_sides_fall_back_to_bgr():
    """An odd side ships the frames as they are, at inference and in training."""
    from gomatching_tpu.engine.train import encode_train_clip as jax_encode_clip
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.engine.train import encode_train_clip

    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["TPU.UPLOAD_FORMAT", "yuv420"])
    predictor = VideoPredictor(cfg, device="cpu")
    for shape in ((2, 15, 22, 3), (2, 16, 21, 3)):
        raw = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
        assert predictor.encode_frames(raw) is raw
        assert encode_train_clip(raw, "RGB") is raw and jax_encode_clip(raw, "RGB") is raw
    even = np.zeros((2, 16, 22, 3), np.uint8)
    assert predictor.encode_frames(even).shape == (2, 24, 22)


def test_yuv420_clip_matches_jax(tmp_path):
    """A tiny ICDAR15 clip (f32) through the port's VideoPredictor with UPLOAD_FORMAT
    yuv420 and JAX's with yuv420 and 'xla', on shared weights: identical validity, texts,
    ids and XML; scores and boxes within tests/test_torch_e2e.py's tolerances. JAX's
    programs compile with XLA:CPU's default options, whose fused multiply-adds in the
    decode the port's decode_i420 computes bit for bit. The frames' seed is 1: on the
    seed-0 frames of tests/test_torch_e2e.py, I420-coded, one XML point of a random-weight
    polygon lands on a pixel boundary that the two sides' last-bit f32 differences
    straddle (x 120 against 121), the case that file's docstring describes."""
    from convert_torch_weights import convert

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import VideoPredictor as JaxPredictor
    from gomatching_tpu.evaluation.writer import write_video_results as jax_write
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results
    from gomatching_tpu_torch.weights import init_state_dict

    opts = list(TINY_OPTS) + ["TPU.UPLOAD_FORMAT", "yuv420"]
    tcfg = setup_eval_cfg(CONFIG, opts)
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(1))
    jcfg = jax_cfg(CONFIG, opts)
    params, missing, _ = convert({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert not missing
    jp = JaxPredictor(jcfg, params=params)
    tp = VideoPredictor(tcfg, state_dict=sd, device="cpu")
    assert jp.upload_format == tp.upload_format == "yuv420"
    frames = _frames(6, seed=1)
    for a, b in zip(jp.spot_frames([f.copy() for f in frames]),
                    tp.spot_frames([f.copy() for f in frames])):
        assert len(a) == len(b) > 0
        np.testing.assert_array_equal(b.recs, a.recs)
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        np.testing.assert_allclose(b.boxes, a.boxes, atol=2e-3)
    ja = jp.process_video([f.copy() for f in frames], window=3)
    tb = tp.process_video([f.copy() for f in frames], window=3)
    assert len(ja) == len(tb) == len(frames) and sum(len(f) for f in tb) > 0
    for a, b in zip(ja, tb):
        np.testing.assert_array_equal(b.track_ids, a.track_ids)
    xml = {}
    for tag, pred, tracked, write in (("jax", jp, ja, jax_write),
                                      ("port", tp, tb, write_video_results)):
        path = str(tmp_path / tag)
        write(annotate(pred, tracked), path + ".json", path + ".xml")
        with open(path + ".xml") as f:
            xml[tag] = f.read()
    assert xml["port"] == xml["jax"]


def test_training_wire_frames_match_jax_decode_wire():
    """The port's decode_wire (decode, INPUT.FORMAT's channel order, normalize, padding
    zeroed) against JAX's Trainer._decode_wire on the same I420 clip of a padded canvas,
    within rtol 2e-4, atol 1e-4."""
    from types import SimpleNamespace

    from gomatching_tpu.engine.train import Trainer as JaxTrainer
    from gomatching_tpu.engine.train import encode_train_clip as jax_encode_clip
    from gomatching_tpu_torch.engine.train import decode_wire, encode_train_clip

    _, tcfg = _cfgs(CONFIG)
    T, (H, W), (h, w) = 2, (64, 96), (60, 90)
    raw = np.zeros((T, H, W, 3), np.uint8)
    raw[:, :h, :w] = _structured(T, h, w)
    hw = np.tile(np.asarray([h, w], np.float32)[None], (T, 1))
    wire = encode_train_clip(raw, tcfg.INPUT.FORMAT)
    assert wire.shape == (T, H * 3 // 2, W)
    np.testing.assert_array_equal(wire, jax_encode_clip(raw, tcfg.INPUT.FORMAT))
    mean, std = list(tcfg.MODEL.PIXEL_MEAN), list(tcfg.MODEL.PIXEL_STD)
    jtr = SimpleNamespace(input_format=tcfg.INPUT.FORMAT, pixel_mean=np.asarray(mean, np.float32),
                          pixel_std=np.asarray(std, np.float32))
    want = np.asarray(JaxTrainer._decode_wire(jtr, jnp.asarray(wire), jnp.asarray(hw)))
    got = decode_wire(torch.from_numpy(wire), tcfg.INPUT.FORMAT, mean, std,
                      torch.from_numpy(hw)).numpy()
    assert got.shape == want.shape == (T, H, W, 3)
    assert not got[:, h:].any() and not got[:, :, w:].any()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
