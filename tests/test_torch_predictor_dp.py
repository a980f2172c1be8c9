"""Sharded inference: the port's ``VideoPredictor(group=...)`` over two spawned gloo ranks
(``TPU.SPOT_BATCH`` 4, a 7-frame video, so that the last spot batch is short and padded
to a multiple of the ranks) against JAX's mesh ``VideoPredictor`` on 2 CPU devices (the
detections, at tests/test_predictor_mesh.py's tolerances) and against the port's
single-process predictor (track ids and XML identical); a ``SPOT_BATCH`` that is not a
multiple of the ranks raises, as JAX's sharding would."""

import functools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_dp_workers as workers  # noqa: E402
from test_torch_e2e import CONFIG, TINY_OPTS, _frames  # noqa: E402
from test_torch_train_tracker import FAST_COMPILE  # noqa: E402

OPTS = list(TINY_OPTS) + ["TPU.SPOT_BATCH", "4", "SEED", "1"]
N_FRAMES = 7


def test_sharded_predictor_matches_jax_mesh_and_single_process(tmp_path, monkeypatch):
    from convert_torch_weights import convert

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.engine.predictor import VideoPredictor as JaxPredictor
    from gomatching_tpu.parallel import build_mesh
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.eval import annotate
    from gomatching_tpu_torch.evaluation.writer import write_video_results
    from gomatching_tpu_torch.parallel.launch import launch

    frames = _frames(N_FRAMES)
    out_dir = tmp_path / "dp"
    ranks = launch(workers.predict, 2, dist_url=f"file://{tmp_path / 'r'}",
                   args=(CONFIG, OPTS, frames, str(out_dir)), device="cpu", timeout_s=300)
    assert sorted(os.listdir(out_dir)) == ["video.json", "video.xml"]  # rank 0's files

    assert all("not a multiple of the 2 ranks" in r["odd_batch"] for r in ranks)
    single = VideoPredictor(setup_eval_cfg(CONFIG, OPTS), device="cpu")
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    jcfg = jax_cfg(CONFIG, OPTS)
    params, missing, _ = convert({k: v.numpy() for k, v in single.model.state_dict().items()},
                                 jcfg)
    assert not missing
    jdets = JaxPredictor(jcfg, params=params, mesh=build_mesh(devices=jax.devices()[:2])
                         ).spot_frames([f.copy() for f in frames])
    assert len(jdets) == N_FRAMES
    for r in ranks:
        assert len(r["dets"]) == N_FRAMES
        for i, ((scores, boxes, recs), j) in enumerate(zip(r["dets"], jdets)):
            assert len(scores) == len(j) > 0, i
            np.testing.assert_allclose(scores, j.scores, rtol=1e-5, atol=1e-5, err_msg=i)
            np.testing.assert_allclose(boxes, j.boxes, rtol=1e-4, atol=1e-4, err_msg=i)
            np.testing.assert_array_equal(recs, j.recs, err_msg=i)

    tracked = single.process_video([f.copy() for f in frames], window=4)
    for r in ranks:
        assert len(r["ids"]) == len(tracked)
        for ids, f in zip(r["ids"], tracked):
            np.testing.assert_array_equal(ids, f.track_ids)
    assert sum(len(f) for f in tracked) > 0
    write_video_results(annotate(single, tracked), str(tmp_path / "one.json"),
                        str(tmp_path / "one.xml"))
    assert (out_dir / "video.xml").read_text() == (tmp_path / "one.xml").read_text()
    assert (out_dir / "video.json").read_text() == (tmp_path / "one.json").read_text()

