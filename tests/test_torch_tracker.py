"""The port's tracker chain against the reference goldens
(tests/golden/data/tracker_tiny.npz; pattern: tests/test_golden_tracker.py:85-185).

The reference roi_heads state_dict loads straight into the port's LSTMatcherHead;
the port's Tracker + associate must reproduce the reference's track ids EXACTLY
(short-term matching, long-term window re-matching with decay, centre gating and
IoU fusion, id bookkeeping, short-track removal) for the three heads of the goldens:
GoMatching ('lst'), GoMatching++ ('shared') and the positional-embedding matcher
('lstpe', box and temporal embeddings), and GoMatchingModel.detect the reference's
score fusion / threshold / scaling / rec argmax.
"""

import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "data", "tracker_tiny.npz")
H, W = 96, 128
NPTS = 5
TRACK_KW = dict(test_len=4, overlap_thresh=0.2, min_track_len=2, max_center_dist=0.3,
                decay_time=0.9, with_iou=True, not_mult_thresh=True)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _head(golden, variant="lst"):
    from gomatching_tpu_torch.models.lst_matcher import LSTMatcherHead

    pe = variant == "lstpe"
    head = LSTMatcherHead(hidden_dim=64, num_points=NPTS, feature_dim=64, num_fc=2, num_heads=4,
                          variant="shared" if variant == "shared" else "lst", no_pos_emb=not pe,
                          with_temp_emb=pe)
    pre = f"trk.{variant}.sd.roi_heads."
    head.load_state_dict(
        {k[len(pre):]: torch.from_numpy(golden[k]) for k in golden.files if k.startswith(pre)},
        strict=True,
    )
    return head.eval()


@pytest.mark.parametrize("variant", ["lst", "shared", "lstpe"])
def test_tracking_matches_reference(golden, variant):
    from gomatching_tpu_torch.tracking.tracker import FrameDetections, Tracker

    head = _head(golden, variant)
    pe = variant == "lstpe"

    @torch.no_grad()
    def associate_fn(tokens, valid, short_term, boxes=None, times=None):
        def t(a):
            return None if a is None else torch.from_numpy(a)

        return head.associate(t(tokens), t(valid), short_term, t(boxes), t(times)).numpy()

    tracker = Tracker(associate_fn, use_pos_emb=pe, **TRACK_KW)
    p = f"trk.{variant}"
    n_frames = len([k for k in golden.files if k.startswith(f"{p}.in.qf")])
    for fi in range(n_frames):
        qf = golden[f"{p}.in.qf{fi}"]
        n = qf.shape[0]
        with torch.no_grad():
            reid = head.reid(torch.from_numpy(qf)).numpy()
        det = FrameDetections(
            boxes=golden[f"{p}.in.boxes{fi}"], scores=golden[f"{p}.in.scores{fi}"],
            ctrl_points=np.zeros((n, NPTS * 2), np.float32), recs=np.zeros((n, NPTS), np.int64),
            bd=np.zeros((n, NPTS, 4), np.float32), reid=reid, image_hw=(H, W),
        )
        tracker.step(det)
        np.testing.assert_array_equal(det.track_ids, golden[f"{p}.out.ids{fi}"],
                                      err_msg=f"frame {fi}")
    assert tracker.id_count == int(golden[f"{p}.out.id_count"])
    for fi, f in enumerate(tracker.remove_short_tracks()):
        np.testing.assert_array_equal(f.track_ids, golden[f"{p}.out.pruned_ids{fi}"],
                                      err_msg=f"pruned {fi}")
        if f.reid is not None:
            np.testing.assert_allclose(f.reid, golden[f"{p}.out.reid{fi}"], rtol=1e-4, atol=1e-5)


def _check_batched_precompute(golden, variant):
    from gomatching_tpu_torch.tracking.tracker import FrameDetections, Tracker

    head = _head(golden, variant)
    pe = variant == "lstpe"
    calls = []

    @torch.no_grad()
    def associate_fn(tokens, valid, short_term, boxes=None, times=None):
        calls.append(tokens.shape[0])

        def t(a):
            return None if a is None else torch.from_numpy(a)

        return head.associate(t(tokens), t(valid), short_term, t(boxes), t(times)).numpy()

    p = f"trk.{variant}"
    n_frames = len([k for k in golden.files if k.startswith(f"{p}.in.qf")])
    dets = []
    for fi in range(n_frames):
        qf = golden[f"{p}.in.qf{fi}"]
        n = qf.shape[0]
        with torch.no_grad():
            reid = head.reid(torch.from_numpy(qf)).numpy()
        dets.append(FrameDetections(
            boxes=golden[f"{p}.in.boxes{fi}"], scores=golden[f"{p}.in.scores{fi}"],
            ctrl_points=np.zeros((n, NPTS * 2), np.float32), recs=np.zeros((n, NPTS), np.int64),
            bd=np.zeros((n, NPTS, 4), np.float32), reid=reid, image_hw=(H, W),
        ))
    tracker = Tracker(associate_fn, use_pos_emb=pe, **TRACK_KW)
    cache = tracker.precompute_short_asso(list(zip(dets[:-1], dets[1:])))
    tracker.precompute_long_asso(dets, cache)
    for fi, det in enumerate(dets):
        tracker.step(det, short_asso_cache=cache)
        np.testing.assert_array_equal(det.track_ids, golden[f"{p}.out.ids{fi}"],
                                      err_msg=f"{variant} frame {fi}")
    assert tracker.asso_stats["long_miss"] == 0
    assert len(calls) == 1 + tracker.asso_stats["long_rounds"]


def test_batched_precompute_gives_the_sequential_ids(golden):
    """precompute_short_asso / precompute_long_asso (one batched matcher call per
    pass) must leave the ids of the per-frame chain unchanged."""
    _check_batched_precompute(golden, "lst")


@pytest.mark.parametrize("variant", ["shared", "lstpe"])
def test_batched_precompute_of_the_other_heads(golden, variant):
    """The same for GoMatching++ and for the positional-embedding matcher, whose
    batched calls carry each request's own boxes and frame times."""
    _check_batched_precompute(golden, variant)


def test_detection_matches_reference(golden):
    """GoMatching.detection parity on the golden detection bundle: fusion,
    threshold selector, coordinate scaling, rec argmax."""
    from gomatching_tpu_torch.models.gomatching import GoMatchingModel

    model = GoMatchingModel(hidden_dim=64, n_heads=4, num_encoder_layers=1,
                            num_decoder_layers=1, dim_feedforward=64, num_queries=8,
                            num_points=NPTS, voc_size=10, asso_feature_dim=64, asso_num_heads=4,
                            nms_thresh=1.01).eval()  # the reference applies NMS later
    out = {
        "pred_logits": golden["det.in.cls"], "re_pred_logits": golden["det.in.cls_re"],
        "pred_ctrl_points": golden["det.in.coord"], "pred_text_logits": golden["det.in.text"],
        "pred_bd_points": golden["det.in.bd"], "query_features": golden["det.in.qf"],
    }
    out = {k: torch.from_numpy(v) for k, v in out.items()}
    with torch.no_grad():
        det = model.detect(out, torch.tensor([[H, W]], dtype=torch.float32),
                           float(golden["det.thresh"]))
    sel = det["valid"][0].numpy()
    np.testing.assert_array_equal(sel, golden["det.out.selector"])
    np.testing.assert_allclose(det["scores"][0].numpy()[sel], golden["det.out.scores"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(det["ctrl_points"][0].numpy()[sel], golden["det.out.ctrl_points"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(det["recs"][0].numpy()[sel], golden["det.out.recs"])
    np.testing.assert_allclose(det["bd"][0].numpy()[sel], golden["det.out.bd"], rtol=1e-5,
                               atol=1e-4)


def test_nms_mask_matches_jax_and_host_nms():
    """The device NMS (batched greedy over the slot axis) against the JAX
    nms_mask and the host torchvision-semantics NMS, with tied scores."""
    import jax.numpy as jnp

    from gomatching_tpu.utils.boxes import nms_mask as jax_nms
    from gomatching_tpu.utils.boxes import nms_np
    from gomatching_tpu_torch.utils.boxes import nms_mask

    rng = np.random.RandomState(0)
    B, N = 3, 24
    xy = rng.uniform(0, 40, (B, N, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (B, N, 2)).astype(np.float32)], -1)
    scores = rng.choice(np.linspace(0.1, 0.9, 9), (B, N)).astype(np.float32)  # ties
    valid = rng.rand(B, N) > 0.2
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
                   0.5).numpy()
    for b in range(B):
        want = np.asarray(jax_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                  jnp.asarray(valid[b]), 0.5))
        np.testing.assert_array_equal(got[b], want)
        idx = np.nonzero(valid[b])[0]
        kept = idx[nms_np(boxes[b][idx], scores[b][idx], 0.5)]
        np.testing.assert_array_equal(np.sort(np.nonzero(got[b])[0]), np.sort(kept))


@pytest.mark.parametrize("shape", [(5, 5), (4, 7), (7, 3)])
def test_native_hungarian_matches_scipy(shape):
    """The port's native solver (built at first use by the package's build helper)
    finds an assignment of the same optimal cost as scipy, with +inf entries."""
    from scipy.optimize import linear_sum_assignment

    from gomatching_tpu_torch.ops import _build, hungarian

    cost = np.random.RandomState(sum(shape)).rand(*shape)
    cost[0, 0] = np.inf
    assert hungarian._load_native() is not None
    assert _build.library_path(hungarian._SRC, hungarian.GXX_FLAGS).exists()
    rows, cols = hungarian.solve(cost)
    finite = np.where(np.isfinite(cost), cost, 1e15)
    want_r, want_c = linear_sum_assignment(finite)
    assert len(rows) == min(shape) and len(set(cols.tolist())) == len(cols)
    np.testing.assert_allclose(finite[rows, cols].sum(), finite[want_r, want_c].sum(), rtol=1e-12)
