"""The port's evaluation surface against the JAX package's: ``evaluation.mot_metrics``,
``rle``, ``image_eval`` and ``visualizer`` on synthetic submissions made from a numpy
seed (pure numpy / cv2 copies: outputs and drawn pixels exactly equal, tolerance 0), the
port's scorer ``tools.eval_tracking`` against the repository's ``tools/eval_tracking.py``
(run as a subprocess) in each protocol mode, and ``utils.prefetch``."""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quad(rng, w=320, h=240):
    x, y = rng.uniform(0, w - 60), rng.uniform(0, h - 30)
    bw, bh = rng.uniform(8, 60), rng.uniform(6, 30)
    return np.array([x, y, x + bw, y, x + bw, y + bh, x, y + bh], np.float64)


def _poly(rng, n, w=320, h=240):
    """A random (possibly non-convex) n-gon: sorted angles around a center."""
    cx, cy = rng.uniform(40, w - 40), rng.uniform(40, h - 40)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(5, 35, n)
    return np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).reshape(-1)


def _words(rng, n):
    chars = list("abcdefgHIJKLM0123") + ["中", "文", "字", "#", "'", "-"]
    return ["".join(rng.choice(chars, rng.randint(0, 7))) for _ in range(n)]


def test_mot_metrics_geometry_and_text_equal_jax():
    import gomatching_tpu.evaluation.mot_metrics as jm
    import gomatching_tpu_torch.evaluation.mot_metrics as pm

    rng = np.random.RandomState(0)
    for _ in range(60):
        a = _quad(rng) if rng.rand() < 0.5 else _poly(rng, rng.randint(3, 9))
        b = a + rng.uniform(-15, 15, a.shape) if rng.rand() < 0.7 else _poly(rng, 6)
        pa, pb = a.reshape(-1, 2), b.reshape(-1, 2)
        assert pm.polygon_iou(pa, pb) == jm.polygon_iou(pa, pb)
        assert pm._raster_iou(pa, pb) == jm._raster_iou(pa, pb)
        assert pm.intersection_over_det(a, b) == jm.intersection_over_det(a, b)
        np.testing.assert_array_equal(pm.convex_hull(pa), jm.convex_hull(pa))
    gts = [_quad(rng) for _ in range(5)] + [_poly(rng, 7)]
    hyps = [g + rng.uniform(-6, 6, g.shape) for g in gts[:4]] + [_poly(rng, 5)]
    np.testing.assert_array_equal(pm.poly_iou_matrix(gts, hyps), jm.poly_iou_matrix(gts, hyps))
    np.testing.assert_array_equal(
        pm.quad_iou_matrix(np.stack(gts[:5]), np.stack(hyps[:4])),
        jm.quad_iou_matrix(np.stack(gts[:5]), np.stack(hyps[:4])))
    words = _words(rng, 40)
    for a, b in zip(words, words[::-1]):
        assert pm.levenshtein(a, b) == jm.levenshtein(a, b)
        assert pm.text_similarity(a, b) == jm.text_similarity(a, b)
        assert pm.bovtext_similarity(a, b) == jm.bovtext_similarity(a, b)


def _det_frames(rng, n_frames=12):
    frames = []
    for _ in range(n_frames):
        gts = [_quad(rng) for _ in range(rng.randint(0, 6))]
        txts = ["###" if rng.rand() < 0.2 else "w" for _ in gts]
        preds = [g + rng.uniform(-8, 8, 8) for g in gts if rng.rand() < 0.8]
        preds += [_quad(rng) for _ in range(rng.randint(0, 3))]
        frames.append((gts, txts, preds))
    return frames


def _tracks(rng, n_frames=10, n_tracks=6):
    """Per frame: (gt ids, gt quads, hyp ids, hyp quads, (gt texts, hyp texts)) of drifting
    tracks with misses, false positives, id switches and wrong transcriptions."""
    base = [_quad(rng) for _ in range(n_tracks)]
    words = _words(rng, n_tracks)
    out = []
    for f in range(n_frames):
        g_ids, g_q, h_ids, h_q, g_t, h_t = [], [], [], [], [], []
        for t in range(n_tracks):
            if rng.rand() < 0.15:
                continue
            q = base[t] + 2.0 * f
            g_ids.append(t)
            g_q.append(q)
            g_t.append(words[t])
            if rng.rand() < 0.8:
                h_ids.append(t if rng.rand() < 0.85 else 100 + t)
                h_q.append(q + rng.uniform(-4, 4, 8))
                h_t.append(words[t] if rng.rand() < 0.7 else words[t] + "x")
        if rng.rand() < 0.4:
            h_ids.append(200 + f)
            h_q.append(_quad(rng))
            h_t.append("fp")
        out.append((g_ids, g_q, h_ids, h_q, (g_t, h_t)))
    return out


@pytest.mark.parametrize("opts", [
    {}, {"strict_threshold": True}, {"match_lowest_iou": True},
    {"text_rule": "icdar", "e2e": True}, {"text_rule": "bovtext", "text_sim_threshold": 0.9,
                                          "e2e": True},
    {"text_sim_threshold": 0.5, "e2e": True}, {"e2e": True},
])
def test_mot_accumulator_and_detection_equal_jax(opts):
    import gomatching_tpu.evaluation.mot_metrics as jm
    import gomatching_tpu_torch.evaluation.mot_metrics as pm

    opts = dict(opts)
    e2e = opts.pop("e2e", False)
    rng = np.random.RandomState(1)
    accs = [jm.MOTAccumulator(**opts), pm.MOTAccumulator(**opts)]
    for g_ids, g_q, h_ids, h_q, texts in _tracks(rng):
        for acc in accs:
            acc.update(g_ids, g_q, h_ids, h_q, texts=texts if e2e else None)
    want, got = accs[0].metrics(), accs[1].metrics()
    assert got == want
    assert want["IDSW"] > 0 and want["FP"] > 0 and want["FN"] > 0
    frames = _det_frames(rng)
    for thr in (0.5, 0.3):
        assert pm.evaluate_detection(frames, thr) == jm.evaluate_detection(frames, thr)


def test_rle_equals_jax():
    import gomatching_tpu.evaluation.rle as jr
    import gomatching_tpu_torch.evaluation.rle as pr

    rng = np.random.RandomState(2)
    for h, w in ((1, 1), (7, 5), (64, 48), (120, 33)):
        for density in (0.0, 0.05, 0.5, 1.0):
            mask = (rng.rand(h, w) < density).astype(np.uint8)
            for compressed in (False, True):
                enc = pr.encode(mask, compressed)
                assert enc == jr.encode(mask, compressed)
                np.testing.assert_array_equal(pr.decode(enc), jr.decode(enc))
                np.testing.assert_array_equal(pr.decode(enc), mask)
                if compressed:  # the str form the JSON GT carries
                    enc = dict(enc, counts=enc["counts"].decode("ascii"))
                    np.testing.assert_array_equal(pr.decode(enc), jr.decode(enc))


@pytest.mark.parametrize("word_spotting", [True, False])
def test_image_eval_equals_jax(word_spotting):
    import gomatching_tpu.evaluation.image_eval as ji
    import gomatching_tpu_torch.evaluation.image_eval as pi

    rng = np.random.RandomState(3)
    vocab = ["HELLO", "world's", "-TPU-", "ab", "中文", "a b", "street", "###"]
    per_image = []
    for _ in range(10):
        gts = [_quad(rng) for _ in range(rng.randint(0, 6))]
        g_t = [vocab[rng.randint(len(vocab))] for _ in gts]
        preds = [g + rng.uniform(-6, 6, 8) for g in gts if rng.rand() < 0.8]
        preds += [_quad(rng) for _ in range(rng.randint(0, 2))]
        p_t = [vocab[rng.randint(len(vocab))] if rng.rand() < 0.3 else "HELL0" for _ in preds]
        per_image.append((gts, g_t, preds, p_t))
    for lexicon in (None, ["HELLO", "STREET", "WORLD"]):
        kw = dict(word_spotting=word_spotting, lexicon=lexicon)
        assert pi.evaluate_image_spotting(per_image, **kw) == \
            ji.evaluate_image_spotting(per_image, **kw)
    for w in vocab + _words(rng, 30):
        assert pi.include_in_dictionary(w) == ji.include_in_dictionary(w)
        assert pi.include_in_dictionary_transcription(w) == \
            ji.include_in_dictionary_transcription(w)
        assert pi.transcription_match(w.upper(), "HELLO") == \
            ji.transcription_match(w.upper(), "HELLO")
        assert pi.lexicon_correct(w, vocab) == ji.lexicon_correct(w, vocab)


class _Det:
    def __init__(self, bd, track_ids, recs):
        self.bd, self.track_ids, self.recs = bd, track_ids, recs


@pytest.mark.parametrize("font", ["found", "none"])
def test_visualizer_pixels_equal_jax(font, monkeypatch, tmp_path):
    """The same frames, boundaries, ids and labels (ASCII and CJK) draw the same pixels,
    with a Unicode font (PIL pass) and without one (cv2's Hershey fallback)."""
    import cv2

    import gomatching_tpu.evaluation.visualizer as jv
    import gomatching_tpu_torch.evaluation.visualizer as pv

    if font == "none":
        monkeypatch.setattr(jv, "_FONT_CANDIDATES", ())
        monkeypatch.setattr(pv, "_FONT_CANDIDATES", ())
        monkeypatch.setenv("GOMATCHING_LABEL_FONT", "")
    elif jv.find_label_font() is None:
        pytest.skip("no Unicode-capable label font on this host")
    assert pv.find_label_font() == jv.find_label_font()
    for tid in (0, 7, 19, 20, 12345):
        assert pv.track_color(tid) == jv.track_color(tid)
    rng = np.random.RandomState(4)
    frames, tracked = [], []
    for f in range(3):
        frames.append(rng.randint(0, 255, (96, 128, 3), dtype=np.uint8))
        n = rng.randint(1, 4)
        top = rng.uniform(5, 120, (n, 5, 2))
        bd = np.concatenate([top, top + [0, 12]], -1)
        np.testing.assert_array_equal(pv.boundary_to_closed_polygon(bd[0]),
                                      jv.boundary_to_closed_polygon(bd[0]))
        tracked.append(_Det(bd, rng.randint(0, 40, n), [f"t{f}{i}" for i in range(n)]))
    texts = ["abc", "中文字", "(x)"]
    for frame, det in zip(frames, tracked):
        want = jv.draw_tracked_frame(frame, det.bd, det.track_ids, texts)
        got = pv.draw_tracked_frame(frame, det.bd, det.track_ids, texts)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pv.draw_tracked_frame(frame, det.bd, det.track_ids),
                                      jv.draw_tracked_frame(frame, det.bd, det.track_ids))
    decode = "".join
    jv.save_tracked_video_frames(frames, tracked, str(tmp_path / "jax"), decode_text=decode)
    pv.save_tracked_video_frames(frames, tracked, str(tmp_path / "port"), decode_text=decode)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["1.jpg", "2.jpg", "3.jpg"]
    for n in names:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / n)),
                                      cv2.imread(str(tmp_path / "jax" / n)))


def test_label_font_env_override(monkeypatch, tmp_path):
    import gomatching_tpu.evaluation.visualizer as jv
    import gomatching_tpu_torch.evaluation.visualizer as pv

    path = tmp_path / "label.ttf"
    path.write_bytes(b"")
    monkeypatch.setenv("GOMATCHING_LABEL_FONT", str(path))
    assert pv.find_label_font() == jv.find_label_font() == str(path)


# ---------------------------------------------------------------------------
# the scorer: the port's tools.eval_tracking against the repository's tool
# ---------------------------------------------------------------------------


def _icdar_tree(root):
    """Two videos of ICDAR-style GT / result XML and per-track transcriptions
    (tests/test_icdar_protocol.py's synthetic submissions)."""
    from test_icdar_protocol import _track_txt, _xml, make_video

    gt, res = root / "gt", root / "res"
    gt.mkdir()
    res.mkdir()
    for i, seed in enumerate((11, 12), start=1):
        g, r, g_txt, d_txt = make_video(seed)
        (gt / f"Video_{i}_1_1_GT.xml").write_text(_xml(g))
        (gt / f"Video_{i}_1_1_GT.txt").write_text(_track_txt(g_txt))
        (res / f"res_Video_{i}_1_1_GT.xml").write_text(_xml(r))
        (res / f"res_Video_{i}_1_1_GT.txt").write_text(_track_txt(d_txt))
    return gt, res


def _artvideo_tree(root):
    """ArTVideo GT JSON with COCO RLE masks (compressed and not; Straight and Curved
    text, '###'/'#1' don't-cares; tests/test_artvideo_protocol.py's dataset) and the
    predictions as res_<video>.xml."""
    from test_artvideo_protocol import _make_dataset
    from test_icdar_protocol import _xml

    gt_dir, res_dir, ours = _make_dataset(str(root), np.random.RandomState(5))
    xml_dir = root / "res_xml"
    xml_dir.mkdir()
    for video, frames in ours.items():
        (xml_dir / f"res_{video}.xml").write_text(_xml({
            fid: list(zip(ids, polys, txts)) for fid, (ids, polys, txts) in frames.items()}))
    return gt_dir, str(xml_dir)


def _bovtext_tree(root):
    """BOVText GT <gt>/<Cls>/<video>.json and results <res>/<video>.json
    (tests/test_bovtext_protocol.py's synthetic videos)."""
    from test_bovtext_protocol import make_video

    gt, res = root / "gt", root / "res"
    (gt / "Cls1_Test").mkdir(parents=True)
    res.mkdir()
    for seed in (1, 2):
        g, r = make_video(seed)
        (gt / "Cls1_Test" / f"Cls1_Test_video{seed}.json").write_text(json.dumps(g))
        (res / f"Cls1_Test_video{seed}.json").write_text(json.dumps(r))
    return gt, res


MODES = {
    "icdar_trk": (_icdar_tree, []),
    "icdar_e2e": (_icdar_tree, ["--e2e"]),
    "icdar_det": (_icdar_tree, ["--det"]),
    "artvideo": (_artvideo_tree, []),
    "artvideo_curve": (_artvideo_tree, ["--curve"]),
    "bovtext": (_bovtext_tree, ["--bovtext"]),
    "bovtext_e2e": (_bovtext_tree, ["--bovtext", "--e2e"]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_scorer_summary_equals_the_repository_tool(mode, tmp_path):
    from gomatching_tpu_torch.tools import eval_tracking

    make, flags = MODES[mode]
    gt, res = make(tmp_path)
    argv = ["--gt", str(gt), "--res", str(res), *flags]
    want = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "eval_tracking.py"),
                           *argv], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert want.returncode == 0, want.stderr[-2000:]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics = eval_tracking.main(argv)
    assert buf.getvalue() == want.stdout
    assert len(want.stdout.splitlines()) >= 1 and metrics
    if mode != "icdar_det":  # a scored run with errors of each kind the mode counts
        assert metrics["MOTA"] < 1 and metrics["FP"] + metrics["FN"] > 0
        assert "OVERALL" in want.stdout


# ---------------------------------------------------------------------------
# utils.prefetch and utils.profiling
# ---------------------------------------------------------------------------


def test_prefetch_keeps_order_and_reraises():
    from gomatching_tpu_torch.utils.prefetch import prefetch_iter

    def slow(n):
        for i in range(n):
            if i % 7 == 0:
                time.sleep(0.001)
            yield i

    assert list(prefetch_iter(slow(300), 4)) == list(range(300))
    assert list(prefetch_iter(iter([]), 2)) == []

    def failing():
        yield 1
        yield 2
        raise ValueError("decode failed")

    it = prefetch_iter(failing(), 8)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_profiling_equals_jax():
    from gomatching_tpu.utils import profiling as jp
    from gomatching_tpu_torch.utils import profiling as pp

    assert pp.STAGES == jp.STAGES and pp.new_time_cost() == jp.new_time_cost()
    tc = pp.new_time_cost()
    with pp.StageTimer(tc, "detector"):
        time.sleep(0.002)
    assert tc["detector"] > 0
    tc["total_time"] = 2.5
    assert pp.fps_report(tc, 10) == jp.fps_report(tc, 10) == "total_time: 2.50 FPS: 4.00"
    assert pp.fps_report(pp.new_time_cost(), 3) == jp.fps_report(jp.new_time_cost(), 3)
