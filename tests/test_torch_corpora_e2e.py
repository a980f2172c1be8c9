"""The other corpora end to end on the CPU: a tiny DSText clip (GoMatching's LST-Matcher,
the nested ``DSText/<Cls>/<video>`` tree that ``list_videos`` routes on its name) and a
tiny BOVText clip (its 5462-way text head, decoded through a ``CUSTOM_DICT`` table of
5461 codepoints, CJK among them, that the test writes: ``chn_cls_list`` is not in the
repository). Each clip goes through JAX's ``VideoPredictor`` (SAMPLING_IMPL xla) and
writer, and through the port's ``eval.main --cpu`` on the same converted weights: the
XML and JSON bytes (so the track ids and the CJK transcriptions) are identical. The
port's prefetched decode and ``--show``'s eager frame list give the same XML, and
``--show`` draws every frame into ``vis/<video>/``.

f32 on both sides with the weight seed (1) and frame seed (0) of tests/test_torch_e2e.py,
whose clip has no near-degenerate polygon: cv2.minAreaRect's integer corners would
otherwise be able to differ under 1e-4 px of noise (see that file).
"""

import os
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from test_torch_e2e import TINY_OPTS, _frames  # noqa: E402

# (config, input root below tmp, class directory, video): the reference's dataset layout
CORPORA = {
    "DSText": ("GoMatching_DSText.yaml", "DSText", "Cls1_Game", "Cls1_Game_video_1"),
    "BOVText": ("GoMatching_BOVText.yaml", "BOVText", "Cls2_News", "Cls2_News_video_3"),
}


def _char_table(path):
    """5461 codepoints: ASCII letters and digits, then CJK from U+4E00 (no '#', which the
    ICDAR protocols read as don't-care)."""
    ascii_ = [ord(c) for c in "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"]
    table = ascii_ + list(range(0x4E00, 0x4E00 + 5461 - len(ascii_)))
    with open(path, "wb") as f:
        pickle.dump(table, f)
    return table


def _tree(tmp_path, corpus):
    _, root, cls, video = CORPORA[corpus]
    vdir = tmp_path / "data" / root / cls / video
    vdir.mkdir(parents=True)
    for i, f in enumerate(_frames()):
        cv2.imwrite(str(vdir / f"{i + 1}.jpg"), f)
    return str(tmp_path / "data" / root), str(vdir), video


def _jax_outputs(jcfg, params, vdir, video, out):
    """JAX's eval.py path for one video: VideoPredictor + its writer."""
    from gomatching_tpu.engine.predictor import VideoPredictor
    from gomatching_tpu.evaluation.writer import boundary_to_polygon, frame_lines, write_video_results

    predictor = VideoPredictor(jcfg, params=params)
    paths = sorted(os.listdir(vdir), key=lambda x: int(x.split(".")[0]))
    tracked = predictor.process_video([cv2.imread(os.path.join(vdir, p)) for p in paths])
    annotation = {}
    for frame_id, det in enumerate(tracked):
        polys = [boundary_to_polygon(bd) for bd in det.bd]
        texts = [predictor.decode_text(r) for r in det.recs]
        annotation[str(frame_id + 1)] = frame_lines(polys, det.track_ids, texts)
    os.makedirs(out, exist_ok=True)
    write_video_results(annotation, os.path.join(out, f"{video}.json"),
                        os.path.join(out, f"res_{video}.xml"))
    return tracked


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_corpus_clip_matches_jax(corpus, tmp_path):
    from convert_torch_weights import convert

    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu.utils.profiling import STAGES
    from gomatching_tpu_torch import eval as port_eval
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.weights import init_state_dict

    config = os.path.join(ROOT, "configs", CORPORA[corpus][0])
    opts = [o for o in TINY_OPTS if o not in ("TPU.SAMPLING_IMPL", "xla")]
    if corpus == "BOVText":
        table = _char_table(tmp_path / "chn_cls_list")
        opts += ["MODEL.TRANSFORMER.CUSTOM_DICT", str(tmp_path / "chn_cls_list")]
    tcfg = setup_eval_cfg(config, list(opts))
    assert tcfg.MODEL.ROI_HEADS.NAME == "LSTMatcher"
    sd = init_state_dict(tcfg, torch.Generator().manual_seed(1))
    weights = tmp_path / "weights.pth"
    torch.save({"model": sd}, weights)
    jcfg = jax_cfg(config, opts + ["TPU.SAMPLING_IMPL", "xla"])
    params, missing, _ = convert({k: v.numpy() for k, v in sd.items()}, jcfg)
    assert not missing

    videos_dir, vdir, video = _tree(tmp_path, corpus)
    jax_tracked = _jax_outputs(jcfg, params, vdir, video, str(tmp_path / "jax"))
    assert sum(len(f) for f in jax_tracked) > 0

    argv = ["--config-file", config, "--cpu", "--input", videos_dir]
    port_opts = ["--opts", *opts, "MODEL.WEIGHTS", str(weights)]
    res = port_eval.main(argv + ["--output", str(tmp_path / "port"), *port_opts])
    shown = port_eval.main(argv + ["--output", str(tmp_path / "shown"), "--show", *port_opts])

    # the nested <Cls>/<video> tree was read as videos, not as one flat video
    assert list(res["videos"]) == [video] and res["videos"][video][0] == len(_frames())
    xml = _read(tmp_path / "port" / "preds" / f"res_{video}.xml")
    assert xml == _read(tmp_path / "jax" / f"res_{video}.xml")
    assert _read(tmp_path / "port" / "jsons" / f"{video}.json") == \
        _read(tmp_path / "jax" / f"{video}.json")
    # prefetched decode and --show's eager list: the same XML; --show drew every frame
    assert _read(tmp_path / "shown" / "preds" / f"res_{video}.xml") == xml
    vis = tmp_path / "shown" / "vis" / video
    assert sorted(os.listdir(vis)) == sorted(f"{i + 1}.jpg" for i in range(len(_frames())))
    assert cv2.imread(str(vis / "1.jpg")).shape == _frames()[0].shape
    # JAX's nine time_cost buckets and its <output>/results directory
    assert list(res["time_cost"]) == list(STAGES)
    assert (tmp_path / "port" / "results").is_dir()
    assert (tmp_path / "port" / "preds" / f"res_{video}.txt").exists()
    if corpus == "BOVText":  # the transcriptions came through the codepoint table
        text = xml.decode("utf-8")
        assert any(chr(c) in text for c in table[62:]), "no CJK transcription in the XML"


def test_show_without_cuda_still_raises(tmp_path):
    from gomatching_tpu_torch import eval as port_eval

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-GPU behaviour")
    (tmp_path / "videos").mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.main(["--config-file", os.path.join(ROOT, "configs", "GoMatching_DSText.yaml"),
                        "--input", str(tmp_path / "videos"), "--output", str(tmp_path / "out"),
                        "--show", "--opts", "MODEL.WEIGHTS", "''"])
