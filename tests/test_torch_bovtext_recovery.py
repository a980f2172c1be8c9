"""The port's BOVText SampleRecovery (``gomatching_tpu_torch/tools/bovtext_sample_recovery``)
against the repository's ``tools/bovtext_sample_recovery.py`` on a synthetic video with
sampled GT written with cv2 (tests/test_bovtext_recovery.py's video): the same per-frame
txt files, byte for byte. Needs nothing of the reference tree."""

import os
import subprocess
import sys

from test_bovtext_recovery import _synth_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_recovery_writes_the_repository_tool_files(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from bovtext_sample_recovery import recover_video as jax_recover

    from gomatching_tpu_torch.tools.bovtext_sample_recovery import recover_video

    anno_dir, frames_dir, _ = _synth_video(tmp_path)
    want = jax_recover(anno_dir, frames_dir, str(tmp_path / "repo"))
    got = recover_video(anno_dir, frames_dir, str(tmp_path / "port"))
    assert got == want
    ref, ours = _tree(tmp_path / "repo"), _tree(tmp_path / "port")
    assert sorted(ours) == sorted(ref) and len(ref) == 30
    assert ours == ref
    assert sum(len(v.splitlines()) for v in ours.values()) > 20  # the gaps were filled


def test_recovery_cli(tmp_path):
    anno_dir, frames_dir, _ = _synth_video(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "gomatching_tpu_torch.tools.bovtext_sample_recovery",
         "--sample-anno", anno_dir, "--frames", frames_dir, "--out", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "wrote 30 frame files" in proc.stdout and len(os.listdir(tmp_path / "out")) == 30
