"""Every checkpoint form the repository's converter reads (tools/convert_torch_weights.py
:304-310) loads through the port's ``MODEL.WEIGHTS``: a detectron2 ``.pkl`` (a latin1
pickle of ``{'model': {name: ndarray}, '__author__', 'matching_heuristics'}``) at pickle
protocols 2, 4 and 5, the same in the raw DeepSolo layout
(``detection_transformer.backbone.*``), a ``.pth`` whose optimizer state and iteration are
numpy scalars and arrays, both under the global names numpy 1.x writes
(``numpy.core.multiarray``) as well as 2.x's, and the port converter's ``.npz``. Each gives
``VideoPredictor(device="cpu")`` the same tensors as the seeded state_dict they were
written from, bit for bit. A ``.pkl`` or ``.pth`` that names any other global is refused
with a ValueError naming it, and the global is never called."""

import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

from test_torch_e2e import CONFIG, TINY_OPTS

CALLS = []


def _record_call(tag):
    """The global a hostile checkpoint names: it must never run."""
    CALLS.append(tag)
    return tag


class _Hostile:
    def __reduce__(self):
        return (_record_call, ("ran",))


@pytest.fixture(scope="module")
def seeded():
    """The tiny config, its seeded state_dict and the predictor built from it."""
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.weights import init_state_dict

    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS))
    sd = init_state_dict(cfg, torch.Generator().manual_seed(3))
    want = VideoPredictor(cfg, state_dict=sd, device="cpu").model.state_dict()
    return sd, want


def _numpy1_names(path):
    """Rewrite a pickle, or a torch zip archive's pickle, to name numpy's globals as numpy
    1.x does (``numpy.core.multiarray``, where 2.x writes ``numpy._core.multiarray``)."""
    old, new = b"numpy._core.multiarray", b"numpy.core.multiarray"
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            data = f.read()
        assert old in data
        with open(path, "wb") as f:
            f.write(data.replace(old, new))
        return
    with zipfile.ZipFile(path) as z:
        members = [(i.filename, z.read(i.filename)) for i in z.infolist()]
    assert any(old in data for name, data in members if name.endswith("data.pkl"))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for name, data in members:
            z.writestr(name, data.replace(old, new) if name.endswith("data.pkl") else data)


def _write(form, sd, path):
    arrays = {k: v.numpy() for k, v in sd.items()}
    if form.startswith("pkl"):
        if form == "pkl-raw-deepsolo":
            arrays = {k.replace("backbone.", "detection_transformer.backbone.", 1)
                      if k.startswith("backbone.0.backbone.") else k: v
                      for k, v in arrays.items()}
        protocol = {"pkl-p2": 2, "pkl-p5": 5, "pkl-numpy1-names": 2}.get(form, 4)
        with open(path, "wb") as f:
            pickle.dump({"model": arrays, "__author__": "Detectron2 Model Zoo",
                         "matching_heuristics": True}, f, protocol=protocol)
    elif form.startswith("pth"):
        torch.save({"model": sd, "iteration": np.int64(40000),
                    "optimizer": {"state": {0: {"step": np.float32(3.0),
                                                "exp_avg": np.zeros(4, np.float32)}},
                                  "param_groups": [{"lr": np.float64(5e-5)}]},
                    "scheduler": {"last_epoch": np.int64(40000), "flag": np.bool_(True)}},
                   path)
    else:  # the port converter's .npz
        from gomatching_tpu_torch.config import setup_eval_cfg
        from gomatching_tpu_torch.engine.checkpoint import save_params
        from gomatching_tpu_torch.weights import convert

        params, missing, _ = convert(sd, setup_eval_cfg(CONFIG, list(TINY_OPTS)))
        assert not missing
        save_params(path, params)
    if form.endswith("numpy1-names"):
        _numpy1_names(path)


@pytest.mark.parametrize("form", ["pkl-p2", "pkl-p4", "pkl-p5", "pkl-raw-deepsolo",
                                  "pkl-numpy1-names", "pth-numpy-state", "pth-numpy1-names",
                                  "npz-port-converter"])
def test_checkpoint_form_loads_bit_for_bit(seeded, form, tmp_path):
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor, model_weights
    from gomatching_tpu_torch.weights import build_key_map

    sd, want = seeded
    ext = ".npz" if form.startswith("npz") else ".pth" if form.startswith("pth") else ".pkl"
    path = str(tmp_path / f"weights{ext}")
    _write(form, sd, path)
    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["MODEL.WEIGHTS", path])
    loaded = model_weights(cfg)
    keys = {k.replace("detection_transformer.backbone.", "backbone.", 1) for k in loaded}
    assert set(build_key_map(cfg)) <= keys
    if ext != ".npz":  # the .npz route gives params_from_jax's numpy arrays
        assert all(isinstance(v, torch.Tensor) for v in loaded.values())
    got = VideoPredictor(cfg, device="cpu").model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("ext", [".pkl", ".pth"])
def test_foreign_global_is_refused_unrun(seeded, ext, tmp_path):
    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor

    sd, _ = seeded
    path = str(tmp_path / f"hostile{ext}")
    ckpt = {"model": {k: v.numpy() for k, v in list(sd.items())[:3]}, "hook": _Hostile()}
    if ext == ".pkl":
        with open(path, "wb") as f:
            pickle.dump(ckpt, f, protocol=2)
    else:
        torch.save(ckpt, path)
    cfg = setup_eval_cfg(CONFIG, list(TINY_OPTS) + ["MODEL.WEIGHTS", path])
    CALLS.clear()
    with pytest.raises(ValueError, match="_record_call"):
        VideoPredictor(cfg, device="cpu")
    assert CALLS == []
    assert os.path.isfile(path)


def test_not_a_checkpoint_raises(tmp_path):
    from gomatching_tpu_torch.engine.checkpoint import load_checkpoint

    path = tmp_path / "junk.pkl"
    path.write_bytes(b"not a pickle")
    with pytest.raises(ValueError, match="not a pickle of numpy arrays"):
        load_checkpoint(str(path))
    path = tmp_path / "junk.pth"
    path.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not a torch checkpoint"):
        load_checkpoint(str(path))
