"""The port's weight converter (``weights.convert``, ``engine/checkpoint.save_params`` and
``tools/convert_torch_weights.py``) against the repository's JAX-side converter
(``tools/convert_torch_weights.convert`` and ``gomatching_tpu.engine.checkpoint``'s
``_flatten`` / ``save_params``) on the same seeded state_dict: the same ``.npz`` keys and
arrays bit for bit (dtype, shape and values), the same missing and unused keys, for the
ResNet-50, Swin-T and ViTAEv2-S trunks at their full widths under a tiny transformer, and
for the ``lst`` and ``shared`` matchers. The converted tree has the keys and shapes of the
JAX model's own params (``jax.eval_shape`` of its init). The CLI prints the repository
tool's missing / unused lines, and its ``.npz`` loads through ``MODEL.WEIGHTS`` into the
source's tensors."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_e2e import CONFIG, CONFIG_PP, ROOT, TINY_OPTS

sys.path.insert(0, os.path.join(ROOT, "tools"))

CASES = {
    "resnet50-lst": (CONFIG, []),
    "resnet50-shared": (CONFIG_PP, []),
    "swin_t-lst": (CONFIG, ["MODEL.BACKBONE.NAME", "build_swin_backbone",
                            "MODEL.SWIN.TYPE", "tiny"]),
    "vitaev2_s-lst": (CONFIG, ["MODEL.BACKBONE.NAME", "build_vitaev2_backbone"]),
}


def _configs(config, extra):
    from gomatching_tpu.config import setup_eval_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_eval_cfg

    opts = list(TINY_OPTS) + list(extra)
    return jax_cfg(config, opts), setup_eval_cfg(config, opts)


@pytest.mark.parametrize("case", list(CASES))
def test_convert_matches_jax_bit_for_bit(case):
    from convert_torch_weights import convert as jax_convert

    from gomatching_tpu.engine.checkpoint import _flatten
    from gomatching_tpu_torch.engine.checkpoint import flatten_params
    from gomatching_tpu_torch.weights import convert, init_state_dict

    jcfg, cfg = _configs(*CASES[case])
    sd = init_state_dict(cfg, torch.Generator().manual_seed(4))
    jparams, jmissing, junused = jax_convert({k: v.numpy() for k, v in sd.items()}, jcfg)
    params, missing, unused = convert(sd, cfg)
    assert missing == jmissing == []
    assert unused == junused
    got, want = flatten_params(params), _flatten(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(np.ascontiguousarray(g).view(np.uint8),
                              np.ascontiguousarray(w).view(np.uint8)), k


def test_converted_tree_is_the_jax_models_tree():
    """The converted params have the keys and shapes of JAX's ``model.init`` tree, so
    the ``.npz`` loads into the JAX package as well."""
    import jax
    import jax.numpy as jnp

    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.checkpoint import flatten_params
    from gomatching_tpu_torch.weights import convert, init_state_dict

    jcfg, cfg = _configs(*CASES["resnet50-lst"])
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                want[key] = tuple(v.shape)

    walk({"params": dict(shapes["params"])}, "")
    params, _, _ = convert(init_state_dict(cfg, torch.Generator().manual_seed(4)), cfg)
    assert {k: v.shape for k, v in flatten_params(params).items()} == want


def _tiny_yaml(tmp_path, config):
    """A config file of the tiny opts over ``config`` (the CLI takes no --opts)."""
    lines = [f"_BASE_: {config!r}", "MODEL:", "  TRANSFORMER:"]
    tiny = dict(zip(TINY_OPTS[::2], TINY_OPTS[1::2]))
    for k, v in tiny.items():
        if k.startswith("MODEL.TRANSFORMER."):
            lines.append(f"    {k.split('.')[-1]}: {v}")
    lines += ["  ASSO_HEAD:", f"    FC_DIM: {tiny['MODEL.ASSO_HEAD.FC_DIM']}"]
    path = tmp_path / "tiny.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cli_reports_missing_and_unused_as_jax(tmp_path, capsys, monkeypatch):
    """One key removed and one extra: the port's CLI prints the repository tool's two
    lines, writes the .npz JAX's CLI writes, and that .npz loads through MODEL.WEIGHTS
    into the source's tensors."""
    import convert_torch_weights as jax_tool

    from gomatching_tpu_torch.config import setup_eval_cfg
    from gomatching_tpu_torch.engine.predictor import VideoPredictor
    from gomatching_tpu_torch.tools import convert_torch_weights as tool
    from gomatching_tpu_torch.weights import init_state_dict

    yaml_path = _tiny_yaml(tmp_path, CONFIG)
    cfg = setup_eval_cfg(yaml_path, ["MODEL.WEIGHTS", "''"])
    assert cfg.MODEL.TRANSFORMER.HIDDEN_DIM == 64 and cfg.MODEL.ASSO_HEAD.FC_DIM == 64
    sd = init_state_dict(cfg, torch.Generator().manual_seed(5))
    dropped = "roi_heads.rescoring_head.bias"
    ckpt = {k: v for k, v in sd.items() if k != dropped}
    ckpt["roi_heads.extra_buffer"] = torch.zeros(3)
    src = str(tmp_path / "ckpt.pth")
    torch.save({"model": ckpt, "iteration": np.int64(7)}, src)

    missing, unused = tool.main([src, str(tmp_path / "port.npz"), "--config", yaml_path])
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["convert_torch_weights.py", src,
                                      str(tmp_path / "jax.npz"), "--config", yaml_path])
    jax_tool.main()
    jax_out = capsys.readouterr().out.splitlines()
    assert missing == [dropped] and unused[-1] == "roi_heads.extra_buffer"
    assert port_out[0] == jax_out[0] == f"WARNING: 1 expected keys missing, e.g. {[dropped]}"
    assert port_out[1] == jax_out[1]
    assert port_out[1].startswith(f"note: {len(unused)} checkpoint keys unused, e.g. ")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    # the complete checkpoint's .npz loads into the source's tensors
    torch.save({"model": sd}, str(tmp_path / "full.pth"))
    assert tool.main([str(tmp_path / "full.pth"), str(tmp_path / "full.npz"),
                      "--config", yaml_path])[0] == []
    want = VideoPredictor(cfg, state_dict=sd, device="cpu").model.state_dict()
    got = VideoPredictor(setup_eval_cfg(yaml_path, ["MODEL.WEIGHTS", str(tmp_path / "full.npz")]),
                         device="cpu").model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
