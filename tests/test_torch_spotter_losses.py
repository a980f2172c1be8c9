"""The port's pretraining criterion (engine/spotter_losses.py) against the reference
goldens and against the JAX package's ``SpotterCriterion`` on the same head outputs."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "data", "losses_tiny.npz")
CONFIG = os.path.join(os.path.dirname(HERE), "configs", "GoMatching_ICDAR15.yaml")
B, NQ, NPTS, VOC, S, TLEN, MAXG = 2, 8, 5, 10, 60, 25, 4
TINY_OPTS = [
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64", "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.ENC_LAYERS", "2", "MODEL.TRANSFORMER.DEC_LAYERS", "2",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64", "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5", "MODEL.TRANSFORMER.VOC_SIZE", "10",
]


def _run_jitted(fn, *args):
    """One XLA:CPU program instead of eager op-by-op dispatch, compiled without LLVM's
    expensive passes (much faster to build at these sizes; the same HLO)."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(opts)(*args)


def _cfgs():
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_train_cfg

    return jax_cfg(CONFIG, list(TINY_OPTS)), setup_train_cfg(CONFIG, list(TINY_OPTS))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    a = np.asarray(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree)


def test_criterion_matches_reference_golden():
    """The reference SetCriterion + matchers' losses (tests/golden/make_golden_losses.py)
    at the tolerance of tests/test_golden_losses.py: rtol 2e-4, atol 1e-6."""
    from gomatching_tpu_torch.engine.spotter_losses import SpotterCriterion

    golden = np.load(GOLDEN)
    crit = SpotterCriterion(_cfgs()[1])

    def bundle(name):
        return {k: golden[f"in.{name}.{k}"] for k in
                ("pred_logits", "pred_text_logits", "pred_ctrl_points", "pred_bd_points")}

    outputs = {**bundle("final"), "aux_outputs": [bundle("aux0")],
               "enc_logits": golden["in.enc.pred_logits"],
               "enc_beziers": golden["in.enc.pred_beziers"]}
    n0 = golden["tg0.labels"].shape[0]
    targets = {
        "valid": np.zeros((B, MAXG), bool),
        "ctrl_points": np.zeros((B, MAXG, NPTS, 2), np.float32),
        "texts": np.full((B, MAXG, TLEN), VOC, np.int32),
        "beziers": np.zeros((B, MAXG, 4, 2), np.float32),
        "bd_points": np.zeros((B, MAXG, NPTS, 4), np.float32),
    }
    targets["valid"][0, :n0] = True
    for k in ("ctrl_points", "texts", "beziers", "bd_points"):
        targets[k][0, :n0] = golden[f"tg0.{k}"]
    losses = crit(_torch(outputs), _torch(targets))
    keys = sorted(x[5:] for x in golden.files if x.startswith("loss."))
    assert sorted(losses) == keys
    for k in keys:
        want = float(golden[f"loss.{k}"]) * float(golden[f"w.{k}"])
        np.testing.assert_allclose(float(losses[k]), want, rtol=2e-4, atol=1e-6, err_msg=k)


def _random_case(seed):
    """Random head outputs (final, one aux layer, encoder) and padded targets with an
    empty image, a '###' text and texts too long for NPTS points (infeasible CTC)."""
    rng = np.random.RandomState(seed)

    def head():
        return {
            "pred_logits": rng.randn(B, NQ, NPTS, 1).astype(np.float32),
            "pred_text_logits": rng.randn(B, NQ, NPTS, VOC + 1).astype(np.float32),
            "pred_ctrl_points": rng.rand(B, NQ, NPTS, 2).astype(np.float32),
            "pred_bd_points": rng.rand(B, NQ, NPTS, 4).astype(np.float32),
        }

    outputs = {**head(), "aux_outputs": [head()],
               "enc_logits": rng.randn(B, S, 1).astype(np.float32),
               "enc_beziers": rng.rand(B, S, 8).astype(np.float32)}
    texts = np.full((B, MAXG, TLEN), VOC, np.int32)
    texts[0, 0, :3] = [1, 2, 3]
    texts[0, 1, :1] = [36 % VOC]
    texts[0, 2, :7] = [1, 2, 3, 4, 5, 6, 7]  # longer than NPTS: infeasible
    texts[0, 3, :4] = [4, 4, 4, 5]  # repeats: needs 6 frames, infeasible
    targets = {
        "valid": np.array([[True, True, True, True], [False] * MAXG]),
        "ctrl_points": rng.rand(B, MAXG, NPTS, 2).astype(np.float32),
        "texts": texts,
        "beziers": rng.rand(B, MAXG, 4, 2).astype(np.float32),
        "bd_points": rng.rand(B, MAXG, NPTS, 4).astype(np.float32),
    }
    return outputs, targets


@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_matches_jax(seed):
    """Identical matches for dec, aux_0 and enc; every loss, and its gradient with
    respect to every head output, at rtol 1e-4 (atol 1e-6)."""
    from gomatching_tpu.engine.spotter_losses import SpotterCriterion as JaxCriterion
    from gomatching_tpu.engine.spotter_losses import _solve_padded
    from gomatching_tpu_torch.engine.spotter_losses import SpotterCriterion, solve_padded

    jcfg, tcfg = _cfgs()
    outputs, targets = _random_case(seed)
    jcrit, crit = JaxCriterion(jcfg), SpotterCriterion(tcfg)

    jm = {k: _solve_padded(np.asarray(c), np.asarray(nv))
          for k, (c, nv) in _run_jitted(jcrit.costs, _jax(outputs), _jax(targets)).items()}
    tout = _torch(outputs)
    tm = {k: solve_padded(c.numpy(), nv.numpy())
          for k, (c, nv) in crit.costs(tout, _torch(targets)).items()}
    assert sorted(tm) == sorted(jm) == ["aux_0", "dec", "enc"]
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)

    def jax_total(o, tg, matches):
        losses = jcrit(o, tg, matches=matches)
        return sum(jax.tree.leaves(losses)), losses

    (_, jl), jg = _run_jitted(jax.value_and_grad(jax_total, has_aux=True), _jax(outputs),
                              _jax(targets), _jax(jm))
    leaves = [tout[k] for k in sorted(k for k in tout if k != "aux_outputs")]
    leaves += [tout["aux_outputs"][0][k] for k in sorted(tout["aux_outputs"][0])]
    for t in leaves:
        t.requires_grad_(True)
    tl = crit(tout, _torch(targets), matches={k: torch.from_numpy(v) for k, v in tm.items()})
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    torch.stack(list(tl.values())).sum().backward()
    for k in (k for k in tout if k != "aux_outputs"):
        np.testing.assert_allclose(tout[k].grad.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=f"d{k}")
    for k, t in tout["aux_outputs"][0].items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg["aux_outputs"][0][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=f"d aux {k}")


def test_ctc_cost_matrix_matches_jax():
    """Including the '###' rule, empty texts and infeasible pairs (zeroed); rtol 1e-4."""
    from gomatching_tpu.engine.spotter_losses import ctc_cost_matrix as jax_ctc
    from gomatching_tpu_torch.engine.spotter_losses import ctc_cost_matrix

    rng = np.random.RandomState(2)
    nq, G, T, voc = 6, 6, 6, 37
    logits = rng.randn(nq, T, voc + 1).astype(np.float32)
    texts = np.full((G, 25), voc, np.int32)
    texts[0, :4] = [1, 2, 3, 2]
    texts[1, :1] = [36]  # '###'
    texts[2, :6] = [5, 6, 7, 8, 9, 10]  # exactly T long: feasible
    texts[3, :4] = [3, 3, 3, 4]  # 4 labels + 2 repeats = 6 frames: feasible
    texts[4, :4] = [3, 3, 3, 3]  # 4 + 3 = 7 frames: infeasible
    # texts[5] empty
    got = ctc_cost_matrix(torch.from_numpy(logits), torch.from_numpy(texts).long(), voc).numpy()
    want = np.asarray(jax_ctc(jnp.asarray(logits), jnp.asarray(texts), voc))
    assert np.all(got[:, [1, 4, 5]] == 0) and np.all(got[:, [0, 2, 3]] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
