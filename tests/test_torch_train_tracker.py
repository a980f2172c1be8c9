"""The port's GoMatching tracker training (engine/losses.py, engine/train.py and the
masked spot of models/gomatching.py) against the JAX package and the reference goldens:
the training losses on tests/golden/data/tracker_tiny.npz, the host matching and the
losses on seeded inputs, the spot of a padded clip with its level masks, and one
optimizer step of ``Trainer`` on shared weights for the three matcher heads."""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "GoMatching_ICDAR15.yaml")
CONFIG_PP = os.path.join(ROOT, "configs", "GoMatching_PP_ICDAR15.yaml")
GOLDEN = os.path.join(ROOT, "tests", "golden", "data", "tracker_tiny.npz")
TINY = [
    "MODEL.TRANSFORMER.ENC_LAYERS", "1",
    "MODEL.TRANSFORMER.DEC_LAYERS", "1",
    "MODEL.TRANSFORMER.NUM_QUERIES", "8",
    "MODEL.TRANSFORMER.NUM_POINTS", "5",
    "MODEL.TRANSFORMER.HIDDEN_DIM", "64",
    "MODEL.TRANSFORMER.NHEADS", "4",
    "MODEL.TRANSFORMER.DIM_FEEDFORWARD", "64",
    "MODEL.ASSO_HEAD.FC_DIM", "64",
    "MODEL.ASSO_HEAD.NUM_HEADS", "4",
    "MODEL.WEIGHTS", "''",
]
VARIANTS = {
    "lst": (CONFIG, []),
    "shared": (CONFIG_PP, []),
    "lstpe": (CONFIG, ["MODEL.ASSO_HEAD.NO_POS_EMB", "False",
                       "MODEL.ASSO_HEAD.WITH_TEMP_EMB", "True"]),
}
# one step that moves the head measurably: an LR of 1e-4 without warm-up (AdamW's first
# step moves each entry by ~lr, 20x PARAM_RTOL of the largest weight; entries whose
# clipped gradient is near AdamW's eps move by less and amplify rounding), no dropout,
# and JAX's exact sampler ('xla'; the port takes its B1/B2 route, plain on the CPU)
STEP_OPTS = ["SOLVER.BASE_LR", "1e-4", "SOLVER.WARMUP_FACTOR", "1.0",
             "MODEL.ASSO_HEAD.DROPOUT", "0.0", "TPU.SAMPLING_IMPL", "xla"]
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
CANVAS = (64, 96)
FRAME_HW = np.array([[56, 80], [64, 96], [50, 72]], np.float32)  # each frame's true size
SPOT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5  # max |port - JAX| <= PARAM_RTOL * max |JAX|, per roi_heads tensor


def _seeded_params(jmodel, rng, hw=CANVAS):
    """Seeded weights in the JAX model's own tree (shapes from ``eval_shape``):
    kernels N(0, 1/fan_in), biases N(0, 0.01), norms at identity, N(0, 1) embeddings.
    No tensor starts at zero, so each updated tensor's scale is its weights', not its
    first update's (AdamW's first step turns a gradient that is zero up to rounding,
    such as an attention key bias's, into an update of either sign)."""
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "weight", "running_var"):
            a = np.ones(shape)
        elif name in ("level_embed", "point_embed", "pos_emb", "temp_emb"):
            a = rng.randn(*shape)
        elif name == "bias":
            a = 0.1 * rng.randn(*shape)
        else:  # running_mean
            a = np.zeros(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _cfgs(config, extra=()):
    from gomatching_tpu.config import setup_train_cfg as jax_cfg
    from gomatching_tpu_torch.config import setup_train_cfg

    opts = list(TINY) + list(extra)
    return jax_cfg(config, opts), setup_train_cfg(config, opts)


def _targets(rng, npts=5):
    """GT of a 3-frame clip: two tracks in frames 0 and 1, nothing in frame 2."""
    out = {"gt_ctrl": [], "gt_boxes": [], "gt_ids": []}
    for t in range(3):
        g = 2 if t < 2 else 0
        lo = rng.rand(g, 2) * 0.4
        out["gt_boxes"].append(np.concatenate([lo, lo + 0.3 + 0.3 * rng.rand(g, 2)], 1)
                               .astype(np.float32))
        out["gt_ctrl"].append(rng.rand(g, npts, 2).astype(np.float32))
        out["gt_ids"].append(np.arange(1, g + 1))
    return out


def _gap_threshold(fused):
    """A threshold in the widest gap between the middle fused scores, so that neither
    side's ~1e-7 differences can move a proposal across it."""
    s = np.sort(fused.ravel())
    lo, hi = len(s) * 3 // 10, len(s) * 7 // 10
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[i] + s[i + 1]) / 2)


def _fused(host):
    sig = lambda x: 1 / (1 + np.exp(-x.mean(2)[..., 0]))
    return np.maximum(sig(host["pred_logits"]), sig(host["re_pred_logits"]))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_training_losses_match_reference(golden):
    """The port's prepare_batch and loss on the golden clip (3 frames, the last without
    GT) against the reference's loss_res and long/short association losses, at the
    bounds of tests/test_golden_tracker.py:239-247 (rtol 1e-4 / 1e-4 / 1e-3)."""
    from gomatching_tpu_torch.config import get_cfg
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import init_state_dict

    p = "trainloss"
    cfg = get_cfg()
    t, a = cfg.MODEL.TRANSFORMER, cfg.MODEL.ASSO_HEAD
    t.HIDDEN_DIM, t.NHEADS, t.ENC_LAYERS, t.DEC_LAYERS, t.DIM_FEEDFORWARD = 64, 4, 1, 1, 64
    t.NUM_QUERIES, t.NUM_POINTS, t.VOC_SIZE = 8, 5, 10
    a.FC_DIM, a.NUM_FC, a.NUM_HEADS, a.NUM_WEIGHT_LAYERS, a.NO_POS_EMB = 64, 2, 4, 0, True
    a.DROPOUT = 0.0
    cfg.MODEL.FREEZE_TYPE = "ExceptROIheads"
    t.INFERENCE_TH_TRAIN = a.ASSO_THRESH = float(golden[f"{p}.thresh"])
    sd = init_state_dict(cfg, torch.Generator().manual_seed(0))
    pre = "trk.lst.sd."
    sd.update({k[len(pre):]: torch.from_numpy(golden[k]) for k in golden.files
               if k.startswith(pre + "roi_heads.")})
    tr = Trainer(cfg, sd, device="cpu")
    H, W = 96, 128
    T = golden[f"{p}.pred_logits"].shape[0]
    spot = {"pred_logits": golden[f"{p}.pred_logits"], "re_pred_logits": golden[f"{p}.re_logits"],
            "pred_ctrl_points": golden[f"{p}.ctrl"], "pred_bd_points": golden[f"{p}.bd"]}
    targets = {
        "gt_ctrl": [golden[f"{p}.res_ctrl{t}"] for t in range(T)],
        "gt_boxes": [golden[f"{p}.gt_boxes{t}"] / np.asarray([W, H, W, H], np.float32)
                     for t in range(T)],
        "gt_ids": [golden[f"{p}.gt_ids{t}"] for t in range(T)],
    }
    batch = tr.prepare_batch(spot, targets)
    assert batch["prop_valid"].any() and (batch["asso_gt"] < 8).any()
    with torch.no_grad():
        _, losses = tr.loss(tr.to_device(batch), torch.from_numpy(golden[f"{p}.qf"]))
    for key, ref, rtol in (("loss_res", "loss_res", 1e-4), ("loss_long_asso", "loss_long", 1e-4),
                           ("loss_short_asso", "loss_short", 1e-3)):
        np.testing.assert_allclose(float(losses[key]), float(golden[f"{p}.{ref}"]), rtol=rtol,
                                   err_msg=key)


def test_host_matching_equals_jax():
    """match_rescore and build_asso_targets give JAX's arrays exactly on seeded random
    inputs (one frame without GT, one without proposals)."""
    from gomatching_tpu.engine import losses as jl
    from gomatching_tpu_torch.engine import losses as tl

    rng = np.random.RandomState(3)
    T, nq, npts = 4, 12, 5
    re = rng.randn(T, nq, npts, 1).astype(np.float32)
    ctrl = rng.rand(T, nq, npts, 2).astype(np.float32)
    n_gt = [3, 0, 5, 2]
    gt_ctrl = [rng.rand(g, npts, 2).astype(np.float32) for g in n_gt]
    for got, want in zip(tl.match_rescore(re, ctrl, gt_ctrl, 2.0, 5.0, 0.25, 2.0),
                         jl.match_rescore(re, ctrl, gt_ctrl, 2.0, 5.0, 0.25, 2.0)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    lo = rng.rand(T, nq, 2) * 0.7
    boxes = np.concatenate([lo, lo + 0.05 + 0.3 * rng.rand(T, nq, 2)], -1).astype(np.float32)
    valid = rng.rand(T, nq) > 0.4
    valid[3] = False
    gt_lo = [rng.rand(g, 2) * 0.7 for g in n_gt]
    gt_boxes = [np.concatenate([lo, lo + 0.2], -1) for lo in gt_lo]
    gt_ids = [rng.permutation(np.arange(0, 6))[:g] for g in n_gt]
    got = tl.build_asso_targets(boxes, valid, gt_boxes, gt_ids, nq)
    want = jl.build_asso_targets(boxes, valid, gt_boxes, gt_ids, nq)
    assert (got[0] < nq).sum() > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("neg_unmatched", [True, False])
def test_losses_match_jax(neg_unmatched):
    """sigmoid_focal_loss, rescore_loss and asso_ce_loss (both NEG_UNMATCHED paths)
    within 1e-6 of JAX's, on seeded logits, masks and targets."""
    from gomatching_tpu.engine import losses as jl
    from gomatching_tpu_torch.engine import losses as tl

    rng = np.random.RandomState(5)
    logits = (3 * rng.randn(4, 6, 5, 1)).astype(np.float32)
    tgt = (rng.rand(4, 6, 5, 1) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        tl.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(tgt)).numpy(),
        np.asarray(jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-6, atol=1e-6)
    mask = tgt[..., 0, 0]
    np.testing.assert_allclose(
        float(tl.rescore_loss(torch.from_numpy(logits), torch.from_numpy(mask),
                              torch.tensor(3.0))),
        float(jl.rescore_loss(jnp.asarray(logits), jnp.asarray(mask), jnp.float32(3.0))),
        rtol=1e-6)
    M, T, nq, K = 10, 3, 6, 6
    asso = (4 * rng.randn(M, T, nq)).astype(np.float32)
    row_valid = rng.rand(M) > 0.2
    col_valid = rng.rand(T, nq) > 0.3
    asso_gt = np.where(rng.rand(K, T) > 0.4, rng.randint(0, nq, (K, T)), nq)
    cues = np.where(rng.rand(M) > 0.3, rng.randint(0, 3, M), -1)
    tv = np.arange(K) < 3
    args = (asso, row_valid, col_valid, asso_gt, cues, tv)
    got = tl.asso_ce_loss(*(torch.from_numpy(np.asarray(x)) for x in args),
                          neg_unmatched=neg_unmatched)
    want = jl.asso_ce_loss(*(jnp.asarray(x) for x in args), neg_unmatched=neg_unmatched)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_spot():
    """Seeded params per variant and the JAX Trainer's spot phase (``_spot_fn``: uint8
    frames normalized, level masks from each frame's size, SAMPLING_IMPL 'xla') on a
    padded 3-frame clip, compiled with XLA:CPU's cheap options (the same program). Every
    variant shares the 'lst' params' spotter and rescoring head, the only trainable
    params the spot reads, so one spot output serves all three:
    ({variant: params}, frames, spot outputs)."""
    from gomatching_tpu.engine.train import Trainer as JaxTrainer
    from gomatching_tpu.models.gomatching import build_model as jax_build

    params = {}
    for variant, (config, extra) in VARIANTS.items():
        jcfg, _ = _cfgs(config, STEP_OPTS + extra)
        p = _seeded_params(jax_build(jcfg), np.random.RandomState(1))["params"]
        if params:
            lst = params["lst"]["params"]
            p = {**p, "backbone": lst["backbone"],
                 "detection_transformer": lst["detection_transformer"],
                 "roi_heads": {**p["roi_heads"],
                               "rescoring_head": lst["roi_heads"]["rescoring_head"]}}
        params[variant] = {"params": p}
    jcfg, _ = _cfgs(CONFIG, STEP_OPTS)
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params["lst"])
    images = np.random.RandomState(0).randint(0, 256, (3, *CANVAS, 3)).astype(np.uint8)
    args = (jtr.state.frozen, jtr.state.trainable, images, FRAME_HW)
    out = jax.jit(jtr._spot_fn).lower(*args).compile(FAST_COMPILE)(*args)
    return params, images, out


def test_spot_with_image_hw_matches_jax(jax_spot):
    """The port's Trainer.spot (uint8 frames normalized on the device, then
    ``GoMatchingModel.spot(images, image_hw)`` with the level masks) against JAX's on a
    padded canvas whose frames have three different true sizes, within SPOT_ATOL."""
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.models.gomatching import level_masks
    from gomatching_tpu_torch.weights import params_from_jax

    params, images, jout = jax_spot
    params = params["lst"]
    _, tcfg = _cfgs(CONFIG, STEP_OPTS)
    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    masks = level_masks(CANVAS, torch.from_numpy(FRAME_HW))
    assert [tuple(m.shape) for m in masks] == [(3, 8, 12), (3, 4, 6), (3, 2, 3)]
    assert masks[0].any() and not masks[0][1].any()
    out = tr.spot(images, FRAME_HW)
    for k in ("pred_logits", "re_pred_logits", "pred_ctrl_points", "pred_bd_points",
              "query_features"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=SPOT_ATOL,
                                   atol=SPOT_ATOL, err_msg=k)
    # the masks matter: the same frames without them give other outputs
    unmasked = tr.spot(images, None)["pred_logits"].numpy()
    assert np.abs(unmasked - np.asarray(jout["pred_logits"])).max() > 1e-3


def _adam_mu(opt_state):
    import optax

    found = []
    jax.tree_util.tree_map(lambda x: x, opt_state, is_leaf=lambda x: isinstance(
        x, optax.ScaleByAdamState) and not found.append(x))
    # one Adam state per LR group of multi_transform; only the group that holds the
    # head's parameters has array leaves
    found = [s for s in found if jax.tree.leaves(s.mu)]
    assert len(found) == 1, found
    return found[0].mu


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_matches_jax(jax_spot, variant, monkeypatch):
    """One Trainer.step on shared weights, dropout off, on the padded 3-frame clip with an
    empty-GT frame, against JAX ``Trainer.step`` (its spot phase the fixture's): the same proposals, rescore matches and association targets; losses within
    LOSS_RTOL; AdamW's first moment (0.1 x the clipped gradient) and every updated
    roi_heads tensor within PARAM_RTOL of JAX's largest entry. The thresholds sit in a
    gap of the fused scores, so both sides keep the same proposals. JAX's programs are
    compiled with XLA:CPU's cheap options (the same programs)."""
    from gomatching_tpu.engine.train import Trainer as JaxTrainer, merge_params, unpack_spot_meta
    from gomatching_tpu.models.gomatching import build_model as jax_build
    from gomatching_tpu_torch.engine.train import Trainer
    from gomatching_tpu_torch.weights import params_from_jax

    config, extra = VARIANTS[variant]
    params, images, jout = jax_spot
    params = params[variant]
    jhost = unpack_spot_meta(np.asarray(jout["host_meta"]))
    th = _gap_threshold(_fused(jhost))
    opts = STEP_OPTS + extra + ["MODEL.TRANSFORMER.INFERENCE_TH_TRAIN", str(th),
                                "MODEL.ASSO_HEAD.ASSO_THRESH", str(th)]
    jcfg, tcfg = _cfgs(config, opts)
    targets = _targets(np.random.RandomState(2))

    # the JAX trainer's update program compiled with the cheap options too
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=FAST_COMPILE))
    jtr = JaxTrainer(jcfg, jax_build(jcfg), params)
    jtr._spot = lambda *args: jout  # the fixture's spot of these params and frames
    jbatch = jtr.prepare_batch(jhost, targets)
    jmetrics = jtr.step(images, FRAME_HW, targets)

    tr = Trainer(tcfg, params_from_jax(params, tcfg), device="cpu")
    before = {k: v.clone() for k, v in tr.model.roi_heads.state_dict().items()}
    spot_out = tr.spot(images, FRAME_HW)
    batch = tr.prepare_batch(tr.host_fields(spot_out), targets)
    metrics = tr.update(batch, spot_out["query_features"])

    pv = batch["prop_valid"]
    assert pv.any() and not pv.all() and (batch["asso_gt"] < pv.shape[1]).any()
    assert batch["res_match_mask"].sum() == 4 and not batch["res_match_mask"][2].any()
    assert sorted(batch) == sorted(jbatch)
    for k in jbatch:
        if k == "prop_boxes":
            np.testing.assert_allclose(batch[k], jbatch[k], atol=SPOT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=LOSS_RTOL, err_msg=k)

    def roi(tree):
        full = params_from_jax(merge_params({"roi_heads": tree}, params["params"]), tcfg)
        return {k[len("roi_heads."):]: v for k, v in full.items() if k.startswith("roi_heads.")}

    want = roi(jax.tree.map(np.asarray, jtr.state.trainable["roi_heads"]))
    mu = roi(jax.tree.map(np.asarray, _adam_mu(jtr.state.opt_state)["roi_heads"]))
    named = dict(tr.model.roi_heads.named_parameters())
    after = tr.model.roi_heads.state_dict()
    assert set(want) == set(after) == set(named)
    lr = float(tcfg.SOLVER.BASE_LR)
    for k, w in want.items():
        got, m = after[k].numpy(), tr.optimizer.state[named[k]]["exp_avg"].numpy()
        # entries whose gradient is zero up to rounding (|mu| within 1e-6 of the
        # tensor's largest) take an update of any sign and size up to lr from AdamW's
        # eps; they are held to that bound, every other entry to PARAM_RTOL
        noise = np.abs(mu[k]) <= 1e-6 * np.abs(mu[k]).max()
        err = np.abs(got - w)[~noise]
        assert err.max() <= PARAM_RTOL * np.abs(w).max(), (k, err.max(), np.abs(w).max())
        step = got - before[k].numpy()
        assert np.abs(step).max() > 0, k  # every tensor moved
        assert np.abs(step).max() <= 1.01 * lr, (k, np.abs(step).max())
        assert np.abs(m - mu[k]).max() <= PARAM_RTOL * np.abs(mu[k]).max() + 1e-12, k
