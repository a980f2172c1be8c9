"""Greedy NMS over the query-slot axis (``ops/nms.nms_mask``), as the CPU runs it.

The plain version (``utils/boxes.nms_mask``: N steps of batched tensor ops, which CPU
tensors take) against the JAX package's ``nms_mask`` and its host ``nms_np`` at the edge shapes
the kernel of ``ops/nms.py`` must match: N = 1, 31, 32, 33 (one keep word and a partial
second) and 300 (DSText's queries), all slots invalid, all valid, tied scores, degenerate
boxes (zero width or height: union 0, IoU 0), and pairs whose f32 IoU lands exactly on the
threshold (0.3 and 0.5: kept, since only IoU > threshold suppresses). A model of the
kernel's algorithm in torch (ranks by counting, the bitmask in 32-bit words, the word-wise
scan; ``csrc/nms.cu``) is held to the plain version bit for bit at the same cases, at
N = 1024 (the kernel's largest) and with NaN scores (sorted first, as torch.sort puts
them). ``chip_smoke.py`` holds the CUDA kernel to the plain version on the card. Also: the
wrapper routes CPU tensors to the plain version without counting a launch, and its kernel
route refuses N > 1024, other dtypes, non-contiguous inputs and other shapes before any
build or launch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gomatching_tpu.utils.boxes import nms_mask as jax_nms_mask
from gomatching_tpu.utils.boxes import nms_np
from gomatching_tpu_torch.ops import _build
from gomatching_tpu_torch.ops import nms as nms_ops
from gomatching_tpu_torch.utils import boxes as tboxes


def spotter_boxes(rng, B, N, hw=(1280, 2276)):
    """Boxes spread like the spotter's: centres over the frame, widths 10-400 px and
    heights 8-120 px, log-uniform, as xyxy f32."""
    h, w = hw
    c = rng.uniform((0, 0), (w, h), (B, N, 2))
    size = np.exp(rng.uniform(np.log((10, 8)), np.log((400, 120)), (B, N, 2)))
    return np.concatenate([c - size / 2, c + size / 2], -1).astype(np.float32)


def piled_boxes(rng, B, N):
    """Boxes all piled on one spot: a 200x60 box jittered by a few px, so most pairs
    overlap above any threshold."""
    base = np.array([500.0, 300.0, 700.0, 360.0])
    return (base + rng.uniform(-6, 6, (B, N, 4))).astype(np.float32)


def clustered_boxes(rng, B, N):
    """Boxes around N // 8 centres, jittered by up to 40 px: IoUs spread over (0, 1), so
    the scan keeps some of each cluster and suppresses others."""
    c = rng.uniform((0, 0), (1200, 700), (B, max(1, N // 8), 2))
    c = c[:, rng.randint(0, c.shape[1], N)] + rng.uniform(-40, 40, (B, N, 2))
    size = rng.uniform((40, 15), (160, 50), (B, N, 2))
    return np.concatenate([c - size / 2, c + size / 2], -1).astype(np.float32)


def exact_pairs(offset, higher, lower):
    """Two boxes whose f32 IoU is exactly 3/10 (the f32 of 0.3: inter 3, areas 9 and 4)
    and two whose IoU is exactly 1/2 (inter 1, areas 1 and 2), shifted by ``offset``."""
    o = np.array([offset, offset, offset, offset], np.float32)
    return [(np.array([0, 0, 3, 3], np.float32) + o, higher),
            (np.array([0, 0, 4, 1], np.float32) + o, lower),
            (np.array([0, 0, 1, 1], np.float32) + o + 50, higher),
            (np.array([0, 0, 2, 1], np.float32) + o + 50, lower)]


def make_case(name):
    """(boxes (B, N, 4) f32, scores (B, N) f32, valid (B, N) bool, threshold)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    B, thr = 3, 0.5
    if name.startswith("N="):
        N = int(name[2:])
        boxes = spotter_boxes(rng, B, N)
        boxes[1] = clustered_boxes(rng, 1, N)[0]
        if N >= 300:  # one frame's boxes piled on one spot: all but one suppressed
            boxes[2] = piled_boxes(rng, 1, N)[0]
            thr = 0.3
        scores = rng.rand(B, N).astype(np.float32)
        valid = rng.rand(B, N) > 0.3
        valid[:2, 0] = True  # N = 1: a frame of one valid slot, and one of none
        valid[2, 0] &= N > 1
    elif name in ("all invalid", "all valid"):
        N = 40
        boxes = piled_boxes(rng, B, N)
        boxes[0] = spotter_boxes(rng, 1, N, hw=(200, 300))[0]
        boxes[1] = clustered_boxes(rng, 1, N)[0]
        scores = rng.rand(B, N).astype(np.float32)
        valid = np.full((B, N), name == "all valid")
    elif name == "tied scores":
        N = 64
        boxes = clustered_boxes(rng, B, N)
        boxes[2] = piled_boxes(rng, 1, N)[0]
        scores = rng.choice(np.linspace(0.1, 0.9, 5), (B, N)).astype(np.float32)
        scores[1] = 0.5  # one frame all tied: slot order alone decides
        valid = rng.rand(B, N) > 0.2
    elif name == "degenerate":
        N = 33
        boxes = spotter_boxes(rng, B, N, hw=(100, 100))
        boxes[:, ::3, 2] = boxes[:, ::3, 0]  # zero width
        boxes[:, 1::3, 3] = boxes[:, 1::3, 1]  # zero height
        boxes[1] = boxes[1, :1]  # one frame of one degenerate box repeated: union 0
        boxes[2, ::2, 2:] = boxes[2, ::2, :2] - 1  # inverted: clamped to zero area
        scores = rng.rand(B, N).astype(np.float32)
        valid = rng.rand(B, N) > 0.1
        thr = 0.0  # IoU 0 must not pass even the lowest threshold
    elif name in ("IoU on 0.3", "IoU on 0.5"):
        thr = 0.3 if name.endswith("0.3") else 0.5
        N = 20
        boxes = spotter_boxes(rng, B, N, hw=(2000, 2000))
        scores = rng.uniform(0.1, 0.8, (B, N)).astype(np.float32)
        valid = np.ones((B, N), bool)
        for b in range(B):
            for k, (box, s) in enumerate(exact_pairs(3000 + 100 * b, 0.95, 0.9)):
                boxes[b, 4 * b + k], scores[b, 4 * b + k] = box, s
    elif name == "NaN scores":  # the kernel model only: JAX sorts NaN last, torch first
        N = 48
        boxes = clustered_boxes(rng, B, N)
        scores = rng.rand(B, N).astype(np.float32)
        scores[:, ::7] = np.nan
        valid = rng.rand(B, N) > 0.2
    else:
        raise KeyError(name)
    return boxes, scores.astype(np.float32), valid, thr


JAX_CASES = ["N=1", "N=31", "N=32", "N=33", "N=300", "all invalid", "all valid", "tied scores",
             "degenerate", "IoU on 0.3", "IoU on 0.5"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_plain_nms_matches_jax_and_host(case):
    boxes, scores, valid, thr = make_case(case)
    before = dict(nms_ops.launch_counts)
    tb, ts, tv = map(torch.from_numpy, (boxes, scores, valid))
    got = nms_ops.nms_mask(tb, ts, tv, thr).numpy()
    np.testing.assert_array_equal(got, tboxes.nms_mask(tb, ts, tv, thr).numpy())
    assert nms_ops.launch_counts == before  # CPU tensors take the plain version
    assert not (got & ~valid).any()
    for b in range(boxes.shape[0]):
        want = np.asarray(jax_nms_mask(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                       jnp.asarray(valid[b]), thr))
        np.testing.assert_array_equal(got[b], want)
        idx = np.nonzero(valid[b])[0]
        kept = idx[nms_np(boxes[b][idx], scores[b][idx], thr)]
        np.testing.assert_array_equal(np.nonzero(got[b])[0], np.sort(kept))
    if case.startswith("IoU on"):  # a pair whose IoU equals the threshold keeps both
        for b in range(boxes.shape[0]):
            assert got[b, 4 * b:4 * b + 3].all()  # IoU 0.3: kept at 0.3 and at 0.5
            assert got[b, 4 * b + 3] == (thr == 0.5)  # IoU 0.5: kept at 0.5 only
    if case == "degenerate":
        assert got[1].sum() == valid[1].sum()  # IoU 0: nothing suppressed at threshold 0


def kernel_model(boxes, scores, valid, thr):
    """``csrc/nms.cu``'s algorithm in torch, step for step: each valid slot's rank counts
    the valid slots sorting before it (NaN first, then higher scores, ties by slot); the
    boxes at their ranks; bit j of row i's 32-bit words set where j < i and IoU > thr; the
    scan keeps rank i unless any word of row i ANDs a kept word; keep back in slot order."""
    B, N = scores.shape
    W = (N + 31) // 32
    keep = torch.zeros(B, N, dtype=torch.bool)
    for b in range(B):
        s, v = scores[b], valid[b]
        nan = torch.isnan(s)
        slot = torch.arange(N)
        before = torch.where(  # before[j, k]: slot j sorts before slot k
            nan[:, None] != nan[None, :], nan[:, None],
            torch.where(~nan[:, None] & (s[:, None] != s[None, :]), s[:, None] > s[None, :],
                        slot[:, None] < slot[None, :]))
        rank = (before & v[:, None]).sum(0)
        n = int(v.sum())
        by_rank = torch.empty(n, 4)
        by_rank[rank[v]] = boxes[b][v]
        over = tboxes.pairwise_iou(by_rank, by_rank) > thr
        over &= torch.arange(n)[None, :] < torch.arange(n)[:, None]
        bits = torch.zeros(n, W * 32, dtype=torch.bool)
        bits[:, :n] = over
        weights = torch.tensor([1 << k for k in range(32)], dtype=torch.int64)
        rows = (bits.view(n, W, 32).long() * weights).sum(-1)  # (n, W) words
        kept = [0] * W
        for i in range(n):
            if not any(int(rows[i, w]) & kept[w] for w in range(W)):
                kept[i >> 5] |= 1 << (i & 31)
        for k in np.nonzero(v.numpy())[0]:
            r = int(rank[k])
            keep[b, k] = bool((kept[r >> 5] >> (r & 31)) & 1)
    return keep


@pytest.mark.parametrize("case", JAX_CASES + ["N=1024", "NaN scores"])
def test_kernel_algorithm_matches_plain(case):
    boxes, scores, valid, thr = map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a, make_case(case))
    np.testing.assert_array_equal(kernel_model(boxes, scores, valid, thr).numpy(),
                                  tboxes.nms_mask(boxes, scores, valid, thr).numpy())


def _inputs(B=2, N=8):
    rng = np.random.RandomState(0)
    boxes, scores, valid, _ = (torch.from_numpy(spotter_boxes(rng, B, N)),
                               torch.from_numpy(rng.rand(B, N).astype(np.float32)),
                               torch.from_numpy(rng.rand(B, N) > 0.3), None)
    return boxes, scores, valid


REFUSALS = {
    "N above 1024": (lambda b, s, v: (*_inputs(1, nms_ops.MAX_N + 1),), ValueError,
                     "at most 1024 slots"),
    "boxes float64": (lambda b, s, v: (b.double(), s, v), TypeError, "float32"),
    "scores float16": (lambda b, s, v: (b, s.half(), v), TypeError, "float32"),
    "valid uint8": (lambda b, s, v: (b, s, v.to(torch.uint8)), TypeError, "valid bool"),
    "boxes not contiguous": (lambda b, s, v: (b.transpose(0, 1).contiguous().transpose(0, 1),
                                              s, v), ValueError, "contiguous"),
    "scores not contiguous": (lambda b, s, v: (b, s.t().contiguous().t(), v), ValueError,
                              "contiguous"),
    "shapes": (lambda b, s, v: (b[:, :, :3], s, v), ValueError, r"\(B, N, 4\)"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_kernel_route_refuses_before_any_launch(monkeypatch, case):
    """The wrapper sends CPU tensors to the plain version before its checks, so here it is
    made to take the kernel route; each input the kernel does not take is refused before
    the library is built or a launch is counted."""
    make, err, match = REFUSALS[case]
    monkeypatch.setattr(nms_ops, "_on_cpu", lambda *tensors: False)

    def no_build(*args):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_build)
    before = dict(nms_ops.launch_counts)
    with pytest.raises(err, match=match):
        nms_ops.nms_mask(*make(*_inputs()), 0.5)
    assert nms_ops.launch_counts == before
