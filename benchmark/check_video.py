"""The comparison that decides ``correct`` for a video cell, and its control.

The program's answers are what its timed path produced: the packed per-slot outputs
of sampled spot calls, the reference points its proposal stage chose for them, and the
affinities of sampled association calls with the tokens they were given. The plain
reference (``reference/model.py``, f32, TF32 off, with the casts the port's set-up
applies to the weights worked out again) judges each:

  proposal_gap  the distance from each of the program's reference points to the
                nearest of the reference's top 2 x nq proposals (normalized units):
                the encoder and the selection;
  score_gap     |fused score - reference| over every slot, the reference's decoder
                run from the program's reference points (the top-k selection is a
                discrete choice, so the decoder follows the program's);
  points_gap    control and boundary points, over the frame's longer side;
  reid_gap      reid embedding, over the frame's largest reference value;
  affinity_gap  association logits over valid pairs, over the call's largest
                reference logit.

Each is the widest over everything sampled. ``control_answers`` puts the reference in
the program's place in a lower precision (TF32 for a float32 cell; for a bfloat16 one,
every matrix product's inputs and output and the residual stream in float8 e4m3 with
per-tensor scales).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .reference import trunks
from .reference.model import (DecoderLayer, EncoderLayer, MatcherDecoderLayer,
                              MatcherEncoderLayer, ReferenceModel, preprocess, resize_hw)

MATCHER_KEYS = ("roi_heads.long_term_matcher.", "roi_heads.short_term_matcher.",
                "roi_heads.shared_matcher.")
FROZEN_KEYS = ("backbone.", "detection_transformer.")
READINGS = ("proposal_gap", "score_gap", "points_gap", "reid_gap", "affinity_gap")


def resize_hw_of(frame_hw, m: Dict):
    return resize_hw(frame_hw[0], frame_hw[1], m["min_size_test"], m["max_size_test"])


def unpack(packed: np.ndarray, npts: int) -> Dict[str, np.ndarray]:
    """The program's packed spot output (B, nq, K) -> its fields: score, validity, box,
    control points, recognized ids, boundary points, reid (``VideoPredictor``'s
    layout)."""
    B, nq, _ = packed.shape
    sizes = (("scores", 1), ("valid", 1), ("boxes", 4), ("ctrl_points", 2 * npts),
             ("recs", npts), ("bd", 4 * npts))
    out, i = {}, 0
    for key, n in sizes:
        out[key] = packed[..., i:i + n]
        i += n
    out["scores"] = out["scores"][..., 0]
    out["valid"] = out["valid"][..., 0] > 0.5
    out["recs"] = out["recs"].astype(np.int64)
    out["bd"] = out["bd"].reshape(B, nq, npts, 4)
    out["reid"] = packed[..., i:]
    return out


def _round(t: torch.Tensor, dtype: str) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if dtype == "bfloat16" else t.float()


def build_reference(m: Dict, state_dict: Dict[str, torch.Tensor], device) -> ReferenceModel:
    """The reference on the weights as the port holds them: the frozen spotter in
    ``precision``, the matchers in ``assoc_precision``, computed in f32."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith(FROZEN_KEYS):
            v = _round(v, m["precision"])
        elif k.startswith(MATCHER_KEYS):
            v = _round(v, m["assoc_precision"])
        sd[k] = v.float()
    with torch.device(device):  # its throwaway default init runs where it lives
        model = ReferenceModel(m)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@torch.no_grad()
def reference_spot(model: ReferenceModel, m: Dict, frames_u8: np.ndarray, ref_points,
                   device) -> List[Dict]:
    """Per frame: the reference's proposals and its decoder from ``ref_points`` (the
    program's, (B, nq, npts, 2)); one frame at a time."""
    out = []
    for b in range(len(frames_u8)):
        x = preprocess(frames_u8[b:b + 1], m, device)
        enc = model.encode(x)
        top = model.select(enc, 2 * m["num_queries"])[0]
        dec = model.decode(enc, ref_points[b:b + 1].to(device).float(), x.shape[1:3])
        out.append({"top": top, "hw": tuple(x.shape[1:3]),
                    **{k: v[0] for k, v in dec.items()}})
        del enc
    return out


def spot_readings(ref: List[Dict], program: Dict) -> Dict[str, float]:
    """Readings of one spot call: ``program`` holds the unpacked per-slot outputs
    (numpy) and ``ref_points`` (B, nq, npts, 2)."""
    r = dict.fromkeys(READINGS[:-1], 0.0)
    for b, rf in enumerate(ref):
        dev = rf["scores"].device
        pts = program["ref_points"][b].to(dev).float()
        nq = pts.shape[0]
        d = (pts[:, None] - rf["top"][None]).abs().flatten(2).amax(-1)  # (nq, 2nq)
        r["proposal_gap"] = max(r["proposal_gap"], d.amin(1).max().item())

        def t(key):
            return torch.as_tensor(np.asarray(program[key][b]), dtype=torch.float32, device=dev)

        r["score_gap"] = max(r["score_gap"], (t("scores") - rf["scores"]).abs().max().item())
        side = float(max(rf["hw"]))
        ctrl = (t("ctrl_points").view(nq, -1) - rf["ctrl_points"].reshape(nq, -1)).abs().max()
        bd = (t("bd").reshape(nq, -1) - rf["bd"].reshape(nq, -1)).abs().max()
        r["points_gap"] = max(r["points_gap"], max(ctrl.item(), bd.item()) / side)
        reid_scale = rf["reid"].abs().max().clamp(min=1e-12)
        r["reid_gap"] = max(r["reid_gap"],
                            ((t("reid") - rf["reid"]).abs().max() / reid_scale).item())
    return r


@torch.no_grad()
def affinity_reading(model: ReferenceModel, m: Dict, call: Dict, device) -> float:
    """Widest gap of one association call's logits over its valid pairs, over the
    call's largest reference logit. The tokens go in as the port casts them."""
    tokens = _round(torch.as_tensor(call["tokens"], device=device), m["assoc_precision"])
    valid = torch.as_tensor(call["valid"], device=device)
    ref = model.associate(tokens, valid, call["short_term"])
    got = torch.as_tensor(np.asarray(call["out"]), dtype=torch.float32, device=device)
    pair = valid[:, :, None] & valid[:, None, :]
    gap = ((got - ref).abs() * pair).amax()
    scale = (ref.abs() * pair).amax().clamp(min=1e-12)
    return (gap / scale).item()


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, one precision lower
# ---------------------------------------------------------------------------


def _fp8(x):
    """float8 e4m3 with one scale for the tensor (its largest magnitude to 448)."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.numel() == 0:
        return x
    s = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


# the matrix products of the reference: linears (the attention projections among them),
# convolutions, and the products inside attention and of the affinities
PRODUCTS = frozenset((F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul,
                      torch.Tensor.__matmul__, torch.bmm, torch.Tensor.bmm, torch.mm))
# the layers whose outputs carry the residual stream, with the trunk's own
STREAM_LAYERS = (EncoderLayer, DecoderLayer, MatcherEncoderLayer, MatcherDecoderLayer)


class Float8Products(TorchFunctionMode):
    """Every matrix product's inputs (weights and biases too) and its output in float8
    e4m3, one scale a tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in PRODUCTS:
            out = func(*(_fp8(a) for a in args), **{k: _fp8(v) for k, v in kwargs.items()})
            return _fp8(out)
        return func(*args, **kwargs)


@contextlib.contextmanager
def lower_precision(model: ReferenceModel, m: Dict):
    """TF32 matrix products for a float32 configuration; for bfloat16, every matrix
    product's inputs and output (``Float8Products``) and the residual stream, each
    layer's output, in float8 e4m3: the step from the bf16 program's stored activations
    to a float8 one."""
    if m["precision"] == "float32":
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return
    stream = STREAM_LAYERS + tuple(trunks.of(m).STREAM_LAYERS)
    hooks = [mod.register_forward_hook(lambda _m, _a, out: _fp8(out))
             for mod in model.modules() if isinstance(mod, stream)]
    try:
        with Float8Products():
            yield
    finally:
        for h in hooks:
            h.remove()


@torch.no_grad()
def control_answers(model: ReferenceModel, m: Dict, frames_u8: np.ndarray, device) -> Dict:
    """The reference as the program, in lower precision: its own proposals, decoder and
    heads on ``frames_u8``, in the program's unpacked layout."""
    outs = {k: [] for k in ("scores", "ctrl_points", "bd", "reid", "ref_points")}
    with lower_precision(model, m):
        for b in range(len(frames_u8)):
            x = preprocess(frames_u8[b:b + 1], m, device)
            enc = model.encode(x)
            pts = model.select(enc)
            dec = model.decode(enc, pts, x.shape[1:3])
            outs["ref_points"].append(pts[0])
            for k in ("scores", "ctrl_points", "bd", "reid"):
                outs[k].append(dec[k][0].float().cpu().numpy())
    outs["ref_points"] = torch.stack(outs["ref_points"])
    return outs


@torch.no_grad()
def control_affinity(model: ReferenceModel, m: Dict, call: Dict, device) -> Dict:
    with lower_precision(model, m):
        tokens = _round(torch.as_tensor(call["tokens"], device=device), m["assoc_precision"])
        out = model.associate(tokens, torch.as_tensor(call["valid"], device=device),
                              call["short_term"])
    return {**call, "out": out.float().cpu().numpy()}
