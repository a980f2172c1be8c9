"""The comparison that decides ``correct`` for a training cell, and its control.

Two stretches of the program's steps are judged, each of ``checked_steps`` steps through
the window's own call: the first steps, which set-up runs from the seed's weights, and a
stretch inside the window, from a step drawn from the seed, whose starting state (the
head's parameters, AdamW's moments) the run copies when it gets there. Of each stretch
what the program produced is kept: per step the reference points its proposal stage
chose, the spot's fields its host phase read, the host phase's batch, the loss; AdamW's
first moment after the first step; the head's change over the stretch. The plain
reference (``reference/train.py``) follows each from the same start (the window's
stretch from the program's copied state, its step count, its learning rate and its
dropout draws worked out again), with the same clips, thresholds and dropout seed.
Top-k and the host matching are discrete choices, so the reference's decoder starts
from the program's reference points and its losses take the program's batch; the two
stages this skips are checked by themselves:

  proposal_gap  each of the program's reference points against the nearest of the
                reference's top 2 x nq proposals (normalized units), the worst;
  spot_gap      the spot's fields the host phase reads, each over its largest reference
                magnitude, the worst;
  host_gap      the entries of the program's batch that differ from the reference's host
                phase run on the program's own spot fields (exact: 0);
  loss_gap      each step's total loss, |program - reference| / |reference|, the worst;
  grad_gap      the first step's clipped gradient as AdamW got it (from its first moment
                before and after the step), per leaf the gap of the two norms over the
                larger of the reference leaf's norm and the median leaf's, the worst;
  change_gap    each head parameter's change over the stretch, the same way.

Each is the worst over both stretches. Leaves whose reference gradient is below a
thousandth of the median leaf's take no part in the last two: they move by AdamW's
round-off alone. The control puts the reference in the program's place with TF32
matrix products and convolutions.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from .reference.train import HOST_FIELDS, host_phase, train_steps

SMALL_LEAF = 1e-3
MISSING = 1e9  # the reading of a stretch the program never reached
READINGS = ("proposal_gap", "spot_gap", "host_gap", "loss_gap", "grad_gap", "change_gap")
BATCH_KEYS = ("prop_valid", "res_match_mask", "num_inst", "asso_gt", "match_cues",
              "asso_gt_pairs")


def _follow(ref, stretch, m, tr, thresh, dropout_seed, follow=None) -> Dict:
    """The reference's steps over one stretch, leaving its head as it found it."""
    saved = {k: v.clone() for k, v in ref.roi_heads.state_dict().items()}
    try:
        return train_steps(ref, stretch["clips"], stretch["targets"], m, tr, thresh,
                           dropout_seed, follow, stretch.get("start"))
    finally:
        ref.roi_heads.load_state_dict(saved)


def _worst_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep):
    """The worst leaf's gap of norms, and its name."""
    norms = {n: want[n].float().norm() for n in keep}
    med = torch.stack(list(norms.values())).median()
    worst, name = 0.0, None
    for n in keep:
        g = got[n].to(norms[n].device).float().norm()
        gap = ((g - norms[n]).abs() / torch.maximum(norms[n], med)).item()
        if gap >= worst:
            worst, name = gap, n
    return worst, name


def stretch_readings(ref, stretch, m, tr, thresh, dropout_seed, program: Dict) -> Dict:
    """The readings of one stretch, and which leaf each leaf reading came from."""
    follow = [{"ref_points": p, "batch": b}
              for p, b in zip(program["ref_points"], program["batch"])]
    want = _follow(ref, stretch, m, tr, thresh, dropout_seed, follow)
    proposal = spot = 0.0
    host = 0
    for k, targets in enumerate(stretch["targets"]):
        pts = program["ref_points"][k].to(want["top"][k].device).float()
        d = (pts[:, :, None] - want["top"][k][:, None]).abs().flatten(3).amax(-1)
        proposal = max(proposal, d.amin(-1).max().item())
        for f in HOST_FIELDS:
            if want["host"][k][f] is None:
                continue
            a, b = np.asarray(program["host"][k][f], np.float64), want["host"][k][f]
            spot = max(spot, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)))
        mine = host_phase(program["host"][k], targets, thresh, tr["loss"])
        host += sum(int(np.sum(np.asarray(program["batch"][k][key]) != mine[key]))
                    for key in BATCH_KEYS)
    gnorm = {n: g.norm() for n, g in want["grad"].items()}
    med = torch.stack(list(gnorm.values())).median()
    keep = [n for n, v in gnorm.items() if v >= SMALL_LEAF * med]
    missing = set(want["grad"]) ^ set(program["grad"])
    if missing:
        raise RuntimeError(f"the program's trained leaves are not the reference's: {missing}")
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(program["loss"], want["loss"]))
    grad_gap, grad_leaf = _worst_leaf(program["grad"], want["grad"], keep)
    change_gap, change_leaf = _worst_leaf(program["change"], want["change"], keep)
    if change_leaf is not None:
        # where the worst leaf's change differs most, and how large the reference's
        # first gradient is there (AdamW's step is g / (|g| + eps) at first)
        g = want["grad"][change_leaf].flatten()
        d = (program["change"][change_leaf].to(g.device).flatten()
             - want["change"][change_leaf].flatten()).abs()
        i = int(d.argmax())
        change_leaf += (f" (entries {g.numel()}, |g| under 1e-6 at {int((g.abs() < 1e-6).sum())};"
                        f" largest gap {d[i].item():.3g} where |g| {g[i].abs().item():.3g})")
    return {"proposal_gap": proposal, "spot_gap": spot, "host_gap": float(host),
            "loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf},
            "draws": want["draws"]}


def readings(ref, stretches, m, tr, thresh, dropout_seed, control=None) -> Dict:
    """The worst of each reading over the stretches (the first one from the seed's
    weights; its dropout shapes tell the later ones' draws). ``control``: the control in
    the program's place."""
    worst: Dict = {}
    draws = None
    for stretch in stretches:
        if stretch["program"] is None:  # the program never got there
            r = dict.fromkeys(READINGS, MISSING)
        else:
            if stretch["start"] is not None:
                stretch["start"]["draws"] = draws
            program = stretch["program"] if control is None else control(
                ref, stretch, m, tr, thresh, dropout_seed)
            r = stretch_readings(ref, stretch, m, tr, thresh, dropout_seed, program)
            first_draws = r.pop("draws")
            draws = first_draws if draws is None else draws
            leaves = r.pop("leaves")
            step = stretch["start"]["step"] if stretch["start"] else 0
            print(f"{stretch['name']} steps from step {step}: " + ", ".join(
                f"{k} {v!r}" + (f" at {leaves[k]}" if k in leaves else "")
                for k, v in r.items()), file=sys.stderr)
        for key, v in r.items():
            worst[key] = max(worst.get(key, 0.0), v)
    return worst


def control_steps(ref, stretch, m, tr, thresh, dropout_seed) -> Dict:
    """The reference's own steps over a stretch with TF32 matrix products and
    convolutions."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return _follow(ref, stretch, m, tr, thresh, dropout_seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
