"""The numbers that decide ``correct``: how far the program's outputs lie
from the reference's.

Inference: for each output, each frame's mean relative error (depths and
disparities) or mean absolute error (probabilities and the trust map),
and the worst frame of the sample, so that one altered frame shows.
Training: each checked step's loss as a relative gap; the first gradient
and the parameters' change after the checked steps by their worst leaf,
as the gap between the program's norm and the reference's over the
larger of that leaf's reference norm and the median leaf's.
"""

from __future__ import annotations

import math

import torch

RELATIVE = ("disp_mono", "depth_mvs", "depth_fused")
ABSOLUTE = ("cost_prob", "trust_mono")
# leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: they are left out of the change
QUIET_LEAF = 1e-3


def frame_errors(prog, ref):
    """{output: (B,) per-frame error} of two output dicts."""
    out = {}
    for key in RELATIVE + ABSOLUTE:
        p, r = prog[key].float(), ref[key].float()
        diff = (p - r).abs()
        if key in RELATIVE:
            diff = diff / r.abs().clamp_min(1e-12)
        err = diff.flatten(1).mean(dim=1)
        bad = ~torch.isfinite(p.flatten(1)).all(dim=1)
        out[key] = torch.where(bad, torch.full_like(err, math.inf), err)
    return out


def worst_frames(errors):
    """The worst frame of each output over a list of frame_errors."""
    return {key: max(float(e[key].max()) for e in errors)
            for key in RELATIVE + ABSOLUTE}


def nonfinite_frames(prog):
    """Frames of an output dict with a non-finite value in any output."""
    bad = None
    for key in RELATIVE + ABSOLUTE:
        b = ~torch.isfinite(prog[key].float().flatten(1)).all(dim=1)
        bad = b if bad is None else bad | b
    return int(bad.sum())


def loss_gap(prog, ref):
    if not math.isfinite(prog):
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-12)


def worst_leaf(prog, ref, keep=None):
    """max over leaves of |prog[k] - ref[k]| / max(ref[k], median ref):
    ``prog`` and ``ref`` map leaf names to norms; ``keep`` limits the
    leaves."""
    names = sorted(ref) if keep is None else sorted(keep)
    if set(prog) != set(ref):
        return math.inf
    med = sorted(ref[k] for k in names)[len(names) // 2]
    out = 0.0
    for k in names:
        if not math.isfinite(prog[k]):
            return math.inf
        out = max(out, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return out


def moving_leaves(grad_ref):
    """The leaves whose reference gradient is at least QUIET_LEAF of the
    median leaf's."""
    med = sorted(grad_ref.values())[len(grad_ref) // 2]
    return [k for k, v in grad_ref.items() if v >= QUIET_LEAF * med]


def train_numbers(prog, ref):
    """The training cell's numbers from two readings, each a dict with
    ``losses`` (one per checked step), ``grad`` and ``change`` (leaf ->
    norm)."""
    out = {f"loss_step{i + 1}": loss_gap(p, r)
           for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    moving = moving_leaves(ref["grad"])
    out["grad"] = worst_leaf(prog["grad"], ref["grad"])
    out["change"] = worst_leaf(prog["change"], ref["change"], moving)
    out["grad_median"] = median_leaf(prog["grad"], ref["grad"])
    out["change_median"] = median_leaf(prog["change"], ref["change"], moving)
    return out


def median_leaf(prog, ref, keep=None):
    """The median over leaves of the per-leaf gap of :func:`worst_leaf`."""
    names = sorted(ref) if keep is None else sorted(keep)
    if set(prog) != set(ref):
        return math.inf
    med = sorted(ref[k] for k in names)[len(names) // 2]
    gaps = sorted(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                  for k in names)
    return gaps[len(gaps) // 2]
