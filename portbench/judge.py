"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, each number beside its limit.

Render cells: for each judged frame (a sample drawn from the seed of the
frames the window completed), the reference renders the encoder's
``rgb_feature`` and ``depth`` and decodes its own encoder output; the
numbers are the relative L1 gaps ``sum|program - reference| /
sum|reference|`` of the two maps and, for the decoded frame, the L1 gap
over the reference frame's L1 deviation from its per-channel mean; each
the worst over the judged frames.

Training cells: the reference follows the program's first three steps
from the same initial parameters and batches; the numbers are the worst
relative gap of the three losses, the worst leaf's gap between the
norms of the first gradient (as the optimizer got it) and the worst
leaf's gap between the norms of the parameters' change after the three
steps, each leaf's gap over the larger of its reference norm and the
median leaf's. Leaves whose reference gradient is under a thousandth of
the median leaf's move by round-off alone and are left out of the
change.

Limits live in ``limits/<workload>.json``, found by the cell's name.
"""

from __future__ import annotations

import json
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROUND_OFF_SHARE = 1e-3


def limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def rel_l1(got, ref) -> float:
    return float((got.float() - ref.float()).abs().sum()
                 / ref.float().abs().sum().clamp_min(1e-30))


def rel_dev(got, ref) -> float:
    """The L1 gap over the reference's L1 deviation from its per-channel
    mean: a random decoder's frame is mostly a per-channel offset, which
    carries no content and swings ``rel_l1`` from seed to seed."""
    r = ref.float()
    dev = (r - r.mean(dim=tuple(range(r.dim() - 1)))).abs().sum()
    return float((got.float() - r).abs().sum() / dev.clamp_min(1e-30))


def render_numbers(pairs) -> dict:
    """``pairs``: ``[(program, reference), ...]`` of judged frames, each a
    dict of ``rgb_feature``, ``depth`` and ``frame``."""
    out = {"feat_err": 0.0, "depth_err": 0.0, "frame_err": 0.0}
    for got, ref in pairs:
        out["feat_err"] = max(out["feat_err"],
                              rel_l1(got["rgb_feature"], ref["rgb_feature"]))
        out["depth_err"] = max(out["depth_err"],
                               rel_l1(got["depth"], ref["depth"]))
        out["frame_err"] = max(out["frame_err"],
                               rel_dev(got["frame"], ref["frame"]))
    return out


def _leaf_gaps(got: dict, ref: dict, keep=None) -> tuple:
    """(the worst leaf's gap, that leaf's name)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return 0.0, None
    med = statistics.median(ref[n] for n in names)
    return max((abs(got[n] - ref[n]) / max(ref[n], med, 1e-30), n)
               for n in names)


def train_numbers(prog: dict, ref: dict, worst: dict | None = None) -> dict:
    """``prog``/``ref``: ``losses`` (3 floats), ``grad_norms`` and
    ``change_norms`` ({leaf: norm}). ``worst``, when given, receives the
    leaf behind each leaf-wise number."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = {n for n, v in g.items() if v >= ROUND_OFF_SHARE * med}
    grad_gap, grad_leaf = _leaf_gaps(prog["grad_norms"], g)
    change_gap, change_leaf = _leaf_gaps(prog["change_norms"],
                                         ref["change_norms"], moving)
    if worst is not None:
        worst.update(grad_gap=grad_leaf, change_gap=change_leaf,
                     still=sorted(set(g) - moving))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def leaf_norms(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_norms(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = float(torch.linalg.vector_norm(
                v.double()))
    return out


def verdict(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: {value, limit}}); a number over its limit, or one
    that is not finite, fails."""
    checks = {n: {"value": v, "limit": lim[n]} for n, v in numbers.items()}
    ok = all(v == v and v <= lim[n] for n, v in numbers.items())
    return ok, checks
