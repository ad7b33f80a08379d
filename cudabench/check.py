"""The comparison that decides ``correct``: the program's first three
training steps, as the timed path ran them, against the plain reference
following the same three steps from the same weights, inputs and seeds.

Numbers compared (each a relative gap; the worse the larger):

- ``loss_sup`` / ``loss_cons``: the worst over the three steps of
  ``|program - reference| / |reference|`` of the supervised and the
  consistency loss; ``loss_sup1`` / ``loss_cons1`` the same of the first
  step alone;
- ``grad1``: by the worst leaf, the gap between the norms of the program's
  first gradient (from Adam's state) and the reference's, over the larger
  of the reference leaf's norm and the median leaf's;
- ``change3``: the same of the parameters' change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (a convolution's bias under BatchNorm: Adam moves it
  by rounding alone)."""

from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3  # of the median leaf's gradient norm


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def _worst_leaf(prog, ref, keep=None):
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return math.nan
    rn = {k: ref[k] for k in names}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in names:
        gap = abs(prog[k] - rn[k]) / max(rn[k], med)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def _rel(a, b):
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def numbers(prog, ref) -> dict:
    """``prog`` and ``ref``: {'losses': [per step {name: float}],
    'grad1': {leaf: tensor}, 'theta0': {...}, 'theta3': {...}}."""
    out = {}
    for key, name in (("supervised_loss", "loss_sup"),
                      ("consistency_loss", "loss_cons")):
        if key in ref["losses"][0]:
            gaps = [_rel(p[key], r[key]) for p, r in
                    zip(prog["losses"], ref["losses"])]
            out[name + "1"] = gaps[0]
            out[name] = max(gaps)
    g_ref = _norms(ref["grad1"])
    out["grad1"] = _worst_leaf(_norms(prog["grad1"]), g_ref)
    med = statistics.median(g_ref.values())
    keep = {k for k, v in g_ref.items() if v >= NOUGHT * med}
    d_prog = _norms({k: prog["theta3"][k] - prog["theta0"][k]
                     for k in prog["theta0"]})
    d_ref = _norms({k: ref["theta3"][k] - ref["theta0"][k]
                    for k in ref["theta0"]})
    out["change3"] = _worst_leaf(d_prog, d_ref, keep)
    return out


def judge(values: dict, limits: dict):
    """(correct, lines): every number that has a limit is finite and at
    most its limit; a line per number, with its limit or 'not compared'."""
    ok = True
    lines = []
    checked = {}
    for name, v in values.items():
        lim = limits.get(name)
        if lim is None:
            lines.append(f"check {name} {v!r} not compared")
            continue
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        checked[name] = {"value": v, "limit": lim}
        lines.append(f"check {name} {v!r} limit {lim!r} "
                     f"{'ok' if good else 'FAILED'}")
    missing = [n for n in limits if n not in values]
    if missing:
        ok = False
        lines.append(f"check missing numbers {missing}")
    return ok, lines, checked
