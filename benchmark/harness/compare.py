"""The comparison that decides ``correct`` for a training cell.

Both sides run the window's first call, its steps and the refresh that
ends it, from the same inputs (``traffic/draws.py``) and give the same
readings (``readings``):

* ``loss``: each step's loss;
* ``grad``: per leaf, the norm of the first step's gradient as the optimizer
  got it (the program's: its Adam first moment after one step over
  ``1 - b1``);
* ``change``: per leaf, the norm of the parameters' change over the three
  steps, taken before step 4 moves them;
* ``grid``: the occupancy grid the refresh leaves, ``(B, G^3)``.

A leaf is one parameter tensor of one scene (a fleet's stacked parameters
are B leaves each). The numbers compared:

* ``loss_gap``: the largest ``|program - reference| / |reference|`` over the
  three steps;
* ``grad_gap`` and ``change_gap``: the largest gap of the two norms over the
  leaves, each against the reference's norm of that leaf or of the median
  leaf, whichever is larger. ``change_gap`` leaves out the leaves whose
  reference gradient is under a thousandth of the median leaf's (round-off
  moves them under Adam);
* ``occ_gap``: the mean ``|log program - log reference|`` over the cells of
  the refreshed grids (a cell holds a density, never 0). The mean and not
  the largest: over 16 steps Adam's normalised step turns the round-off of
  a table entry whose gradient is all but 0 into a step of either sign, so
  a few of 2M cells of sound runs read up to 5e-2, as far as a few of the
  control's do (``PERF.md`` gives both readings);
* ``ray_gap``: the program's own ray batches of the first call judged by
  what they say (``reference/plain_field.py:ray_gap``), from the
  reference's readings.
"""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "occ_gap", "ray_gap")
# a leaf whose reference gradient is under this share of the median leaf's
# takes no part in change_gap
QUIET_LEAF = 1e-3


def _flat(per_leaf: dict) -> np.ndarray:
    return np.concatenate([np.asarray(per_leaf[k], np.float64).reshape(-1)
                           for k in sorted(per_leaf)])


def _leaf_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> float:
    if not keep.any():
        return 0.0
    med = float(np.median(ref[keep]))
    return float(np.max(np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], med)))


def _occ_gap(prog, ref) -> float:
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if p.shape != r.shape:
        raise ValueError("the two sides' grids differ in shape")
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.abs(np.log(p) - np.log(r))
    return float(np.mean(np.where(np.isfinite(d), d, np.inf)))


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers of a program's readings against the reference's;
    ``ray_gap`` where the reference's readings carry it."""
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the two sides' leaves differ")
    lp, lr = np.asarray(prog["loss"], np.float64), np.asarray(ref["loss"], np.float64)
    g_p, g_r = _flat(prog["grad"]), _flat(ref["grad"])
    c_p, c_r = _flat(prog["change"]), _flat(ref["change"])
    if g_p.shape != g_r.shape or c_p.shape != c_r.shape or lp.shape != lr.shape:
        raise ValueError("the two sides' readings differ in shape")
    moving = g_r > QUIET_LEAF * float(np.median(g_r))
    return {"loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
            "grad_gap": _leaf_gap(g_p, g_r, np.ones_like(g_r, bool)),
            "change_gap": _leaf_gap(c_p, c_r, moving),
            "occ_gap": _occ_gap(prog["grid"], ref["grid"]),
            **({"ray_gap": float(ref["ray_gap"])} if "ray_gap" in ref else {})}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``correct`` and one ``[name, number, limit]`` per number compared; a
    number that is not finite, or missing, fails."""
    rows, ok = [], True
    for name in NUMBERS:
        v, lim = numbers.get(name, math.nan), float(limits[name])
        ok = ok and math.isfinite(v) and v <= lim
        rows.append([name, v, lim])
    return ok, rows
