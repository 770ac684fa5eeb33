"""The comparison that decides ``correct`` for a training cell.

Both sides run the window's first call from the same inputs and give their
readings as a dict, one entry a kind. The kinds this module knows, each of
which gives one number where both sides give it:

* ``loss``: each of the first steps' loss; gives ``loss_gap``, the largest
  ``|program - reference| / |reference|`` over them;
* ``grad``: per leaf, the norm of the first step's gradient as the
  optimizer got it (a field's: its Adam first moment after one step over
  ``1 - b1``); gives ``grad_gap``;
* ``change``: per leaf, the norm of the parameters' change over the first
  three steps, taken before step 4 moves them; gives ``change_gap``, and
  needs the reference's ``grad``;
* ``grid``: a field's occupancy grid that the refresh leaves, ``(B, G^3)``;
  gives ``occ_gap``, the mean ``|log program - log reference|`` over the
  cells (a cell holds a density, never 0). The mean and not the largest:
  over 16 steps Adam's normalised step turns the round-off of a table entry
  whose gradient is all but 0 into a step of either sign, so a few of 2M
  cells of sound runs read up to 5e-2, as far as a few of the control's do
  (``PERF.md`` gives both readings).

A leaf is one parameter tensor of one scene (a fleet's stacked parameters
are B leaves each). ``grad_gap`` and ``change_gap`` are the largest gap of
the two norms over the leaves, each against the reference's norm of that
leaf or of the median leaf, whichever is larger; ``change_gap`` leaves out
the leaves whose reference gradient is under a thousandth of the median
leaf's (round-off moves them under Adam).

A number the reference has already judged from the program's own output
passes through from the reference's readings: a field's ``ray_gap``, the
program's ray batches judged by what they say
(``reference/plain_field.py:ray_gap``).

A kind that one side gives and the other not is an error; a kind that
neither gives gives no number. A configuration's numbers of its own come
from ``gaps(prog, ref)`` in ``reference/<config>.py`` (``numbers``). The
numbers a cell is judged on are its limits (``workloads/<cell>.json``), in
that file's order (``verdict``).
"""
from __future__ import annotations

import math

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# takes no part in change_gap
QUIET_LEAF = 1e-3
# numbers the reference computes from the program's output, passed through
JUDGED = ("ray_gap",)


def _flat(per_leaf: dict) -> np.ndarray:
    return np.concatenate([np.asarray(per_leaf[k], np.float64).reshape(-1)
                           for k in sorted(per_leaf)])


def _leaf_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> float:
    if not keep.any():
        return 0.0
    med = float(np.median(ref[keep]))
    return float(np.max(np.abs(prog[keep] - ref[keep]) / np.maximum(ref[keep], med)))


def _leaves(prog: dict, ref: dict) -> tuple[np.ndarray, np.ndarray]:
    if set(prog) != set(ref):
        raise ValueError("the two sides' leaves differ")
    p, r = _flat(prog), _flat(ref)
    if p.shape != r.shape:
        raise ValueError("the two sides' readings differ in shape")
    return p, r


def _loss_gap(prog, ref, _) -> float:
    lp, lr = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if lp.shape != lr.shape:
        raise ValueError("the two sides' readings differ in shape")
    return float(np.max(np.abs(lp - lr) / np.abs(lr)))


def _grad_gap(prog, ref, _) -> float:
    g_p, g_r = _leaves(prog, ref)
    return _leaf_gap(g_p, g_r, np.ones_like(g_r, bool))


def _change_gap(prog, ref, ref_all) -> float:
    if "grad" not in ref_all:
        raise ValueError("change_gap needs the reference's grad")
    c_p, c_r = _leaves(prog, ref)
    g_r = _flat(ref_all["grad"])
    if g_r.shape != c_r.shape:
        raise ValueError("the reference's grad and change differ in leaves")
    moving = g_r > QUIET_LEAF * float(np.median(g_r))
    return _leaf_gap(c_p, c_r, moving)


def _occ_gap(prog, ref, _) -> float:
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if p.shape != r.shape:
        raise ValueError("the two sides' grids differ in shape")
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.abs(np.log(p) - np.log(r))
    return float(np.mean(np.where(np.isfinite(d), d, np.inf)))


# kind of reading -> (the number it gives, its gap(prog, ref, the
# reference's readings))
KINDS = {"loss": ("loss_gap", _loss_gap), "grad": ("grad_gap", _grad_gap),
         "change": ("change_gap", _change_gap), "grid": ("occ_gap", _occ_gap)}


def gaps(prog: dict, ref: dict) -> dict:
    """The number of each kind of reading that both sides give, and the
    numbers of ``JUDGED`` that the reference's readings carry."""
    out = {}
    for kind, (name, gap) in KINDS.items():
        if (kind in prog) != (kind in ref):
            side = "program" if kind in prog else "reference"
            raise ValueError(f"the two sides' readings differ: only the {side} gives {kind!r}")
        if kind in prog:
            out[name] = gap(prog[kind], ref[kind], ref)
    out.update({name: float(ref[name]) for name in JUDGED if name in ref})
    return out


def numbers(prog: dict, ref: dict, own=None) -> dict:
    """``gaps`` and, given a configuration's own ``gaps(prog, ref)``, its
    numbers too; a name that both give is an error."""
    out = gaps(prog, ref)
    if own is not None:
        extra = own(prog, ref)
        both = sorted(set(out) & set(extra))
        if both:
            raise ValueError(f"numbers given twice, by the harness and the configuration: {both}")
        out.update(extra)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``correct`` and one ``[name, number, limit]`` a limit, in the limits'
    order, then one ``[name, number, None]`` for each number that no limit
    judges. Correct only if there are limits, every limit has a finite
    number at or under it and every number has a limit."""
    rows, ok = [], bool(limits)
    for name, lim in limits.items():
        v, lim = numbers.get(name, math.nan), float(lim)
        ok = ok and math.isfinite(v) and v <= lim
        rows.append([name, v, lim])
    for name in numbers:
        if name not in limits:
            ok = False
            rows.append([name, numbers[name], None])
    return ok, rows
