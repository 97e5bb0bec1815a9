"""The comparison that decides ``correct``.

The program's results of one replay (the state at the end of each output
interval and the interval's means) are held against the reference's run
of the same generated input.  Each number has a limit of its own in the
cell's file under ``limits/`` (set from readings of sound runs and of the
control, ``calibrate.py``); a cell compares the numbers its file names:

- ``water_wrms``: the distance between the program's water at an
  interval's end and the reference's, in the weighted root-mean-square
  norm of the configuration's tolerances (each entry over ``reltol * |w|
  + abstol``), the norm of the solver's error control: per cell the
  water column (surface depth plus the unsaturated and saturated storage
  times the specific yield), per reach its stage; the largest over the
  intervals.  It sees water lost or made, not water moved between one
  cell's stores;
- ``water_maxgap``: the widest of those water gaps, entry by entry (each
  over ``reltol * |w| + abstol``): it sees one cell's water altered,
  which the mean over the cells dilutes;
- ``state_wrms``: the same norm over the state entry by entry (each
  cell's surface, unsaturated and saturated store, each reach's stage):
  it sees water moved between the stores, which is infiltration and
  recharge, as well;
- ``flow_gap``: the largest distance, over the intervals and the reaches,
  between the program's interval-mean river discharge and the
  reference's, as a share of the interval's largest reference discharge.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("water_wrms", "water_maxgap", "state_wrms", "flow_gap")


def interval_gaps(got: dict, ref: dict, rtol: float, atol: float) -> dict:
    """The numbers of one interval: *got* the program's, *ref* the
    reference's (host arrays)."""
    y, y_ref = np.asarray(got["y"], np.float64), np.asarray(ref["y"])
    q = np.asarray(got["q_riv_down"], np.float64)
    q_ref = np.asarray(ref["q_riv_down"])
    scale = max(float(np.max(np.abs(q_ref))), 1e-12)
    sy = np.asarray(ref["sy"])
    ne = len(sy)

    def water(v):
        return np.concatenate([v[:ne] + sy * (v[ne:2 * ne] + v[2 * ne:3 * ne]),
                               v[3 * ne:]])

    def weighted(a, b):
        return (a - b) / (rtol * np.abs(b) + atol)

    def wrms(a, b):
        return float(np.sqrt(np.mean(weighted(a, b) ** 2)))

    w, w_ref = water(y), water(y_ref)
    gaps = {"water_wrms": wrms(w, w_ref),
            "water_maxgap": float(np.max(np.abs(weighted(w, w_ref)))),
            "state_wrms": wrms(y, y_ref),
            "flow_gap": float(np.max(np.abs(q - q_ref))) / scale}
    if not (np.isfinite(y).all() and np.isfinite(q).all()):
        gaps = dict.fromkeys(NUMBERS, float("inf"))
    return gaps


def gaps(got: list, ref: list, control: dict) -> tuple:
    """(numbers over all intervals, the intervals over a limit's count
    as a function of the limits): each number the largest of the
    intervals'.  *control*: the configuration's solver settings."""
    if len(got) != len(ref):
        raise ValueError(f"{len(got)} intervals against the reference's "
                         f"{len(ref)}")
    per = [interval_gaps(g, r, control["reltol"], control["abstol"])
           for g, r in zip(got, ref)]
    return {k: max(p[k] for p in per) for k in NUMBERS}, per


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the limits name within its limit (a missing number
    fails)."""
    return all(numbers.get(k, float("inf")) <= v for k, v in limits.items())


def failed_intervals(per: list, limits: dict) -> int:
    return sum(not judge(p, limits) for p in per)


def report(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit, for the result line."""
    return {k: {"value": numbers.get(k), "limit": v}
            for k, v in limits.items()}
