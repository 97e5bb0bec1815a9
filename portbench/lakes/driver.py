"""The reference run of a basin with lakes: ``reference/driver.py``'s
fused driver with the lakes let through.  The lakes' stages are part of
the solver's state, so the solve, the comparison's state and the
window's forcing need nothing else (the per-lake precipitation and
evaporation are sums over the cells' forcing inside the right-hand
side)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.device import to_torch
from portbench.reference.driver import (  # noqa: F401
    GraphedRHS, _round, _rounded, window_forcing)
from portbench.reference.forcing import build_forcing
from portbench.reference.init import initial_buckets, initial_state
from portbench.reference.landsurface import BucketState, CalibScalars
from portbench.reference.mesh import build_mesh
from portbench.reference.rhs import rhs, rhs_full
from portbench.reference.solver import BDF


def simulate(inp, interval_min: float, device, round_inputs=None) -> list:
    """Run *inp* from its start to its end time; for each output interval
    of *interval_min* minutes a dict of host arrays: ``y`` (the state at
    the interval's end, the lakes' stages last), ``sy`` (the cells'
    specific yield) and ``q_riv_down`` (the reaches' discharge, the mean
    of the windows'; a lake-bound reach's is its flow into the lake).

    *round_inputs*: a dtype that every floating input table (the
    bathymetry among them) and the initial state are rounded through
    first (the control); the arithmetic stays float64."""
    cs = inp.control
    if cs.cryosphere or inp.bc:
        raise ValueError("the reference runs no cryosphere or boundary "
                         "conditions")
    if int(inp.att[:, 8].max()) > 0 and inp.lake_bathy is None:
        raise ValueError("a mesh with lakes needs their bathymetry")
    f64 = torch.float64
    md = build_mesh(inp)
    fr = build_forcing(inp, md)
    if round_inputs is not None:
        md, fr = _rounded(md, round_inputs), _rounded(fr, round_inputs)
    dm = to_torch(md, f64, device)
    cal = CalibScalars(*[v.to(device=device, dtype=f64) for v in fr.cal])
    y0 = initial_state(inp, md)
    if round_inputs is not None:
        y0 = _round(y0, round_inputs)
    ic0, snow0 = initial_buckets(inp, md)
    bk = BucketState(ic_stg=torch.as_tensor(ic0, device=device),
                     snow=torch.as_tensor(snow0, device=device))
    solver = BDF(t=cs.start_time, y=torch.as_tensor(y0, device=device),
                 rtol=cs.reltol, atol=cs.abstol, h=cs.init_step,
                 h_max=cs.max_step)
    close = bool(cs.close_boundary)
    win = float(cs.solver_step)
    per_interval = int(round(interval_min / win))
    n_windows = int(round((cs.end_time - cs.start_time) / win))
    out, q_sum, f = [], None, None
    for w in range(n_windows):
        t = cs.start_time + w * win

        def row(axis):
            return max(int(np.searchsorted(axis, t + 1e-9, side="right"))
                       - 1, 0)

        rows = (row(fr.t_axis), row(fr.lai_t), row(fr.mf_t))
        fs, bk = window_forcing(dm, bk, fr, cal, rows, win, f64, device)
        if torch.device(device).type == "cuda":
            if f is None:
                f = GraphedRHS(dm, fs, solver.y, close)
            f.set_forcing(fs)
        else:
            def f(tt, yy, fs=fs):
                return rhs(dm, fs, tt, yy, close)
        solver.advance(f, t + win)
        _, diag = rhs_full(dm, fs, t + win, solver.y, close)
        q = diag["q_riv_down"]
        q_sum = q.clone() if q_sum is None else q_sum + q
        if (w + 1) % per_interval == 0 or w + 1 == n_windows:
            n = (w % per_interval) + 1
            out.append({"t": t + win, "y": solver.y.cpu().numpy(),
                        "sy": md.sy, "q_riv_down": (q_sum / n).cpu().numpy()})
            q_sum = None
    return out
