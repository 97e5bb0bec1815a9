"""The reference run: SHUD's fused driver in plain PyTorch, float64.

For each 10-minute window (the project's solver step): the terrain
shortwave factor, the cell forcing and potential ET, the interception and
snow bucket, then the adaptive solve over the window (``solver.BDF``),
then one right-hand-side evaluation for the window's diagnostics, summed
into the output interval's means.  The same semantics as the program's
``FusedSimulation.advance_interval``, built from the same generated input
and nothing that the program made.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import solar
from portbench.reference.device import to_torch
from portbench.reference.forcing import build_forcing
from portbench.reference.init import initial_buckets, initial_state
from portbench.reference.landsurface import (
    BucketState, CalibScalars, cell_forcing, et_bucket_step)
from portbench.reference.mesh import build_mesh
from portbench.reference.rhs import rhs, rhs_full
from portbench.reference.solver import BDF
from portbench.reference.state import ForcingSlice

def window_forcing(dm, buckets: BucketState, fr, cal: CalibScalars, rows,
                   dt: float, dtype, device):
    """One window's forcing slice and buckets (the frozen fractions 1, no
    boundary conditions)."""
    ki, li, mi = rows

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    if fr.terrain_radiation:
        factor = solar.tsr_factor(
            dm.nx, dm.ny, dm.nz, t(fr.tsr_sx[ki]), t(fr.tsr_sy[ki]),
            t(fr.tsr_sz[ki]), t(fr.tsr_wdt[ki]), t(fr.tsr_den[ki]),
            fr.rad_factor_cap, fr.rad_cosz_min)
    else:
        factor = torch.ones_like(dm.nx)
    cf = cell_forcing(dm, t(fr.fvals[ki]), t(fr.station_z),
                      t(fr.lai_vals[li]), t(fr.mf_vals[mi]), factor, cal,
                      swnet_mode=fr.swnet_mode,
                      terrain_radiation=fr.terrain_radiation,
                      et_mode=fr.et_mode)
    out = et_bucket_step(dm, cf, buckets, dt, cal.c_ismax)
    ones, zeros = torch.ones_like(dm.nx), torch.zeros_like(dm.nx)
    zr = dm.nx.new_zeros(dm.num_riv)
    fs = ForcingSlice(net_prcp=out.net_prcp, prcp=cf.prcp,
                      pot_evap=cf.pot_evap, pot_tran=cf.pot_tran,
                      e_ic=out.e_ic, lai=cf.lai, fu_surf=ones, fu_sub=ones,
                      ele_ybc=zeros, ele_qbc=zeros, ele_qss=zeros,
                      riv_ybc=zr, riv_qbc=zr)
    return fs, out.state


class GraphedRHS:
    """``rhs`` on the card, replayed from a CUDA graph: the window's
    forcing and the state are copied into the graph's static buffers
    (the same operations, launched at once)."""

    def __init__(self, dm, fs: ForcingSlice, y: torch.Tensor, close: bool):
        self.fs = ForcingSlice(*[x.clone() for x in fs])
        self.y = y.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                rhs(dm, self.fs, 0.0, self.y, close)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = rhs(dm, self.fs, 0.0, self.y, close)

    def set_forcing(self, fs: ForcingSlice) -> None:
        for dst, src in zip(self.fs, fs):
            dst.copy_(src)

    def __call__(self, t, y: torch.Tensor) -> torch.Tensor:
        self.y.copy_(y)
        self.graph.replay()
        return self.out.clone()


def simulate(inp, interval_min: float, device, round_inputs=None) -> list:
    """Run *inp* from its start to its end time; for each output interval
    of *interval_min* minutes a dict of host arrays: ``y`` (the state at
    the interval's end), ``sy`` (the cells' specific yield) and
    ``q_riv_down`` (the reaches' discharge, the mean of the windows').

    *round_inputs*: a dtype that every floating input table and the
    initial state are rounded through first (the control); the arithmetic
    stays float64."""
    cs = inp.control
    if cs.cryosphere or inp.bc or int(inp.att[:, 8].max()) > 0:
        raise ValueError("the reference runs no cryosphere, boundary "
                         "conditions or lakes")
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


def _round(a, dtype):
    return torch.as_tensor(a).to(dtype).double().numpy()


def _rounded(obj, dtype):
    """A copy of *obj* (a dataclass of tables) with every float64 array
    rounded through *dtype*."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray) and v.dtype == np.float64:
            v = _round(v, dtype)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)
