"""The domain-decomposed driver: solver windows on P ranks.

The counterpart of ``shud_tpu/parallel/runtime.py``.  Every rank runs the
same driver over its own blocks (``sharded.ShardRHS``): the solver's state
is the rank's cell and reach blocks plus the replicated lakes, one BDF
state persists across windows, and ``solve_to``'s dot products and norms
are global (``solve_to(..., group=)``), so every rank takes the same steps
and Newton iterations.  The window's forcing is computed for the whole
mesh on every rank (the buckets and the cryosphere are dense and
replicated, as in the JAX package), and each rank takes its blocks of it.
At the end of an output interval the ranks gather their blocks, and rank
0 alone writes the files (``run_project_sharded``).
"""

from __future__ import annotations

import os
import time
import types

import numpy as np
import torch

from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core import solar as solar_mod
from shud_tpu_torch.core.cryo import cryo_init, cryo_step
from shud_tpu_torch.core.device import to_torch
from shud_tpu_torch.core.landsurface import (
    BucketState, CalibScalars, cell_forcing, et_bucket_step)
from shud_tpu_torch.core.mesh import MeshData
from shud_tpu_torch.driver.forcing import build_forcing
from shud_tpu_torch.driver.init import initial_buckets, initial_state
from shud_tpu_torch.io.project import ProjectInput
from shud_tpu_torch.parallel import comm
from shud_tpu_torch.parallel.comm import Group, init_distributed
from shud_tpu_torch.parallel.partition import (
    build_sharded_mesh, shard_state, unshard_state)
from shud_tpu_torch.parallel.sharded import ShardRHS, state_blocks
from shud_tpu_torch.solver.bdf import (
    BDFState, SolverConfig, bdf_init, solve_to)

__all__ = ["ShardedSimulation", "run_project_sharded", "init_distributed",
           "run_ranks"]

# interval accumulator layout (window-end samples summed over windows;
# interval means = /n, the fused driver's Print_Ctrl semantics)
_ACC_BLK = ("q_rech", "q_sub_tot", "q_surf_tot", "q_e2r_sub", "q_e2r_surf",
            "q_infil", "q_exfil", "e_ic", "trans", "evapo", "eta",
            "y_surf", "y_unsat", "y_gw")
_ACC_EDGE = ("q_esub", "q_esurf")
_ACC_RIV = ("q_riv_up", "q_riv_down", "q_riv_sub", "q_riv_surf", "y_riv")
_ACC_LAKE = ("y_lake", "lake_area", "q_lake_evap", "q_lake_prcp",
             "q_lake_rivin", "q_lake_surf", "q_lake_sub",
             # always-zero in the reference (dead accumulation,
             # MD_update.cpp:184); emitted for file-set parity
             "q_lake_rivout")
_ACC_DENSE = ("prcp", "net_prcp", "etp", "rn_h", "rn_t", "rn_factor",
              "y_ic", "y_snow")
_QUAD = ("et", "qout", "qedge", "qbc", "qss", "nc", "lake_p", "lake_e")


def _accum_interval(acc, diag, extras, y, buckets, split):
    """One window's contribution to the interval accumulators."""
    sf, us, gw, riv, lake = split(y)
    b = acc["blk"]
    blk = {k: b[k] + diag[k]
           for k in ("q_rech", "q_sub_tot", "q_surf_tot", "q_e2r_sub",
                     "q_e2r_surf", "q_infil", "q_exfil", "e_ic")}
    blk["trans"] = b["trans"] + diag["tu"] + diag["tg"]
    blk["evapo"] = b["evapo"] + diag["es"] + diag["eu"] + diag["eg"]
    blk["eta"] = (b["eta"] + diag["e_ic"] + diag["es"] + diag["eu"]
                  + diag["eg"] + diag["tu"] + diag["tg"])
    blk["y_surf"] = b["y_surf"] + sf
    blk["y_unsat"] = b["y_unsat"] + us
    blk["y_gw"] = b["y_gw"] + gw
    edge = {k: acc["edge"][k] + diag[k] for k in _ACC_EDGE}
    rv = {k: acc["riv"][k] + diag[k] for k in _ACC_RIV if k != "y_riv"}
    rv["y_riv"] = acc["riv"]["y_riv"] + riv
    lk = {k: acc["lake"][k] + diag[k] for k in _ACC_LAKE
          if k not in ("y_lake", "q_lake_rivout")}
    lk["y_lake"] = acc["lake"]["y_lake"] + lake
    lk["q_lake_rivout"] = acc["lake"]["q_lake_rivout"]  # stays zero
    d = acc["dense"]
    dense = {k: d[k] + extras[k] for k in _ACC_DENSE
             if k not in ("y_ic", "y_snow")}
    dense["y_ic"] = d["y_ic"] + buckets.ic_stg
    dense["y_snow"] = d["y_snow"] + buckets.snow
    return {"blk": blk, "edge": edge, "riv": rv, "lake": lk, "dense": dense,
            "stages": acc["stages"] + [riv], "qdowns": acc["qdowns"]
            + [diag["q_riv_down"]], "n": acc["n"] + 1}


class ShardedSimulation:
    """Multi-window domain-decomposed simulation: this rank's share (the
    counterpart of the JAX package's ``ShardedSimulation``, whose device
    mesh is here the ranks of *group*).

    Cell and reach blocks live on the rank's device, lakes are replicated,
    one BDF state persists across windows, and each window re-binds only
    the forcing.  ``edge_kernel``: ``"auto"`` runs the CUDA edge trio per
    shard exactly when the run is float32 on CUDA, ``False`` their plain
    versions.  The partition keeps the mesh's own cell order within each
    shard (the banded numbering the JAX package needs for its TPU kernel
    is not needed here)."""

    def __init__(self, inp: ProjectInput, md: MeshData, group: Group,
                 float_dtype: torch.dtype = torch.float64,
                 edge_kernel: "bool | str" = "auto",
                 wb_exact: "bool | None" = None):
        self.inp, self.md, self.group = inp, md, group
        self.fd = fd = float_dtype
        self.device = device = group.device
        self.sm = build_sharded_mesh(md, group.size)
        cs = inp.control
        self.close_boundary = bool(cs.close_boundary)
        self.cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                                h_init=cs.init_step, h_max=cs.max_step)
        self.rhs = ShardRHS(self.sm, group, fd, self.close_boundary,
                            edge_kernel)
        self.fr = build_forcing(inp, md)
        self.fr.cal = CalibScalars(*[v.to(device=device, dtype=fd)
                                     for v in self.fr.cal])
        # the whole mesh's per-cell fields, for the window's forcing
        self.dm = to_torch(md, fd, device, edge_kernel=False)
        ic0, snow0 = initial_buckets(inp, md)
        self.buckets = BucketState(ic_stg=self._t(ic0), snow=self._t(snow0))
        gc = inp.calib
        self.cryo = None
        self.cryo_bounds = (gc.fzn_surfmax, gc.fzn_surfmin,
                            gc.fzn_submax, gc.fzn_submin)
        if cs.cryosphere:
            self.cryo = cryo_init(md.num_ele, int(gc.fzn_surfday),
                                  int(gc.fzn_subday), fd, device)
        # exact flux quadrature along the trajectory: opt-in like the
        # reference (SHUD_WB_DIAG=1, shud.cpp:70-75)
        if wb_exact is None:
            wb_exact = os.environ.get("SHUD_WB_DIAG", "0") not in ("0", "")
        quad0 = ({k: torch.zeros((), dtype=fd, device=device) for k in _QUAD}
                 if wb_exact else None)
        y0 = self.rhs.local_state(shard_state(self.sm,
                                              initial_state(inp, md)))
        self.state = bdf_init(cs.start_time, y0, self.cfg, quad0=quad0)
        self.t = cs.start_time

        # each rank's blocks of the dense forcing: one gather per field
        sm_, q = self.sm, group.rank
        idx = np.zeros((sm_.p, sm_.np_cells), np.int64)
        idx[sm_.old_to_shard, sm_.old_to_slot] = np.arange(md.num_ele)
        rividx = np.zeros((sm_.p, sm_.nr_riv), np.int64)
        if md.num_riv:
            rividx[sm_.riv_owner, sm_.riv_slot_of] = np.arange(md.num_riv)
        self._blk_idx = torch.as_tensor(idx[q], device=device)
        self._riv_idx = torch.as_tensor(rividx[q], device=device)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.fd)

    # ------------------------------------------------------------------

    def _forcing(self, tout: float):
        """The window's forcing: dense on every rank (advancing the buckets
        and the cryosphere), then this rank's blocks of it."""
        fr, t, dm, md = self.fr, self.t, self.dm, self.md
        win = tout - t
        if fr.terrain_radiation:
            sx, sy, sz, wdt, den = (self._t(a) for a in fr.tsr_sample(t))
            factor = solar_mod.tsr_factor(dm.nx, dm.ny, dm.nz, sx, sy, sz,
                                          wdt, den, fr.rad_factor_cap,
                                          fr.rad_cosz_min)
        else:
            factor = torch.ones_like(dm.nx)
        cf = cell_forcing(
            dm, self._t(fr.station_values(t)), self._t(fr.station_z),
            self._t(fr.lai_at(t)), self._t(fr.mf_at(t)), factor, fr.cal,
            swnet_mode=fr.swnet_mode, terrain_radiation=fr.terrain_radiation,
            et_mode=int(fr.et_mode))
        out = et_bucket_step(dm, cf, self.buckets, win, fr.cal.c_ismax)
        self.buckets = out.state
        if self.cryo is not None:
            self.cryo, fu_surf, fu_sub = cryo_step(self.cryo, cf.temp,
                                                   float(t),
                                                   *self.cryo_bounds)
        else:
            fu_surf = fu_sub = torch.ones_like(dm.nx)
        zeros_e = torch.zeros_like(dm.nx)
        zeros_r = dm.nx.new_zeros(md.num_riv)
        bc = ({k: self._t(v) for k, v in fr.bc_values(md, t).items()}
              if fr.bc else {"ele_ybc": zeros_e, "ele_qbc": zeros_e,
                             "ele_qss": zeros_e, "riv_ybc": zeros_r,
                             "riv_qbc": zeros_r})
        valid, rvalid = self.rhs.valid, self.rhs.rvalid

        def blocks(v):
            return torch.where(valid, v[self._blk_idx], 0.0)

        def rblocks(v):
            if md.num_riv == 0:
                return torch.zeros_like(rvalid, dtype=self.fd)
            return torch.where(rvalid, v[self._riv_idx], 0.0)

        cell = {"net_prcp": out.net_prcp, "prcp": cf.prcp,
                "pot_evap": cf.pot_evap, "pot_tran": cf.pot_tran,
                "e_ic": out.e_ic, "lai": cf.lai, "fu_surf": fu_surf,
                "fu_sub": fu_sub, "ele_ybc": bc["ele_ybc"],
                "ele_qbc": bc["ele_qbc"], "ele_qss": bc["ele_qss"]}
        slc = self.rhs.forcing_slice(
            {k: blocks(v) for k, v in cell.items()},
            {k: rblocks(bc[k]) for k in ("riv_ybc", "riv_qbc")})
        extras = {"prcp": cf.prcp, "net_prcp": out.net_prcp, "etp": cf.etp,
                  "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor}
        return slc, extras

    def _quad(self, slc, y):
        """Basin water-balance quadrature rates [m3/min] of the sharded
        layout (the JAX package's ``_make_quad_fn``; the fused driver's
        ``quad_rates``): the blocks' masked sums completed over the ranks
        in one ``psum``, the replicated lake terms counted once."""
        rhs, m, riv = self.rhs, self.rhs.m, self.rhs.riv
        nl = rhs.nl
        _dy, dg = rhs.rhs_full(0.0, y, slc)
        valid, rvalid = rhs.valid, rhs.rvalid
        area = torch.where(valid, m.area, 0.0)
        e_ic_q = slc.e_ic
        if nl > 0:
            is_lake = m.i_lake > 0
            e_ic_q = torch.where(is_lake, 0.0, e_ic_q)
        eta = (e_ic_q + dg["es"] + dg["eu"] + dg["eg"] + dg["tu"] + dg["tg"])
        et = torch.sum(torch.where(valid, eta, 0.0) * area)
        is_outlet = (~riv["has_down"]) & (riv["riv_to_lake"] < 0) & rvalid
        qout = torch.sum(torch.where(is_outlet, dg["q_riv_down"], 0.0))
        if self.close_boundary:
            qedge = et.new_zeros(())
        else:
            is_bnd = ~rhs.has_nb & valid[:, None]
            if nl > 0:
                is_bnd = is_bnd & ~rhs.has_lake
            qedge = torch.sum(torch.where(is_bnd,
                                          dg["q_esurf"] + dg["q_esub"], 0.0))
        qbc = torch.sum(torch.where((m.i_bc < 0) & valid, slc.ele_qbc, 0.0)) \
            + torch.sum(torch.where(rvalid, slc.riv_qbc, 0.0))
        qss = torch.sum(torch.where((m.i_ss != 0) & valid, slc.ele_qss, 0.0))
        sf, us, gw, rv, lake = rhs.split(y)
        rs = torch.where(riv["riv_bc"] > 0, slc.riv_ybc, rv)
        bw, bs = riv["riv_bottom_width"], riv["riv_bank_slope"]
        csa = ph.maximum(rs * (bw + rs * bs), 0.0)
        topw = ph.maximum(rs * bs * 2.0 + bw, 0.0)
        rlen = torch.where(rvalid, riv["riv_length"], 1.0)
        d_nat = (-dg["q_riv_up"] - dg["q_riv_surf"] - dg["q_riv_sub"]
                 - dg["q_riv_down"] + slc.riv_qbc) / rlen
        d_cl = torch.maximum(d_nat, -csa)
        drv = ph.fun_da_to_dy(d_cl, topw, bs)
        drv = torch.where(riv["riv_bc"] > 0, 0.0, drv)
        nc = torch.sum(torch.where(rvalid, (topw * drv - d_nat) * rlen, 0.0))
        if nl > 0:
            # fluxes run against lake cells and then their DY is zeroed
            # (MD_f.cpp:146-150): discarded exchange is non-conservation
            nc = nc + torch.sum(torch.where(
                is_lake & valid, dg["q_surf_tot"] + dg["q_sub_tot"], 0.0))
        tot = self.group.psum(torch.stack([et, qout, qedge, qbc, qss, nc]))
        out = dict(zip(_QUAD[:6], tot))
        if nl > 0:
            out["lake_p"] = torch.sum(dg["q_lake_prcp"] * dg["lake_area"])
            out["lake_e"] = torch.sum(dg["q_lake_evap"] * dg["lake_area"])
        else:
            out["lake_p"] = out["lake_e"] = et.new_zeros(())
        return out

    # ------------------------------------------------------------------

    def advance_window(self, tout: float, acc=None):
        """Advance the sharded solver to *tout*.  With an interval
        accumulator (``acc_zero``), one diagnostics RHS at the accepted
        state adds the window's output channels and its reach stages and
        outflows to it; returns the new accumulator."""
        rhs = self.rhs
        slc, extras = self._forcing(tout)

        def f(tt, yy, s):
            return rhs.rhs(tt, yy, s)

        def lin(tt, yy, s):
            return rhs.linearize(tt, yy, s)

        qfn = None
        if self.state.quad is not None:
            def qfn(tt, yy, s):
                return self._quad(s, yy)

        self.state = solve_to(f, self.state, tout, slc, self.cfg, qfn,
                              linearize=lin, group=rhs.state_group)
        self.t = tout
        if acc is None:
            return None
        _, diag = rhs.rhs_full(tout, self.state.y, slc)
        return _accum_interval(acc, diag, extras, self.state.y, self.buckets,
                               rhs.split)

    def acc_zero(self):
        """A fresh interval accumulator (zeros in the block layout)."""
        rhs, fd, dev = self.rhs, self.fd, self.device

        def z(*shape):
            return torch.zeros(shape, dtype=fd, device=dev)

        return {"blk": {k: z(rhs.np_cells) for k in _ACC_BLK},
                "edge": {k: z(rhs.np_cells, 3) for k in _ACC_EDGE},
                "riv": {k: z(rhs.nr_riv) for k in _ACC_RIV},
                "lake": {k: z(rhs.nl) for k in _ACC_LAKE},
                "dense": {k: z(self.md.num_ele) for k in _ACC_DENSE},
                "stages": [], "qdowns": [], "n": 0}

    def interval_means(self, acc):
        """Collective: the interval's means on every rank as host arrays in
        the reference layout, ``(mean_e, mean_r, mean_l, stages [W, Nr],
        qdowns [W, Nr])``: one ``all_gather`` of every rank's blocks."""
        sm, n = self.sm, acc["n"]
        npc, nrr = sm.np_cells, sm.nr_riv
        local = torch.cat(
            [acc["blk"][k] for k in _ACC_BLK]
            + [acc["edge"][k].reshape(-1) for k in _ACC_EDGE]
            + [acc["riv"][k] for k in _ACC_RIV]
            + acc["stages"] + acc["qdowns"])
        parts = np.stack([p.cpu().double().numpy()
                          for p in self.group.all_gather(local)])
        cuts = np.cumsum([npc] * len(_ACC_BLK) + [3 * npc] * len(_ACC_EDGE)
                         + [nrr] * (len(_ACC_RIV) + 2 * n))[:-1]
        cols = np.split(parts, cuts, axis=1)

        def uc(b):
            return b[sm.old_to_shard, sm.old_to_slot]

        def ur(b):
            return (b[sm.riv_owner, sm.riv_slot_of] if sm.num_riv
                    else b[:0, 0])

        mean_e = {k: uc(cols[i]) / n for i, k in enumerate(_ACC_BLK)}
        mean_e.update({k: v.cpu().double().numpy() / n
                       for k, v in acc["dense"].items()})
        off = len(_ACC_BLK)
        for i, k in enumerate(_ACC_EDGE):
            e = uc(cols[off + i].reshape(sm.p, npc, 3))
            for j in range(3):
                mean_e[f"{k}{j}"] = e[:, j] / n
        off += len(_ACC_EDGE)
        mean_r = {k: ur(cols[off + i]) / n for i, k in enumerate(_ACC_RIV)}
        off += len(_ACC_RIV)
        stages = np.stack([ur(c) for c in cols[off:off + n]])
        qdowns = np.stack([ur(c) for c in cols[off + n:off + 2 * n]])
        mean_l = {k: v.cpu().double().numpy() / n
                  for k, v in acc["lake"].items()}
        return mean_e, mean_r, mean_l, stages, qdowns

    def y_full(self) -> np.ndarray:
        """Collective: the global state vector (reference layout) on every
        rank."""
        flats = [p.cpu().double().numpy()
                 for p in self.group.all_gather(self.state.y)]
        return unshard_state(self.sm, state_blocks(self.sm, flats))

    @property
    def nfe(self) -> int:
        return int(self.state.nfe)

    @property
    def bdf(self) -> BDFState:
        """This rank's solver state."""
        return self.state

    def gathered(self):
        """Collective: the whole simulation's state as ``io/checkpoint.py``
        reads and writes it (the solver's state tensors as the ranks'
        [P, n] rows, the buckets and the cryosphere dense)."""
        st = self.state
        rows = {k: torch.stack(self.group.all_gather(getattr(st, k)))
                for k in ("y", "y_prev", "y_prev2")}
        return types.SimpleNamespace(bdf=st._replace(**rows),
                                     buckets=self.buckets, cryo=self.cryo,
                                     t=self.t, md=self.md)

    def restore(self, view) -> None:
        """Take the state of a ``gathered`` view (after ``load_checkpoint``
        filled it): this rank's rows."""
        q = self.group.rank
        st = view.bdf
        self.state = st._replace(**{k: getattr(st, k)[q].contiguous()
                                    for k in ("y", "y_prev", "y_prev2")})
        self.buckets, self.cryo, self.t = view.buckets, view.cryo, view.t

    def run(self, t_end: float, observer=None):
        step = self.inp.control.solver_step
        while self.t < t_end - 1e-9:
            self.advance_window(min(self.t + step, t_end))
            if observer is not None:
                observer(self)


def run_project_sharded(project: str, group: Group, base: str = ".",
                        end_day: float | None = None, verbose: bool = True,
                        outpath: str | None = None,
                        float_dtype: torch.dtype = torch.float64,
                        edge_kernel: "bool | str" = "auto",
                        resume: str | None = None, inp=None, calib=None,
                        **overrides):
    """The multi-GPU production driver, as one rank of *group*: ``./shud
    <prj>`` over P ranks with the whole output stack of
    ``run_project_fast`` (every Print_Ctrl channel, flood alert, basin
    water balance, restart and binary checkpoint, time log, ``--resume``).

    Every rank runs this function; the ranks gather their blocks once an
    output interval (one ``all_gather``), and rank 0 alone writes the
    files.  Returns this rank's ``ShardedSimulation``."""
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.diag.waterbalance import WaterBalance
    from shud_tpu_torch.driver.run_fast import IntervalWriter
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from shud_tpu_torch.io.output import (
        FloodAlert, PrintCtrl, TimeLog, write_restart)
    from shud_tpu_torch.io.project import load_project, write_calib
    from shud_tpu_torch.io.validate import check_input
    from shud_tpu_torch.utils.errors import NanError
    from shud_tpu_torch.utils.timectx import TimeContext

    if inp is None:
        inp = load_project(project, base=base)
    if calib is not None:
        inp.calib = calib
    if end_day is not None:
        inp.control.day_end = end_day
    for k, v in overrides.items():
        setattr(inp.control, k, v)
    if outpath:
        inp.paths.outpath = outpath
    check_input(inp)
    md = build_mesh(inp)
    p = group.size
    is_main = group.is_main
    verbose = verbose and is_main
    sim = ShardedSimulation(inp, md, group, float_dtype=float_dtype,
                            edge_kernel=edge_kernel)
    if resume:
        view = sim.gathered()
        load_checkpoint(resume, view)
        sim.restore(view)
        if verbose:
            print(f"resumed from {resume} at t={sim.t/1440.0:.2f} days")
    cs = inp.control
    paths = inp.paths
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    t_end = cs.end_time if end_day is None else end_day * 1440.0
    if is_main:
        os.makedirs(paths.outpath, exist_ok=True)

    writer = IntervalWriter(sim, io_enabled=is_main)
    interval = writer.interval
    flood = tlog = wb = wb_ele = None
    if is_main:
        flood = FloodAlert(
            os.path.join(paths.outpath, f"{paths.project}.flood.csv"),
            md.riv_depth)
        tlog = TimeLog(os.path.join(paths.outpath,
                                    f"{paths.project}.time.csv"))
        wb = WaterBalance(md, os.path.join(paths.outpath,
                                           f"{paths.project}.wb.basin.csv"))
        # per-element residual channel, opt-in like the reference's
        # SHUD_WB_DIAG=1 (WaterBalanceDiag.cpp:258-370)
        if os.environ.get("SHUD_WB_DIAG", "0") not in ("0", ""):
            wb_ele = PrintCtrl(
                os.path.join(paths.outpath, f"{paths.project}.elevwbres"),
                inp.forc.start_yyyymmdd, int(interval), False, ne)
        write_calib(inp.calib, os.path.join(
            paths.outpath, f"{paths.project}.cfg.calib.bak"))
        paths.save_project_file()
        if os.environ.get("SHUD_DEBUG_TABLES", "0") not in ("0", ""):
            from shud_tpu_torch.io.debugtables import write_debug_tables

            write_debug_tables(md, inp, paths.outpath)

    def host(t):
        return t.detach().cpu().numpy()

    def restart(name, t, y):
        write_restart(
            os.path.join(paths.outpath, f"{paths.project}.{name}"), t,
            host(sim.buckets.ic_stg), host(sim.buckets.snow),
            y[:ne], y[ne:2 * ne], y[2 * ne:3 * ne], y[3 * ne:3 * ne + nr],
            y[3 * ne + nr:] if nl else None)

    def quad():
        q = sim.state.quad
        return None if q is None else {k: float(v) for k, v in q.items()}

    y_host = sim.y_full()
    if is_main:
        restart("cfg.ic.bak", 0.0, y_host)
    tc = TimeContext(inp.forc.start_yyyymmdd)
    wall0 = time.time()
    cpu0 = time.process_time()
    last_nfe = sim.nfe
    win = cs.solver_step
    while sim.t < t_end - 1e-9:
        this_int = min(interval, t_end - sim.t)
        y0 = y_host
        bk0 = (host(sim.buckets.ic_stg), host(sim.buckets.snow))
        quad0 = quad()
        t0 = sim.t
        acc = sim.acc_zero()
        while sim.t < t0 + this_int - 1e-9:
            acc = sim.advance_window(min(sim.t + win, t0 + this_int), acc)
        mean_e, mean_r, mean_l, stages, qdowns = sim.interval_means(acc)
        y_host = sim.y_full()
        if is_main:
            writer.write(sim.t, mean_e, mean_r, mean_l)
            for w in range(acc["n"]):
                flood.check(t0 + (w + 1) * win, stages[w], qdowns[w])
            quad_kwargs = {}
            if quad0 is not None:
                q1 = quad()
                quad_kwargs = {f"{k}_m3": q1[k] - quad0[k] for k in _QUAD}
            wb.interval(t0, sim.t, y0, y_host, mean_e, mean_r,
                        buckets0=bk0,
                        buckets1=(host(sim.buckets.ic_stg),
                                  host(sim.buckets.snow)),
                        mean_lake=mean_l, **quad_kwargs)
            if wb_ele is not None:
                wb_ele.push(sim.t, wb.element_residuals(t0, sim.t, y0,
                                                        y_host, mean_e))
        nfe = sim.nfe
        perc = 100.0 * (sim.t - cs.start_time) / (t_end - cs.start_time)
        if verbose:
            print(f"{tc.iso(sim.t)}\t{sim.t/1440.0:8.2f} day\t{perc:6.2f}%"
                  f"\t{time.time()-wall0:8.2f} s\t{nfe - last_nfe}"
                  f"\t({p} shards)", flush=True)
        if is_main:
            tlog.write(sim.t, perc, time.process_time() - cpu0,
                       time.time() - wall0, nfe - last_nfe)
        last_nfe = nfe
        if int(sim.t) % cs.update_ic_step == 0 or sim.t >= t_end - 1e-9:
            if not np.isfinite(y_host).all():
                bad = int(np.flatnonzero(~np.isfinite(y_host))[0])
                raise NanError(
                    f"non-finite state at t={sim.t:.1f} min (index {bad})")
            view = sim.gathered()  # collective; rank 0 writes
            if is_main:
                restart("cfg.ic.update", sim.t, y_host)
                save_checkpoint(os.path.join(
                    paths.outpath, f"{paths.project}.ckpt.npz"), view)
    writer.close()
    if is_main:
        flood.close()
        tlog.close()
        wb.close()
        if wb_ele is not None:
            wb_ele.close()
    if verbose:
        b = sim.state
        print(f"\nFinal stats: nsteps={int(b.nsteps)} nfe={int(b.nfe)} "
              f"netf={int(b.nfails)} ncfn={int(b.nnifails)}; wall "
              f"{time.time()-wall0:.1f} s")
    return sim


def _driver_rank(group: Group, project: str, kwargs: dict) -> dict:
    """A rank of ``run_ranks``: the driver, then what the caller reads."""
    sim = run_project_sharded(project, group=group, **kwargs)
    b = sim.state
    y = sim.y_full()  # collective
    return {"nsteps": int(b.nsteps), "nfe": int(b.nfe),
            "y": y if group.is_main else None}


def run_ranks(project: str, p: int, backend: str, devices, **kwargs):
    """``run_project_sharded`` on *p* new ranks of this host (rank r on
    ``devices[r]``, ``comm.spawn``): the command line's ``--shards``.
    Returns rank 0's final counters and global state."""
    return comm.spawn(_driver_rank, p, backend, devices,
                      args=(project, kwargs))[0]
