"""Fused driver: one output interval of solver windows per call.

The counterpart of ``shud_tpu/driver/fused.py``.  For each window: TSR
factor -> cell forcing/PET -> bucket update -> cryosphere
(``cryosphere=1``) and BC overlays (``window_head``) -> adaptive implicit
solve -> one diagnostics RHS (``window_diag``), accumulated into interval
means (``window_values``).  The solve linearizes the RHS once per Newton
iteration, as the JAX solver's ``jax.linearize``: on the eager path
through ``rhs.linearize`` (one coefficient call of the edge kernels, then
one apply call per Krylov vector), with the megakernel on
(``FusedSimulation.create(mega=)``, ``core/mega.py``) through
``mega.linearize_mega`` (one RHS kernel call, one tangent kernel call per
Krylov vector), where the diagnostics take one kernel call too.

JAX runs an interval's windows as one ``lax.scan`` inside one jit.  On the
card so does the port: ``IntervalGraph`` is the whole interval as one
launch of a CUDA graph (WHILE nodes for the window and step loops, IF
nodes for the Newton iterations; ``solver/graph.py``), the host taking
part only at the interval's boundaries (one host-to-device copy of the
interval's table rows, one read of the solver's scalars).
``run_interval`` is the same windows as a host loop: the reference the
graph is held against (``FusedSimulation.create(captured=False)``), and,
with a ``WindowGraph``, each window's solve one graph launch
(``captured="window"``).  The CPU runs the host loop.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch import trace
from shud_tpu_torch.core import mega as mega_mod
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core.cryo import (
    CryoState, cryo_init, cryo_step, over_count)
from shud_tpu_torch.core.device import TorchMesh, to_torch
from shud_tpu_torch.core.landsurface import BucketState, CalibScalars
from shud_tpu_torch.core.mesh import MeshData, build_mesh
from shud_tpu_torch.core.rhs import linearize, rhs, rhs_full
from shud_tpu_torch.core.state import ForcingSlice, split_y
from shud_tpu_torch.driver.forcing import ForcingRuntime, build_forcing
from shud_tpu_torch.driver.init import initial_buckets, initial_state
from shud_tpu_torch.driver.simulate import window_forcing
from shud_tpu_torch.io.project import ProjectInput, load_project
from shud_tpu_torch.solver import graph as solver_graph
from shud_tpu_torch.solver.bdf import (
    BDFState, SolverConfig, bdf_init, functions, np_dtype, solve_to,
    to_carry)
from shud_tpu_torch.solver.graph import (
    Program, SolverPieces, Stamp, While, WindowGraph, clone, copy_into)


class ChunkTables(NamedTuple):
    """Device-resident forcing tables for the whole run."""

    fvals: torch.Tensor  # [K, S, 5]
    station_z: torch.Tensor  # [S]
    lai_vals: torch.Tensor  # [Kl, C]
    mf_vals: torch.Tensor  # [Km, C]
    tsr_sx: torch.Tensor  # [K, n]
    tsr_sy: torch.Tensor
    tsr_sz: torch.Tensor
    tsr_wdt: torch.Tensor
    tsr_den: torch.Tensor  # [K]


# diagnostics accumulated over each output interval (sum over windows)
ACCUM_KEYS = [
    "y_ic", "y_snow", "y_surf", "y_unsat", "y_gw", "prcp", "net_prcp",
    "etp", "eta", "rn_h", "rn_t", "rn_factor", "q_rech", "q_sub_tot",
    "q_surf_tot", "q_e2r_sub", "q_e2r_surf", "q_infil", "q_exfil", "e_ic",
    "trans", "evapo",
]
# per-edge flux channels, accumulated only when dt_Qe_subx/surfx are on
# (Model_Control.cpp:460-465 + MD_initialize.cpp:283-296)
PER_EDGE_KEYS = ["q_esub0", "q_esub1", "q_esub2",
                 "q_esurf0", "q_esurf1", "q_esurf2"]
ACCUM_RIV_KEYS = ["q_riv_up", "q_riv_down", "q_riv_sub", "q_riv_surf",
                  "y_riv"]
ACCUM_LAKE_KEYS = ["y_lake", "lake_area", "q_lake_evap", "q_lake_prcp",
                   "q_lake_rivin", "q_lake_surf", "q_lake_sub",
                   # always-zero river outflow: the reference registers the
                   # channel (MD_initialize.cpp:339) but never accumulates
                   # QLakeRivOut (zeroed at MD_update.cpp:184)
                   "q_lake_rivout"]


def quad_rates(mesh, slc: ForcingSlice, tt, yy, close_boundary: bool):
    """Basin budget rates [m3/min] along the trajectory (exact water-balance
    quadrature): ET, outlet discharge, open-boundary edge drainage,
    flux-BC/SS injection, lake precip/evap, and the river non-conservation
    rate — the reference WaterBalanceDiag's basin columns
    (WaterBalanceDiag.cpp:440-530) plus lake terms.  Opt-in via
    SHUD_WB_DIAG=1 like the reference (shud.cpp:70-75)."""
    ne, nr = mesh.num_ele, mesh.num_riv
    nl_ = mesh.num_lake if mesh.num_lake > 0 else 0
    _sfq, _usq, _gwq, rivq, _lkq = split_y(yy, ne, nr, nl_)
    _dy, dg = rhs_full(mesh, slc, tt, yy, close_boundary=close_boundary)
    zero = yy.new_zeros(())

    # canopy evaporation: the BUCKET's rate (slc.e_ic) is the mass actually
    # removed from interception storage
    e_ic_q = slc.e_ic
    if nl_ > 0:
        is_lake = mesh.i_lake > 0
        e_ic_q = torch.where(is_lake, 0.0, e_ic_q)
    eta = (e_ic_q + dg["es"] + dg["eu"] + dg["eg"] + dg["tu"] + dg["tg"])

    is_outlet = (mesh.riv_down < 0) & (mesh.riv_to_lake < 0)
    qout = torch.sum(torch.where(is_outlet, dg["q_riv_down"], 0.0))

    # open-boundary kinematic edge drainage (boundary edges only)
    if close_boundary:
        qedge = zero
    else:
        is_bnd = mesh.nabr < 0
        if nl_ > 0:
            is_bnd = is_bnd & (mesh.lakenabr < 0)
        qedge = torch.sum(torch.where(is_bnd, dg["q_esurf"] + dg["q_esub"],
                                      0.0))

    # flux BCs and source/sink terms (head BCs excluded)
    qbc = torch.sum(torch.where(mesh.i_bc < 0, slc.ele_qbc, 0.0)) \
        + torch.sum(slc.riv_qbc)
    qss = torch.sum(torch.where(mesh.i_ss != 0, slc.ele_qss, 0.0))

    # river non-conservation: the dA >= -CSarea clamp and the quadratic
    # dA->dStage conversion (WaterBalanceDiag.cpp:470-530)
    rs = torch.where(mesh.riv_bc > 0, slc.riv_ybc, rivq)
    csa = ph.maximum(rs * (mesh.riv_bottom_width + rs * mesh.riv_bank_slope),
                     0.0)
    topw = ph.maximum(rs * mesh.riv_bank_slope * 2.0 + mesh.riv_bottom_width,
                      0.0)
    d_nat = (
        -dg["q_riv_up"] - dg["q_riv_surf"] - dg["q_riv_sub"]
        - dg["q_riv_down"] + slc.riv_qbc
    ) / mesh.riv_length
    d_cl = torch.maximum(d_nat, -csa)
    drv = ph.fun_da_to_dy(d_cl, topw, mesh.riv_bank_slope)
    drv = torch.where(mesh.riv_bc > 0, 0.0, drv)
    nc = torch.sum((topw * drv - d_nat) * mesh.riv_length)
    if nl_ > 0:
        # river-segment fluxes against lake cells whose DY is then zeroed
        # (MD_f.cpp:146-150) are non-conservation too
        nc = nc + torch.sum(torch.where(
            is_lake, dg["q_surf_tot"] + dg["q_sub_tot"], 0.0))
        lake_p = torch.sum(dg["q_lake_prcp"] * dg["lake_area"])
        lake_e = torch.sum(dg["q_lake_evap"] * dg["lake_area"])
    else:
        lake_p = lake_e = zero

    return {"et": torch.sum(eta * mesh.area), "qout": qout, "qedge": qedge,
            "qbc": qbc, "qss": qss, "nc": nc, "lake_p": lake_p,
            "lake_e": lake_e}


def window_functions(dm: TorchMesh, mega, close_boundary: bool,
                     mega_kernel: bool = True, quad: bool = False):
    """``solve_to``'s RHS, linearization hook and quadrature (None without
    *quad*) for the windows of one simulation, each given the window's
    forcing as its params: ``(MegaForcing, ForcingSlice or None)`` on the
    mega path, the ``ForcingSlice`` on the eager one.  They close over no
    window's values, so a captured window (``WindowGraph``) replays them
    on its static forcing."""
    if mega is not None:
        def f(tt, yy, p):
            return mega_mod.rhs_mega(mega, p[0], yy, close_boundary,
                                     mega_kernel)

        # one RHS call per Newton iteration, one tangent call per Krylov
        # vector (shud_tpu/solver/bdf.py:174)
        def lin(tt, yy, p):
            return mega_mod.linearize_mega(mega, p[0], yy, close_boundary,
                                           mega_kernel)

        def qfn(tt, yy, p):
            return quad_rates(dm, p[1], tt, yy, close_boundary)
    else:
        def f(tt, yy, p):
            return rhs(dm, p, tt, yy, close_boundary=close_boundary)

        # one primal (with the edge coefficients) per Newton iteration, one
        # edge_apply per Krylov vector
        def lin(tt, yy, p):
            return linearize(dm, p, tt, yy, close_boundary)

        def qfn(tt, yy, p):
            return quad_rates(dm, p, tt, yy, close_boundary)
    return f, lin, (qfn if quad else None)


# the BC/SS value tables: (ForcingSlice field, ForcingRuntime.bc key and
# column map)
BC_TABLES = (("ele_ybc", "ele_y"), ("ele_qbc", "ele_q"), ("ele_qss", "ele_ss"),
             ("riv_ybc", "riv_y"), ("riv_qbc", "riv_q"))
# rows of a window in run_interval's ``rows``: the forcing, LAI and melt
# factor tables' and each BC table's (BC_TABLES order)
N_ROWS = 3 + len(BC_TABLES)
# the interval graph's stamp sums (``IntervalGraph.phases``): the time
# before a launch's first window (init, and whatever ran since the last
# stamp), and each window's head, solve and tail
PHASES = ("start", "head", "solve", "tail")


def window_times(t0, w, win):
    """A window's start and end, ``t0 + w*win`` and ``t + win``: the
    product and the sum rounded apart in *t0*'s dtype (no fused
    multiply-add), bitwise the host's ``dt(t0) + dt(w) * dt(win)``.  On
    the host: numpy scalars of one dtype; on the device: 0-d tensors (*w*
    an integer count)."""
    if isinstance(t0, torch.Tensor):
        t = t0 + w.to(t0.dtype) * win
    else:
        dt = type(t0)
        t = t0 + dt(w) * win
    return t, t + win


def window_head(dm: TorchMesh, tables: ChunkTables, cal: CalibScalars,
                buckets: BucketState, cryo, t, rows, bc, win: float,
                rad_cap, rad_cosz_min, terrain_radiation: bool,
                swnet_mode: bool, et_mode: int, cryo_bounds):
    """A window's forcing, the head of JAX's window
    (``shud_tpu/driver/fused.py:126-187``): the TSR factor, cell forcing
    and PET, the interception and snow bucket over *win* minutes
    (``simulate.window_forcing``), the cryosphere at *t* (with *cryo*) and
    the BC overlays (with *bc*: the BC tables on the device and their
    column maps).  *rows*: the window's rows of the forcing, LAI and melt
    factor tables, then of each BC table, each a host integer or a
    one-element index on the device (read with ``index_select``, so that
    no host takes part).  Returns (forcing slice, cell forcing, buckets,
    cryosphere state)."""

    def row(tab, i):
        return (tab.index_select(0, i)[0] if isinstance(i, torch.Tensor)
                else tab[i])

    ki, li, mi = rows[:3]
    if bc is None:
        zeros_e, zeros_r = torch.zeros_like(dm.nx), dm.nx.new_zeros(
            dm.num_riv)
        bcv = (zeros_e, zeros_e, zeros_e, zeros_r, zeros_r)
    else:
        tab, maps = bc
        masks = (dm.i_bc > 0, dm.i_bc < 0, dm.i_ss != 0, dm.riv_bc > 0,
                 dm.riv_bc < 0)
        bcv = tuple(torch.where(mask, row(tab[name], r)[maps[col]], 0.0)
                    for (name, col), mask, r in zip(BC_TABLES, masks,
                                                    rows[3:]))
    fs, cf, bk = window_forcing(
        dm, buckets, row(tables.fvals, ki), tables.station_z,
        row(tables.lai_vals, li), row(tables.mf_vals, mi),
        *(row(getattr(tables, f"tsr_{k}"), ki)
          for k in ("sx", "sy", "sz", "wdt", "den")),
        *bcv, cal, win, rad_cap, rad_cosz_min,
        terrain_radiation=terrain_radiation, swnet_mode=swnet_mode,
        et_mode=et_mode)
    if cryo is not None:
        cryo, fu_surf, fu_sub = cryo_step(cryo, cf.temp, t, *cryo_bounds)
        fs = fs._replace(fu_surf=fu_surf, fu_sub=fu_sub)
    return fs, cf, bk, cryo


def window_diag(dm: TorchMesh, mega, mf, fs: ForcingSlice, tout, y,
                close_boundary: bool, per_edge_out: bool,
                mega_kernel: bool = True) -> dict:
    """The diagnostics at a window's accepted state (one extra RHS eval):
    one mega_diag call on the mega path; ``rhs_full`` (with edge_flux)
    elsewhere and for the per-edge channels, which need its [Ne,3]
    fluxes."""
    if mega is not None and not per_edge_out:
        return mega_mod.rhs_mega_diag(mega, mf, y, close_boundary,
                                      mega_kernel)
    _, diag = rhs_full(dm, fs, tout, y, close_boundary=close_boundary)
    return diag


def window_values(dm: TorchMesh, y, diag: dict, cf, buckets: BucketState,
                  net_prcp, per_edge_out: bool):
    """A window's terms of the interval sums: (cells, reaches, lakes),
    keyed as ``ACCUM_KEYS`` (+ ``PER_EDGE_KEYS``), ``ACCUM_RIV_KEYS``
    and ``ACCUM_LAKE_KEYS`` (empty without lakes)."""
    ne, nr, nl = dm.num_ele, dm.num_riv, dm.num_lake
    es, eu, eg = diag["es"], diag["eu"], diag["eg"]
    tu, tg, e_ic = diag["tu"], diag["tg"], diag["e_ic"]
    vals_e = {
        "y_ic": buckets.ic_stg, "y_snow": buckets.snow,
        "y_surf": y[:ne], "y_unsat": y[ne : 2 * ne],
        "y_gw": y[2 * ne : 3 * ne],
        "prcp": cf.prcp, "net_prcp": net_prcp, "etp": cf.etp,
        "eta": e_ic + es + eu + eg + tu + tg,
        "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor,
        "q_rech": diag["q_rech"], "q_sub_tot": diag["q_sub_tot"],
        "q_surf_tot": diag["q_surf_tot"],
        "q_e2r_sub": diag["q_e2r_sub"], "q_e2r_surf": diag["q_e2r_surf"],
        "q_infil": diag["q_infil"], "q_exfil": diag["q_exfil"],
        "e_ic": e_ic, "trans": tu + tg, "evapo": es + eu + eg,
    }
    if per_edge_out:
        for j in range(3):
            vals_e[f"q_esub{j}"] = diag["q_esub"][:, j]
            vals_e[f"q_esurf{j}"] = diag["q_esurf"][:, j]
    vals_r = {
        "q_riv_up": diag["q_riv_up"], "q_riv_down": diag["q_riv_down"],
        "q_riv_sub": diag["q_riv_sub"], "q_riv_surf": diag["q_riv_surf"],
        "y_riv": y[3 * ne : 3 * ne + nr],
    }
    vals_l = {}
    if nl > 0:
        vals_l = {
            "y_lake": y[3 * ne + nr :], "lake_area": diag["lake_area"],
            "q_lake_evap": diag["q_lake_evap"],
            "q_lake_prcp": diag["q_lake_prcp"],
            "q_lake_rivin": diag["q_lake_rivin"],
            "q_lake_surf": diag["q_lake_surf"],
            "q_lake_sub": diag["q_lake_sub"],
            "q_lake_rivout": torch.zeros_like(diag["lake_area"]),
        }
    return vals_e, vals_r, vals_l


def run_interval(
    dm: TorchMesh,
    tables: ChunkTables,
    bdf_state: BDFState,
    buckets: BucketState,
    cal: CalibScalars,
    t0,
    rows,  # [N_ROWS, W] host ints: each window's table rows
    rad_cap,
    rad_cosz_min,
    cfg: SolverConfig,
    n_windows: int,
    win_minutes: float,
    close_boundary: bool = True,
    terrain_radiation: bool = True,
    swnet_mode: bool = False,
    bc_tables=None,  # optional (BC tables on the device, column maps)
    et_mode: int = 0,
    per_edge_out: bool = False,  # accumulate QeleSub/Surf per-edge means
    mega: "mega_mod.MegaTables | None" = None,  # the megakernel's tables
    mega_kernel: bool = True,  # False: the mega path on its plain versions
    cryo: "CryoState | None" = None,  # on: the frozen-ground accumulators
    cryo_bounds=(-1.0, -5.0, -3.0, -10.0),  # surf max/min, sub max/min
    window: "WindowGraph | None" = None,  # on: each solve a graph replay
    solver_kernel: bool = True,  # False: the solver's torch pieces
):
    """Advance *n_windows* solver windows in a host loop; returns (bdf
    state, buckets, cryosphere state, mean_e, mean_r, mean_l, stages
    [W, Nr], qdowns [W, Nr]).  With a *window* (built on
    ``window_functions`` of the same simulation) each window's solve
    replays its graph; without, ``solve_to`` runs the eager loop.  The
    reference ``IntervalGraph`` is held against."""
    ne, nr, nl = dm.num_ele, dm.num_riv, dm.num_lake
    dt = np_dtype(bdf_state.y.dtype)
    accum_keys = ACCUM_KEYS + PER_EDGE_KEYS if per_edge_out else ACCUM_KEYS
    acc_e = {k: bdf_state.y.new_zeros(ne) for k in accum_keys}
    acc_r = {k: bdf_state.y.new_zeros(nr) for k in ACCUM_RIV_KEYS}
    acc_l = {k: bdf_state.y.new_zeros(nl) for k in ACCUM_LAKE_KEYS}
    st, bk = bdf_state, buckets
    stages, qdowns = [], []
    f, lin, qfn = window_functions(dm, mega, close_boundary, mega_kernel,
                                   st.quad is not None)
    for w in range(n_windows):
        t, tout = window_times(dt(t0), w, dt(win_minutes))
        fs, cf, bk, cryo = window_head(
            dm, tables, cal, bk, cryo, float(t), [int(r) for r in rows[:, w]],
            bc_tables, win_minutes, rad_cap, rad_cosz_min, terrain_radiation,
            swnet_mode, et_mode, cryo_bounds)
        mf = None
        if mega is not None:
            # the forcing is packed once a window
            mf = mega_mod.pack_forcing(mega, fs)
            params = (mf, fs if qfn is not None else None)
        else:
            params = fs
        if window is not None:
            st = window.solve(st, tout, params)
        else:
            st = solve_to(f, st, tout, params, cfg, qfn, linearize=lin,
                          solver_kernel=solver_kernel)
        diag = window_diag(dm, mega, mf, fs, tout, st.y, close_boundary,
                           per_edge_out, mega_kernel)
        ve, vr, vl = window_values(dm, st.y, diag, cf, bk, fs.net_prcp,
                                   per_edge_out)
        acc_e = {k: acc_e[k] + ve[k] for k in accum_keys}
        acc_r = {k: acc_r[k] + vr[k] for k in ACCUM_RIV_KEYS}
        if nl > 0:
            acc_l = {k: acc_l[k] + vl[k] for k in ACCUM_LAKE_KEYS}
        stages.append(vr["y_riv"])
        qdowns.append(diag["q_riv_down"])

    mean_e = {k: v / n_windows for k, v in acc_e.items()}
    mean_r = {k: v / n_windows for k, v in acc_r.items()}
    mean_l = {k: v / n_windows for k, v in acc_l.items()}
    return (st, bk, cryo, mean_e, mean_r, mean_l, torch.stack(stages),
            torch.stack(qdowns))


class IntervalPieces:
    """The pieces of ``IntervalGraph``'s program over its static buffers:
    ``init`` (the interval sums zeroed, the window counter ``w`` = 0,
    ``t0`` from the index buffer), ``head`` (the window's table rows read
    by the device index ``w``, ``window_head`` into the static forcing,
    buckets and cryosphere state, the mega forcing packed, the solver's
    head), the solver's pieces (``solver/graph.SolverPieces``), ``tail``
    (``window_diag`` and ``window_values`` into the sums, row ``w`` of
    ``stages`` and ``qdowns``, ``w += 1``) and ``pack`` (the means, by the
    interval's own window count, and the solver's scalars).  The index
    buffer ``idx`` holds the window count, ``t0`` as float64 bits and the
    windows' table rows.  Nothing here refers to the program that runs
    the pieces, so that dropping the graph frees it."""

    def __init__(self, sim: "FusedSimulation", w_max: int):
        dm, cs = sim.dm, sim.inp.control
        y = sim.bdf.y
        dev, dtype = y.device, y.dtype
        self.dm, self.tables, self.mega = dm, sim.tables, sim.mega
        self.mega_kernel, self.bc = sim.mega_kernel, sim.bc
        self.cal, self.fr = sim.fr.cal, sim.fr
        self.win = float(cs.solver_step)
        self.close_boundary = bool(cs.close_boundary)
        self.per_edge_out = per_edge_output(cs)
        gc = sim.inp.calib
        self.cryo_bounds = (gc.fzn_surfmax, gc.fzn_surfmin, gc.fzn_submax,
                            gc.fzn_submin)
        self.idx = torch.zeros(2 + N_ROWS * w_max, dtype=torch.int64,
                               device=dev)
        self.n = self.idx[0]
        self.rows = self.idx[2:].view(N_ROWS, w_max)
        self.w = torch.zeros(1, dtype=torch.int64, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)
        self.t0 = torch.zeros((), dtype=dtype, device=dev)
        self.win_t = torch.full((), self.win, dtype=dtype, device=dev)
        # the state and the window's forcing (shapes from one eager head)
        self.bk, self.cryo = clone(sim.buckets), clone(sim.cryo)
        fs, cf, _, _ = self._head_values(self.t0, [self.w] * N_ROWS)
        self.fs, self.cf = clone(fs), clone(cf)
        quad = sim.bdf.quad is not None
        f, lin, qfn = window_functions(dm, self.mega, self.close_boundary,
                                       self.mega_kernel, quad)
        self.mf = None
        params = self.fs
        if self.mega is not None:
            self.mf = clone(mega_mod.pack_forcing(self.mega, self.fs))
            params = (self.mf, self.fs if quad else None)
        rhs_fn, lin_fn = functions(f, params, lin)
        self.solver = SolverPieces(rhs_fn, lin_fn, sim.cfg, qfn, params,
                                   clone(to_carry(sim.bdf)),
                                   kernel=sim.solver_kernel)
        # the interval sums and their means, one flat buffer each
        keys = (ACCUM_KEYS + PER_EDGE_KEYS if self.per_edge_out
                else ACCUM_KEYS)
        self.layout = ([(k, 0, dm.num_ele) for k in keys]
                       + [(k, 1, dm.num_riv) for k in ACCUM_RIV_KEYS]
                       + [(k, 2, dm.num_lake) for k in ACCUM_LAKE_KEYS])
        self.acc = y.new_zeros(sum(n for *_, n in self.layout))
        self.sums = self.split(self.acc)
        self.mean = torch.zeros_like(self.acc)
        self.stages = y.new_zeros(w_max, dm.num_riv)
        self.qdowns = y.new_zeros(w_max, dm.num_riv)

    def split(self, flat) -> tuple:
        """(cells, reaches, lakes) dicts of views into *flat*."""
        out, off = ({}, {}, {}), 0
        for k, part, n in self.layout:
            out[part][k] = flat[off:off + n]
            off += n
        return out

    def _head_values(self, t, rows):
        return window_head(
            self.dm, self.tables, self.cal, self.bk, self.cryo, t, rows,
            self.bc, self.win, self.fr.rad_factor_cap, self.fr.rad_cosz_min,
            self.fr.terrain_radiation, self.fr.swnet_mode,
            int(self.fr.et_mode), self.cryo_bounds)

    def pieces(self) -> dict:
        """The pieces in the order of a warm-up."""
        return {"init": self.init, "head": self.head,
                **self.solver.pieces(), "tail": self.tail,
                "pack": self.pack}

    def nodes(self, stamped: bool = False) -> tuple:
        """``lax.scan`` over the windows as a WHILE, the solve inside;
        *stamped*: a ``Stamp`` after ``init`` and after each window's
        head, solve and tail (``PHASES``; the WHILE's test is counted in
        the head after it)."""
        if not stamped:
            return ("init", While(lambda: self.more,
                                  ("head", self.solver.loop(), "tail")),
                    "pack")
        start, head, solve, tail = (Stamp(k) for k in range(len(PHASES)))
        return ("init", start,
                While(lambda: self.more, ("head", head, self.solver.loop(),
                                          solve, "tail", tail)),
                "pack")

    def init(self):
        self.w.zero_()
        self.t0.copy_(self.idx[1:2].view(torch.float64)[0])
        self.acc.zero_()
        self.solver.c.nni.zero_()
        self.more.copy_(self.w[0] < self.n)

    def head(self):
        p = self.solver
        t, tout = window_times(self.t0, self.w[0], self.win_t)
        fs, cf, bk, cryo = self._head_values(
            t, list(self.rows.index_select(1, self.w)))
        copy_into(self.fs, fs)
        copy_into(self.cf, cf)
        copy_into(self.bk, bk)
        copy_into(self.cryo, cryo)
        if self.mega is not None:
            copy_into(self.mf, mega_mod.pack_forcing(self.mega, self.fs))
        p.tout.copy_(tout)
        p.nsteps0.copy_(p.c.nsteps)
        p.head()

    def tail(self):
        y = self.solver.c.y
        diag = window_diag(self.dm, self.mega, self.mf, self.fs,
                           self.solver.tout, y, self.close_boundary,
                           self.per_edge_out, self.mega_kernel)
        vals = window_values(self.dm, y, diag, self.cf, self.bk,
                             self.fs.net_prcp, self.per_edge_out)
        for sums, v in zip(self.sums, vals):  # (no lake terms without one)
            for k, x in v.items():
                sums[k].add_(x)
        self.stages.index_copy_(0, self.w, vals[1]["y_riv"][None])
        self.qdowns.index_copy_(0, self.w, diag["q_riv_down"][None])
        self.w.add_(1)
        self.more.copy_(self.w[0] < self.n)

    def pack(self):
        self.mean.copy_(over_count(self.acc, self.n))
        self.solver.tail()


class IntervalGraph:
    """``run_interval`` on the device: an output interval in one launch of
    a CUDA graph, as JAX's ``run_interval`` is one jit (a ``lax.scan``
    over windows, each solve a ``lax.while_loop``).

    The program (``solver/graph.Program``) of ``IntervalPieces``: ``init``
    → WHILE(``w < n_windows``) {``head`` → the solve's WHILE(active)
    {``begin`` → Newton iterations 2..``newton_iters`` under nested IFs →
    ``end``} → ``tail``} → ``pack``.  Before each launch the host writes
    the interval's window count, ``t0`` and the windows' rows of every
    table into one int64 buffer (one host-to-device copy); after it, it
    reads the packed scalars (one host sync) and copies what it returns,
    never the buffers the next interval overwrites.  The window count is
    a device scalar, so one graph serves the short last interval; an
    interval of more than *w_max* windows, or another ``key_of``, needs a
    new graph.

    With tracing on (``trace.enabled()``, part of ``key_of``) the program
    holds ``Stamp`` nodes (``IntervalPieces.nodes``) whose sums
    ``phases`` reads; with it off it holds none.

    *capture*: build and replay the graph (the default on the card);
    False runs the same pieces eagerly, each WHILE and IF decided on the
    host (the CPU tests).  A capture, an instantiation or a launch that
    fails raises: nothing falls back to the eager loop.  ``stats``: graph
    launches, host syncs, windows, steps of each interval, the warm-up,
    capture and instantiation seconds and what the warm-up ran."""

    def __init__(self, sim: "FusedSimulation", w_max: int,
                 capture: "bool | None" = None):
        on_card = sim.bdf.y.is_cuda
        self.capture = on_card if capture is None else capture
        self.key = self.key_of(sim)
        self.w_max = w_max
        self.pieces = IntervalPieces(sim, w_max)
        self._idx_host = (torch.zeros_like(self.pieces.idx, device="cpu")
                          .pin_memory() if on_card else self.pieces.idx)
        stamped = self.key[-1]
        self.stamps = (torch.zeros(len(PHASES) + 1, dtype=torch.int64,
                                   device=self.pieces.idx.device)
                       if stamped else None)
        self.program = Program(self.pieces.pieces(),
                               self.pieces.nodes(stamped), self.capture,
                               self.stamps)
        self.stats = self.program.stats
        self.stats.update(syncs=0, windows=0, steps=[], warmup_newton_iters=0,
                          warmup_windows=0)
        self._last = None

    @staticmethod
    def key_of(sim: "FusedSimulation") -> tuple:
        """What changes the program: mega or edge path, per-edge output,
        cryosphere, BC tables, quadrature, the solver's route, tracing
        (the stamps; last)."""
        return (sim.mega is not None, per_edge_output(sim.inp.control),
                sim.cryo is not None, sim.bc is not None,
                sim.bdf.quad is not None, sim.solver_kernel,
                trace.enabled())

    def run(self, sim: "FusedSimulation", n_windows: int, rows, t0: float):
        """Advance *sim*'s state over *n_windows* windows from *t0* with
        the table *rows* ([N_ROWS, n_windows] host ints); returns what
        ``run_interval`` returns."""
        if n_windows > self.w_max:
            raise ValueError(f"{n_windows} windows in a graph of "
                             f"{self.w_max}")
        p = self.pieces
        host = self._idx_host
        with trace.span("shud.interval.prepare"):
            host[0] = n_windows
            host[1] = int(np.array(float(t0)).view(np.int64))
            host[2:].view(N_ROWS, self.w_max)[:, :n_windows] = (
                torch.from_numpy(np.asarray(rows, dtype=np.int64)))
        if host is not p.idx:
            with trace.span("shud.interval.upload"):
                p.idx.copy_(host, non_blocking=True)
        dev = p.idx.device
        if self.capture and not self.program.built:
            self.program.build(dev)
            self._last = None  # the warm-up moved the state
            self.stats.update(warmup_newton_iters=2, warmup_windows=1)
            solver_graph.warmup_newton_iters += 2
            solver_graph.warmup_windows += 1
        state = (sim.bdf, sim.buckets, sim.cryo)
        if self._last is None or any(a is not b for a, b in
                                     zip(state, self._last)):
            with trace.span("shud.interval.upload"):
                copy_into(p.solver.c, to_carry(sim.bdf))
                copy_into(p.bk, sim.buckets)
                copy_into(p.cryo, sim.cryo)
        self.program.launch(dev)
        host_scalars = p.solver.read()
        with trace.span("shud.interval.copy_out"):
            st = p.solver.result(sim.bdf.quad is not None, host_scalars)
            self.stats["syncs"] += 1
            self.stats["windows"] += n_windows
            self.stats["steps"].append(st.nsteps - sim.bdf.nsteps)
            bk, cryo = clone(p.bk), clone(p.cryo)
            self._last = (st, bk, cryo)
            mean_e, mean_r, mean_l = p.split(p.mean.clone())
            return (st, bk, cryo, mean_e, mean_r, mean_l,
                    p.stages[:n_windows].clone(),
                    p.qdowns[:n_windows].clone())

    def phases(self) -> "dict | None":
        """The device's nanoseconds in the windows' heads, solves and tails
        since the last ``reset_phases`` (one device-to-host read; None
        without stamps, as with tracing off)."""
        if self.stamps is None:
            return None
        sums = self.stamps.tolist()
        return {f"{k}_ns": sums[i] for i, k in enumerate(PHASES)
                if k != "start"}

    def reset_phases(self) -> None:
        """Zero the stamp sums."""
        if self.stamps is not None:
            self.stamps.zero_()

    def close(self) -> None:
        """Free the graph."""
        self.program.close()


def per_edge_output(cs) -> bool:
    """Whether the per-edge flux channels are accumulated
    (dt_Qe_subx/surfx on)."""
    return bool(cs.dt_Qe_subx > 0 or cs.dt_Qe_surfx > 0)


def bc_device_tables(fr: ForcingRuntime, md: MeshData, dtype, device):
    """The project's BC/SS value tables on the device, each [K, ncol]
    (one zero row for a kind the project lacks), and their column maps;
    None when the project has no BC/SS time series."""
    if not fr.bc:
        return None
    ncols = {"ele_y": max(md.i_bc.max(), 0), "ele_q": max(-md.i_bc.min(), 0),
             "ele_ss": np.abs(md.i_ss).max(), "riv_y": max(md.riv_bc.max(), 0),
             "riv_q": max(-md.riv_bc.min(), 0)}
    tables = {}
    for name, key in BC_TABLES:
        vals = (np.asarray(fr.bc[key][1]) if key in fr.bc
                else np.zeros((1, max(int(ncols[key]), 1))))
        tables[name] = torch.as_tensor(vals, device=device).to(dtype)

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=device).long()

    maps = {
        "ele_y": idx(np.maximum(md.i_bc - 1, 0)),
        "ele_q": idx(np.maximum(-md.i_bc - 1, 0)),
        "ele_ss": idx(np.maximum(np.abs(md.i_ss) - 1, 0)),
        "riv_y": idx(np.maximum(md.riv_bc - 1, 0)),
        "riv_q": idx(np.maximum(-md.riv_bc - 1, 0)),
    }
    return tables, maps


@dataclasses.dataclass
class FusedSimulation:
    inp: ProjectInput
    md: MeshData
    dm: TorchMesh
    fr: ForcingRuntime
    tables: ChunkTables
    cfg: SolverConfig
    bdf: BDFState
    buckets: BucketState
    t: float
    last_mean_l: dict = dataclasses.field(default_factory=dict)
    mega: "mega_mod.MegaTables | None" = None  # on: the megakernel's tables
    mega_kernel: bool = True  # False: the mega path on its plain versions
    # False: the solver's torch pieces instead of its kernels
    solver_kernel: bool = True
    cryo: "CryoState | None" = None  # on with cryosphere=1
    # on the card: True, each interval one graph launch (IntervalGraph);
    # "window", each window's solve one (WindowGraph); False, the eager loop
    captured: "bool | str" = True
    bc: "tuple | None" = None  # the BC tables on the device, column maps
    window: "WindowGraph | None" = None  # made at the first such window
    interval: "IntervalGraph | None" = None  # made at the first interval

    def y_dev(self) -> torch.Tensor:
        """The prognostic state as a flat device tensor."""
        return self.bdf.y

    def y_np(self) -> np.ndarray:
        """The prognostic state as a flat host array."""
        return self.bdf.y.detach().cpu().numpy()

    @classmethod
    @trace.spanned("shud.setup.create", always=True)
    def create(cls, project: str, base: str = ".",
               float_dtype: torch.dtype = torch.float64, calib=None,
               edge_kernel: "bool | str" = "auto",
               mega: "bool | str" = "auto",
               mega_kernel: bool = True,
               inp: "ProjectInput | None" = None,
               wb_exact: "bool | None" = None,
               fr: "ForcingRuntime | None" = None,
               device: "str | torch.device" = "cuda",
               captured: bool = True,
               solver_kernel: bool = True,
               **control_overrides):
        """Build a simulation on *device* (the card unless the caller
        asks for the CPU) in *float_dtype*.

        ``edge_kernel``: ``"auto"`` runs the CUDA edge-flux kernels exactly
        when the run is float32 on CUDA; ``False`` keeps their plain
        PyTorch versions there (the reference path the kernels are held
        against); ``True`` elsewhere is refused.

        ``mega``: the whole-RHS megakernel trio.  ``"auto"`` turns it on
        exactly when the run is float32 on CUDA and the mesh is eligible
        (``mega.build_mega_tables``: at most 32,768 cells, at least one
        reach and segment, at most 64 lakes); ``True`` also on a float32
        CPU run, where the plain versions stand in; ``True`` with another
        dtype or on an ineligible mesh is refused.  ``mega_kernel=False``
        keeps the mega path on the kernels' plain PyTorch versions (same
        arithmetic, same hand tangent) on the card too: the reference path
        the kernels are held against.

        ``captured``: on the card each output interval is one launch of a
        captured CUDA graph (``IntervalGraph``: JAX's ``run_interval`` as
        one jit); a capture that fails raises.  ``captured="window"``
        replays a graph of each window's solve (``solver/graph.
        WindowGraph``) inside the host loop over windows;
        ``captured=False`` runs the eager loop there (the reference both
        graphs are held against).  The CPU runs the eager loop, unless
        the caller gives the simulation an ``IntervalGraph`` or a
        ``WindowGraph`` with ``capture=False`` (the tests).

        ``solver_kernel``: the solver's step and Newton–Krylov body through
        the kernels of ``solver/kernels.py`` (in every form: interval
        graph, window graph, eager loop; their plain versions on the CPU);
        False runs the solver's torch pieces, the reference they are held
        against (bitwise).

        The mega path keeps the eager ``TorchMesh`` beside its tables: the
        window's forcing (``cell_forcing``, ``et_bucket_step``) reads its
        per-cell fields, and ``quad_rates`` (``wb_exact``) and ``rhs_full``
        (per-edge output channels) its edge tables."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device=\"cpu\" to run on the CPU")
        if captured not in (True, False, "window"):
            raise ValueError(f"captured must be True, False or 'window': "
                             f"{captured!r}")
        if mega not in (True, False, "auto"):
            raise ValueError(f"mega must be True, False or 'auto': {mega!r}")
        if mega is True and float_dtype != torch.float32:
            raise ValueError("the megakernel path runs in float32 only")
        if inp is None:
            inp = load_project(project, base=base)
        if calib is not None:
            inp.calib = calib
        for k, v in control_overrides.items():
            setattr(inp.control, k, v)
        from shud_tpu_torch.io.validate import check_input

        with trace.step("shud.setup.mesh"):
            check_input(inp)
            md = build_mesh(inp)
        with trace.step("shud.setup.tables"):
            mega_tables = None
            if mega is True or (mega == "auto"
                                and float_dtype == torch.float32
                                and device.type == "cuda"):
                mega_tables = mega_mod.build_mega_tables(md)
                if mega_tables is None and mega is True:
                    raise ValueError(
                        f"the mesh is not eligible for the megakernel path "
                        f"({md.num_ele} cells, {md.num_riv} reaches, "
                        f"{md.num_seg} segments, {md.num_lake} lakes)")
                if mega_tables is not None:
                    mega_tables = mega_tables.to(device)
            if edge_kernel == "auto":
                edge_kernel = None
            dm = to_torch(md, float_dtype, device, edge_kernel=edge_kernel)
        fd = float_dtype
        if fr is None:
            fr = build_forcing(inp, md)
        else:
            # reuse the station/TSR tables, refresh the calibration scalars
            from shud_tpu_torch.driver.forcing import rebuild_cal

            fr = rebuild_cal(fr, inp.calib)
        cs = inp.control
        cfg = SolverConfig(rtol=cs.reltol, atol=cs.abstol,
                           h_init=cs.init_step, h_max=cs.max_step)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device).to(fd)

        tables = ChunkTables(
            fvals=t(fr.fvals), station_z=t(fr.station_z),
            lai_vals=t(fr.lai_vals), mf_vals=t(fr.mf_vals),
            tsr_sx=t(fr.tsr_sx), tsr_sy=t(fr.tsr_sy), tsr_sz=t(fr.tsr_sz),
            tsr_wdt=t(fr.tsr_wdt), tsr_den=t(fr.tsr_den),
        )
        fr.cal = CalibScalars(*[v.to(device=device, dtype=fd) for v in fr.cal])
        y0 = t(initial_state(inp, md))
        ic0, snow0 = initial_buckets(inp, md)
        cryo = None
        if cs.cryosphere:
            gc = inp.calib
            cryo = cryo_init(md.num_ele, int(gc.fzn_surfday),
                             int(gc.fzn_subday), fd, device)
        # exact water-balance quadrature along the solver trajectory is
        # opt-in, mirroring the reference (SHUD_WB_DIAG=1, shud.cpp:70-75)
        if wb_exact is None:
            wb_exact = os.environ.get("SHUD_WB_DIAG", "0") not in ("0", "")
        quad0 = ({k: torch.zeros((), dtype=fd, device=device)
                  for k in ("et", "qout", "qedge", "qbc", "qss", "nc",
                            "lake_p", "lake_e")} if wb_exact else None)
        return cls(
            inp=inp, md=md, dm=dm, fr=fr, tables=tables, cfg=cfg,
            bdf=bdf_init(cs.start_time, y0, cfg, quad0=quad0),
            buckets=BucketState(ic_stg=t(ic0), snow=t(snow0)),
            t=cs.start_time, mega=mega_tables, mega_kernel=mega_kernel,
            cryo=cryo, captured=captured, solver_kernel=solver_kernel,
            bc=bc_device_tables(fr, md, fd, device),
        )

    def window_rows(self, t0: float, n_windows: int, win: float):
        """[N_ROWS, n_windows] int64: each window's rows of the forcing,
        LAI and melt factor tables and of each BC table (0 where the
        project has no such table)."""
        ts = t0 + np.arange(n_windows) * win

        def at(axis):
            return np.searchsorted(axis, ts + 1e-9, side="right") - 1

        rows = np.zeros((N_ROWS, n_windows), dtype=np.int64)
        rows[0] = at(self.fr.t_axis)
        rows[1] = np.maximum(at(self.fr.lai_t), 0)
        rows[2] = np.maximum(at(self.fr.mf_t), 0)
        for r, (_, key) in enumerate(BC_TABLES, start=3):
            if key in self.fr.bc:
                rows[r] = np.clip(at(self.fr.bc[key][0]), 0, None)
        return rows

    def advance_interval(self, interval_minutes: float):
        """Advance one output interval; returns (mean_e, mean_r, stages,
        qdowns) as device tensors.  Its span (``shud.advance_interval``)
        opens the interval's number in ``trace``; the process's first is
        recorded always."""
        first = trace.next_interval() == 1
        with trace.span("shud.advance_interval", always=first):
            return self._advance(interval_minutes)

    def _advance(self, interval_minutes: float):
        cs = self.inp.control
        win = cs.solver_step
        n_windows = int(round(interval_minutes / win))
        with trace.span("shud.interval.prepare"):
            rows = self.window_rows(self.t, n_windows, win)
        on_card = self.bdf.y.is_cuda
        if self.interval is None and self.captured is True and on_card:
            self.interval = IntervalGraph(self, n_windows)
        if self.interval is not None and (
                self.interval.key != IntervalGraph.key_of(self)
                or n_windows > self.interval.w_max):
            capture = self.interval.capture
            self.interval.close()
            self.interval = IntervalGraph(self, n_windows, capture)
        if self.interval is not None:
            out = self.interval.run(self, n_windows, rows, self.t)
        else:
            if (self.window is None and self.captured == "window"
                    and on_card):
                f, lin, qfn = window_functions(
                    self.dm, self.mega, bool(cs.close_boundary),
                    self.mega_kernel, self.bdf.quad is not None)
                self.window = WindowGraph(f, lin, self.cfg, quad_fn=qfn,
                                          solver_kernel=self.solver_kernel)
            gc = self.inp.calib
            out = run_interval(
                self.dm, self.tables, self.bdf, self.buckets, self.fr.cal,
                self.t, rows, self.fr.rad_factor_cap, self.fr.rad_cosz_min,
                self.cfg, n_windows, float(win),
                close_boundary=bool(cs.close_boundary),
                terrain_radiation=self.fr.terrain_radiation,
                swnet_mode=self.fr.swnet_mode, bc_tables=self.bc,
                et_mode=int(self.fr.et_mode),
                per_edge_out=per_edge_output(cs), mega=self.mega,
                mega_kernel=self.mega_kernel, cryo=self.cryo,
                cryo_bounds=(gc.fzn_surfmax, gc.fzn_surfmin,
                             gc.fzn_submax, gc.fzn_submin),
                window=self.window, solver_kernel=self.solver_kernel)
        st, bk, cryo, mean_e, mean_r, mean_l, stages, qdowns = out
        self.bdf = st
        self.buckets = bk
        self.cryo = cryo
        self.t += interval_minutes
        self.last_mean_l = mean_l
        return mean_e, mean_r, stages, qdowns
