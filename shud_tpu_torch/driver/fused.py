"""Fused driver: one output interval of solver windows per call.

The counterpart of ``shud_tpu/driver/fused.py``.  For each window
(``run_interval``): TSR factor -> cell forcing/PET -> bucket update ->
cryosphere (``cryosphere=1``) and BC overlays -> adaptive implicit solve
-> one diagnostics RHS, accumulated into interval means.  The solve
linearizes the RHS once per Newton iteration, as the JAX solver's
``jax.linearize``: on the eager path through ``rhs.linearize`` (one
coefficient call of the edge kernels, then one apply call per Krylov
vector), with the megakernel on (``FusedSimulation.create(mega=)``,
``core/mega.py``) through ``mega.linearize_mega`` (one RHS kernel call,
one tangent kernel call per Krylov vector), where the diagnostics take one
kernel call too.  JAX runs the
windows as one ``lax.scan`` inside one jit; here they are a Python loop
whose tensors stay on the device, and the host receives the interval
means and the per-window river stages.  On the card each window's solve
is one replay of a captured CUDA graph (``solver/graph.WindowGraph``: the
JAX solver's ``lax.while_loop`` on the device, one host sync a window
plus one per further launch); ``FusedSimulation.create(captured=False)``
runs the eager loop there instead, for comparison.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from shud_tpu_torch.core import mega as mega_mod
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core import solar as solar_mod
from shud_tpu_torch.core.cryo import CryoState, cryo_init, cryo_step
from shud_tpu_torch.core.device import TorchMesh, to_torch
from shud_tpu_torch.core.landsurface import (
    BucketState,
    CalibScalars,
    cell_forcing,
    et_bucket_step,
)
from shud_tpu_torch.core.mesh import MeshData, build_mesh
from shud_tpu_torch.core.rhs import linearize, rhs, rhs_full
from shud_tpu_torch.core.state import ForcingSlice, split_y
from shud_tpu_torch.driver.forcing import ForcingRuntime, build_forcing
from shud_tpu_torch.driver.init import initial_buckets, initial_state
from shud_tpu_torch.io.project import ProjectInput, load_project
from shud_tpu_torch.solver.bdf import (
    BDFState, SolverConfig, bdf_init, np_dtype, solve_to)
from shud_tpu_torch.solver.graph import WindowGraph


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


def run_interval(
    dm: TorchMesh,
    tables: ChunkTables,
    bdf_state: BDFState,
    buckets: BucketState,
    cal: CalibScalars,
    t0,
    forc_idx,  # [W] host ints
    lai_idx,  # [W]
    mf_idx,  # [W]
    rad_cap,
    rad_cosz_min,
    cfg: SolverConfig,
    n_windows: int,
    win_minutes: float,
    close_boundary: bool = True,
    terrain_radiation: bool = True,
    swnet_mode: bool = False,
    bc_tables=None,  # optional (per-window BC value tables, column maps)
    et_mode: int = 0,
    per_edge_out: bool = False,  # accumulate QeleSub/Surf per-edge means
    mega: "mega_mod.MegaTables | None" = None,  # the megakernel's tables
    mega_kernel: bool = True,  # False: the mega path on its plain versions
    cryo: "CryoState | None" = None,  # on: the frozen-ground accumulators
    cryo_bounds=(-1.0, -5.0, -3.0, -10.0),  # surf max/min, sub max/min
    window: "WindowGraph | None" = None,  # on: each solve a graph replay
):
    """Advance *n_windows* solver windows; returns (bdf state, buckets,
    cryosphere state, mean_e, mean_r, mean_l, stages [W, Nr],
    qdowns [W, Nr]).  With a *window* (built on ``window_functions`` of
    the same simulation) each window's solve replays its graph; without,
    ``solve_to`` runs the eager loop."""
    ne, nr, nl = dm.num_ele, dm.num_riv, dm.num_lake
    dtype = bdf_state.y.dtype
    dt = np_dtype(dtype)
    zeros_e = bdf_state.y.new_zeros(ne)
    zeros_r = bdf_state.y.new_zeros(nr)
    zeros_l = bdf_state.y.new_zeros(nl)
    bc_tab, bc_maps = bc_tables if bc_tables is not None else (None, None)

    accum_keys = ACCUM_KEYS + PER_EDGE_KEYS if per_edge_out else ACCUM_KEYS
    acc_e = {k: zeros_e for k in accum_keys}
    acc_r = {k: zeros_r for k in ACCUM_RIV_KEYS}
    acc_l = {k: zeros_l for k in ACCUM_LAKE_KEYS}
    st, bk = bdf_state, buckets
    stages, qdowns = [], []
    ones = torch.ones_like(dm.nx)
    f, lin, qfn = window_functions(dm, mega, close_boundary, mega_kernel,
                                   st.quad is not None)
    for w in range(n_windows):
        ki, li, mi = int(forc_idx[w]), int(lai_idx[w]), int(mf_idx[w])
        t = dt(t0) + dt(w) * dt(win_minutes)
        tout = t + dt(win_minutes)

        if terrain_radiation:
            factor = solar_mod.tsr_factor(
                dm.nx, dm.ny, dm.nz,
                tables.tsr_sx[ki], tables.tsr_sy[ki], tables.tsr_sz[ki],
                tables.tsr_wdt[ki], tables.tsr_den[ki],
                rad_cap, rad_cosz_min,
            )
        else:
            factor = ones
        cf = cell_forcing(
            dm, tables.fvals[ki], tables.station_z,
            tables.lai_vals[li], tables.mf_vals[mi], factor, cal,
            swnet_mode=swnet_mode, terrain_radiation=terrain_radiation,
            et_mode=et_mode,
        )
        out = et_bucket_step(dm, cf, bk, win_minutes, cal.c_ismax)
        if cryo is not None:
            cryo, fu_surf, fu_sub = cryo_step(cryo, cf.temp, float(t),
                                              *cryo_bounds)
        else:
            fu_surf = fu_sub = ones
        if bc_maps is None:
            ele_ybc, ele_qbc, ele_qss = zeros_e, zeros_e, zeros_e
            riv_ybc, riv_qbc = zeros_r, zeros_r
        else:
            ele_ybc = torch.where(
                dm.i_bc > 0, bc_tab["ele_ybc"][w][bc_maps["ele_y"]], 0.0)
            ele_qbc = torch.where(
                dm.i_bc < 0, bc_tab["ele_qbc"][w][bc_maps["ele_q"]], 0.0)
            ele_qss = torch.where(
                dm.i_ss != 0, bc_tab["ele_qss"][w][bc_maps["ele_ss"]], 0.0)
            riv_ybc = torch.where(
                dm.riv_bc > 0, bc_tab["riv_ybc"][w][bc_maps["riv_y"]], 0.0)
            riv_qbc = torch.where(
                dm.riv_bc < 0, bc_tab["riv_qbc"][w][bc_maps["riv_q"]], 0.0)
        fs = ForcingSlice(
            net_prcp=out.net_prcp, prcp=cf.prcp, pot_evap=cf.pot_evap,
            pot_tran=cf.pot_tran, e_ic=out.e_ic, lai=cf.lai,
            fu_surf=fu_surf, fu_sub=fu_sub,
            ele_ybc=ele_ybc, ele_qbc=ele_qbc, ele_qss=ele_qss,
            riv_ybc=riv_ybc, riv_qbc=riv_qbc,
        )

        if mega is not None:
            # the forcing is packed once a window
            mf = mega_mod.pack_forcing(mega, fs)
            params = (mf, fs if qfn is not None else None)
        else:
            params = fs
        if window is not None:
            st = window.solve(st, tout, params)
        else:
            st = solve_to(f, st, tout, params, cfg, qfn, linearize=lin)
        y = st.y
        bk = out.state

        # diagnostics at the accepted state (one extra RHS eval); the
        # per-edge channels need the [Ne,3] fluxes, which only rhs_full has
        if mega is not None and not per_edge_out:
            diag = mega_mod.rhs_mega_diag(mega, mf, y, close_boundary,
                                          mega_kernel)
        else:
            _, diag = rhs_full(dm, fs, tout, y, close_boundary=close_boundary)
        es, eu, eg = diag["es"], diag["eu"], diag["eg"]
        tu, tg, e_ic = diag["tu"], diag["tg"], diag["e_ic"]
        vals_e = {
            "y_ic": out.state.ic_stg, "y_snow": out.state.snow,
            "y_surf": y[:ne], "y_unsat": y[ne : 2 * ne],
            "y_gw": y[2 * ne : 3 * ne],
            "prcp": cf.prcp, "net_prcp": out.net_prcp, "etp": cf.etp,
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
        riv_stage = y[3 * ne : 3 * ne + nr]
        vals_r = {
            "q_riv_up": diag["q_riv_up"], "q_riv_down": diag["q_riv_down"],
            "q_riv_sub": diag["q_riv_sub"], "q_riv_surf": diag["q_riv_surf"],
            "y_riv": riv_stage,
        }
        acc_e = {k: acc_e[k] + vals_e[k] for k in accum_keys}
        acc_r = {k: acc_r[k] + vals_r[k] for k in ACCUM_RIV_KEYS}
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
            acc_l = {k: acc_l[k] + vals_l[k] for k in ACCUM_LAKE_KEYS}
        stages.append(riv_stage)
        qdowns.append(diag["q_riv_down"])

    mean_e = {k: v / n_windows for k, v in acc_e.items()}
    mean_r = {k: v / n_windows for k, v in acc_r.items()}
    mean_l = {k: v / n_windows for k, v in acc_l.items()}
    return (st, bk, cryo, mean_e, mean_r, mean_l, torch.stack(stages),
            torch.stack(qdowns))


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
    cryo: "CryoState | None" = None  # on with cryosphere=1
    captured: bool = True  # on the card: each window a graph replay
    window: "WindowGraph | None" = None  # made at the first captured window

    def y_dev(self) -> torch.Tensor:
        """The prognostic state as a flat device tensor."""
        return self.bdf.y

    def y_np(self) -> np.ndarray:
        """The prognostic state as a flat host array."""
        return self.bdf.y.detach().cpu().numpy()

    @classmethod
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

        ``captured``: on the card each window's solve replays a captured
        CUDA graph (``solver/graph.WindowGraph``); a capture that fails
        raises.  ``captured=False`` runs the eager loop there instead (the
        reference the graph is held against); the CPU always runs it.

        The mega path keeps the eager ``TorchMesh`` beside its tables: the
        window's forcing (``cell_forcing``, ``et_bucket_step``) reads its
        per-cell fields, and ``quad_rates`` (``wb_exact``) and ``rhs_full``
        (per-edge output channels) its edge tables."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device=\"cpu\" to run on the CPU")
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

        check_input(inp)
        md = build_mesh(inp)
        mega_tables = None
        if mega is True or (mega == "auto" and float_dtype == torch.float32
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
            cryo=cryo, captured=captured,
        )

    def window_indices(self, t0: float, n_windows: int, win: float):
        ts = t0 + np.arange(n_windows) * win
        fi = np.searchsorted(self.fr.t_axis, ts + 1e-9, side="right") - 1
        li = np.searchsorted(self.fr.lai_t, ts + 1e-9, side="right") - 1
        mi = np.searchsorted(self.fr.mf_t, ts + 1e-9, side="right") - 1
        return fi, np.maximum(li, 0), np.maximum(mi, 0)

    def advance_interval(self, interval_minutes: float):
        """Advance one output interval; returns (mean_e, mean_r, stages,
        qdowns) as device tensors."""
        cs = self.inp.control
        win = cs.solver_step
        n_windows = int(round(interval_minutes / win))
        fi, li, mi = self.window_indices(self.t, n_windows, win)
        gc = self.inp.calib
        if self.window is None and self.captured and self.bdf.y.is_cuda:
            f, lin, qfn = window_functions(
                self.dm, self.mega, bool(cs.close_boundary),
                self.mega_kernel, self.bdf.quad is not None)
            self.window = WindowGraph(f, lin, self.cfg, quad_fn=qfn)
        st, bk, cryo, mean_e, mean_r, mean_l, stages, qdowns = run_interval(
            self.dm, self.tables, self.bdf, self.buckets, self.fr.cal,
            self.t, fi, li, mi,
            self.fr.rad_factor_cap, self.fr.rad_cosz_min,
            self.cfg, n_windows, float(win),
            close_boundary=bool(cs.close_boundary),
            terrain_radiation=self.fr.terrain_radiation,
            swnet_mode=self.fr.swnet_mode,
            bc_tables=self._bc_tables(self.t, n_windows, win),
            et_mode=int(self.fr.et_mode),
            per_edge_out=bool(cs.dt_Qe_subx > 0 or cs.dt_Qe_surfx > 0),
            mega=self.mega, mega_kernel=self.mega_kernel, cryo=self.cryo,
            cryo_bounds=(gc.fzn_surfmax, gc.fzn_surfmin,
                         gc.fzn_submax, gc.fzn_submin),
            window=self.window,
        )
        self.bdf = st
        self.buckets = bk
        self.cryo = cryo
        self.t += interval_minutes
        self.last_mean_l = mean_l
        return mean_e, mean_r, stages, qdowns

    def _bc_tables(self, t0, n_windows, win):
        """Per-window BC value tables and column maps (None when the project
        has no BC/SS time series)."""
        if not self.fr.bc:
            return None
        md = self.md
        dtype = self.bdf.y.dtype
        device = self.bdf.y.device
        ts = t0 + np.arange(n_windows) * win

        def rows_of(key, ncol_needed):
            if key in self.fr.bc:
                bt, bv = self.fr.bc[key]
                idx = np.clip(
                    np.searchsorted(bt, ts + 1e-9, side="right") - 1, 0, None
                )
                return torch.as_tensor(np.asarray(bv[idx]),
                                       device=device).to(dtype)
            return torch.zeros((n_windows, max(ncol_needed, 1)),
                               dtype=dtype, device=device)

        def idx(a):
            return torch.as_tensor(np.asarray(a), device=device).long()

        tables = {
            "ele_ybc": rows_of("ele_y", int(max(md.i_bc.max(), 0))),
            "ele_qbc": rows_of("ele_q", int(max(-md.i_bc.min(), 0))),
            "ele_qss": rows_of("ele_ss", int(np.abs(md.i_ss).max())),
            "riv_ybc": rows_of("riv_y", int(max(md.riv_bc.max(), 0))),
            "riv_qbc": rows_of("riv_q", int(max(-md.riv_bc.min(), 0))),
        }
        maps = {
            "ele_y": idx(np.maximum(md.i_bc - 1, 0)),
            "ele_q": idx(np.maximum(-md.i_bc - 1, 0)),
            "ele_ss": idx(np.maximum(np.abs(md.i_ss) - 1, 0)),
            "riv_y": idx(np.maximum(md.riv_bc - 1, 0)),
            "riv_q": idx(np.maximum(-md.riv_bc - 1, 0)),
        }
        return (tables, maps)
