"""Simulation driver: the outer time loop, one solver window per call.

The counterpart of ``shud_tpu/driver/simulate.py``, mirroring the
reference's global-implicit driver (``src/Model/shud.cpp:32-168``): per
SolverStep window, refresh forcing (step semantics), update the
snow/interception buckets explicitly, then advance the coupled ODE
implicitly to the window end, linearizing the RHS once per Newton
iteration (``rhs.linearize``).  The host looks the window's forcing up in
the station tables (``ForcingRuntime``); the fused driver
(``driver/fused.py``) batches the same windows into output intervals.  On
the card each window's solve is one launch of a captured CUDA graph
(``solver/graph.WindowGraph``: JAX's ``window_step`` solves inside one
``lax.while_loop``); ``Simulation.create(captured=False)`` and the CPU
run the eager ``solve_to``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from shud_tpu_torch.core import solar as solar_mod
from shud_tpu_torch.core.device import TorchMesh, to_torch
from shud_tpu_torch.core.landsurface import (
    BucketState,
    CalibScalars,
    cell_forcing,
    et_bucket_step,
)
from shud_tpu_torch.core.mesh import MeshData, build_mesh
from shud_tpu_torch.core.rhs import linearize, rhs, rhs_full
from shud_tpu_torch.core.state import ForcingSlice
from shud_tpu_torch.driver.forcing import ForcingRuntime, build_forcing
from shud_tpu_torch.driver.init import initial_buckets, initial_state
from shud_tpu_torch.io.project import ProjectInput, load_project
from shud_tpu_torch.solver.bdf import (
    BDFState, SolverConfig, bdf_init, solve_to)
from shud_tpu_torch.solver.graph import WindowGraph


def window_forcing(
    dm: TorchMesh,
    buckets: BucketState,
    station_vals,  # [S, 5]
    station_z,
    lai_vals,
    mf_vals,
    tsr_sx, tsr_sy, tsr_sz, tsr_wdt, tsr_den,
    bc_ele_ybc, bc_ele_qbc, bc_ele_qss, bc_riv_ybc, bc_riv_qbc,
    cal: CalibScalars,
    dt,
    rad_cap, rad_cosz_min,
    terrain_radiation: bool = True,
    swnet_mode: bool = False,
    et_mode: int = 0,
):
    """One window's forcing: TSR factor, cell forcing, the interception and
    snow bucket over *dt* minutes.  Returns (forcing slice, cell forcing,
    buckets); the frozen fractions are 1."""
    if terrain_radiation:
        factor = solar_mod.tsr_factor(
            dm.nx, dm.ny, dm.nz, tsr_sx, tsr_sy, tsr_sz, tsr_wdt, tsr_den,
            rad_cap, rad_cosz_min,
        )
    else:
        factor = torch.ones_like(dm.nx)
    cf = cell_forcing(
        dm, station_vals, station_z, lai_vals, mf_vals, factor, cal,
        swnet_mode=swnet_mode, terrain_radiation=terrain_radiation,
        et_mode=et_mode,
    )
    out = et_bucket_step(dm, cf, buckets, dt, cal.c_ismax)
    ones = torch.ones_like(dm.nx)
    fs = ForcingSlice(
        net_prcp=out.net_prcp, prcp=cf.prcp,
        pot_evap=cf.pot_evap, pot_tran=cf.pot_tran,
        e_ic=out.e_ic, lai=cf.lai,
        fu_surf=ones, fu_sub=ones,
        ele_ybc=bc_ele_ybc, ele_qbc=bc_ele_qbc, ele_qss=bc_ele_qss,
        riv_ybc=bc_riv_ybc, riv_qbc=bc_riv_qbc,
    )
    return fs, cf, out.state


@dataclasses.dataclass
class Simulation:
    inp: ProjectInput
    md: MeshData
    dm: TorchMesh  # device mesh
    fr: ForcingRuntime
    cfg: SolverConfig
    bdf: BDFState
    buckets: BucketState
    t: float
    captured: bool = True  # on the card: each window's solve a graph launch
    window: "WindowGraph | None" = None  # made at the first such window
    solver_kernel: bool = True  # False: the solver's torch pieces

    @classmethod
    def create(cls, project: str, base: str = ".",
               float_dtype: torch.dtype = torch.float64, calib=None,
               device: "str | torch.device" = "cuda",
               edge_kernel: "bool | str" = "auto",
               inp: "ProjectInput | None" = None, dummy: bool = False,
               captured: bool = True, solver_kernel: bool = True,
               **control_overrides):
        """Load *project* (or take *inp*, as ``FusedSimulation.create``
        does) and build the simulation on *device* (the card unless the
        caller asks for the CPU) in *float_dtype*; ``edge_kernel`` as in
        ``FusedSimulation.create``.  The frozen-ground module runs only in
        the fused driver (as in the JAX package), so ``cryosphere=1`` is
        refused here unless the run solves nothing (``dummy``, the
        reference's ``-0``).  ``captured``: on the card each window's
        solve replays a ``WindowGraph`` (a capture that fails raises);
        False runs the eager ``solve_to`` there, the reference it is held
        against.  The CPU runs ``solve_to`` unless the caller gives the
        simulation a ``WindowGraph`` with ``capture=False`` (the
        tests).  ``solver_kernel`` as in ``FusedSimulation.create``."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device=\"cpu\" to run on the CPU")
        if inp is None:
            inp = load_project(project, base=base)
        if calib is not None:
            inp.calib = calib
        for k, v in control_overrides.items():
            setattr(inp.control, k, v)
        if inp.control.cryosphere and not dummy:
            raise ValueError(
                "the per-window and operator-split drivers have no "
                "cryosphere; run the fused driver (without --per-window "
                "or -g)")
        from shud_tpu_torch.io.validate import check_input

        check_input(inp)
        md = build_mesh(inp)
        ek = None if edge_kernel == "auto" else edge_kernel
        dm = to_torch(md, float_dtype, device, edge_kernel=ek)
        fr = build_forcing(inp, md)
        fr.cal = CalibScalars(*[v.to(device=device, dtype=float_dtype)
                                for v in fr.cal])
        cs = inp.control
        cfg = SolverConfig(
            rtol=cs.reltol, atol=cs.abstol, h_init=cs.init_step,
            h_max=cs.max_step,
        )

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device).to(
                float_dtype)

        y0 = initial_state(inp, md)
        ic0, snow0 = initial_buckets(inp, md)
        buckets = BucketState(ic_stg=t(ic0), snow=t(snow0))
        bdf = bdf_init(cs.start_time, t(y0), cfg)
        return cls(inp=inp, md=md, dm=dm, fr=fr, cfg=cfg, bdf=bdf,
                   buckets=buckets, t=cs.start_time, captured=captured,
                   solver_kernel=solver_kernel)

    def _dev(self, a):
        y = self.bdf.y
        return torch.as_tensor(np.asarray(a), device=y.device).to(y.dtype)

    def _window_forcing(self, tout: float):
        fr, md, t = self.fr, self.md, self.t
        d = self._dev
        sx, sy, sz, wdt, den = fr.tsr_sample(t)
        bc = fr.bc_values(md, t)
        return window_forcing(
            self.dm, self.buckets,
            d(fr.station_values(t)), d(fr.station_z), d(fr.lai_at(t)),
            d(fr.mf_at(t)), d(sx), d(sy), d(sz), d(wdt), d(den),
            d(bc["ele_ybc"]), d(bc["ele_qbc"]), d(bc["ele_qss"]),
            d(bc["riv_ybc"]), d(bc["riv_qbc"]),
            fr.cal, tout - t, fr.rad_factor_cap, fr.rad_cosz_min,
            terrain_radiation=fr.terrain_radiation,
            swnet_mode=fr.swnet_mode,
            et_mode=int(fr.et_mode),
        )

    def forcing_slice(self, tout: float):
        """Forcing and bucket update for [t, tout) without advancing the
        implicit solver (the operator-split driver and the fixed-step
        truth use it).  Returns (forcing slice, cell forcing)."""
        fs, cf, self.buckets = self._window_forcing(tout)
        self.t = tout
        return fs, cf

    def advance_window(self, tout: float):
        """Advance to tout (one SolverStep window): forcing, buckets, then
        the implicit solve, linearized once per Newton iteration.  Returns
        (forcing slice, cell forcing) of the window."""
        fs, cf, buckets = self._window_forcing(tout)
        if self.window is None and self.captured and self.bdf.y.is_cuda:
            self.window = WindowGraph(*self.window_functions(), self.cfg,
                                      solver_kernel=self.solver_kernel)
        if self.window is not None:
            self.bdf = self.window.solve(self.bdf, tout, fs)
        else:
            f, lin = self.window_functions()
            self.bdf = solve_to(f, self.bdf, tout, fs, self.cfg,
                                linearize=lin,
                                solver_kernel=self.solver_kernel)
        self.buckets = buckets
        self.t = tout
        return fs, cf

    def window_functions(self):
        """``solve_to``'s RHS and linearization hook (``rhs.linearize``),
        given the window's forcing slice as their params; the mesh is a
        constant of both, so a ``WindowGraph`` replays them on its static
        forcing."""
        dm, cb = self.dm, bool(self.inp.control.close_boundary)

        def f(tt, yy, fs):
            return rhs(dm, fs, tt, yy, close_boundary=cb)

        def lin(tt, yy, fs):
            return linearize(dm, fs, tt, yy, cb)

        return f, lin

    def run(self, t_end: float | None = None,
            observer: Callable | None = None):
        cs = self.inp.control
        if t_end is None:
            t_end = cs.end_time
        step = cs.solver_step
        while self.t < t_end - 1e-9:
            tout = min(self.t + step, t_end)
            fs, cf = self.advance_window(tout)
            if observer is not None:
                observer(self, fs, cf)
        return self

    def diagnostics(self, fs: ForcingSlice):
        """Flux diagnostics at the current accepted state."""
        _, diag = rhs_full(
            self.dm, fs, self.t, self.bdf.y,
            close_boundary=bool(self.inp.control.close_boundary),
        )
        return diag
