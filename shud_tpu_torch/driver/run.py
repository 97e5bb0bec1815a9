"""Full simulation run: outputs, restart snapshots, flood alerts, logs.

The counterpart of ``shud_tpu/driver/run.py``: the reference's
``SHUD(FileIn*, FileOut*)`` driver (``src/Model/shud.cpp:32-168``) with its
Print_Ctrl channel registry (``MD_initialize.cpp:246-360``) and output
naming scheme (``IO.cpp:108-198``), one solver window at a time through
``driver/simulate.py``.  ``dummy=True`` (the reference's ``-0``) runs the
IO pipeline only: every file is opened and the clock advanced, nothing is
solved.
"""

from __future__ import annotations

import os
import time

import numpy as np

import torch

from shud_tpu_torch.driver.run_fast import _to_host
from shud_tpu_torch.driver.simulate import Simulation
from shud_tpu_torch.io.output import (
    FloodAlert, PrintCtrl, TimeLog, write_restart)


class OutputManager:
    """Registers Print_Ctrl channels per the run-control dt_* settings."""

    def __init__(self, sim: Simulation):
        cs = sim.inp.control
        paths = sim.inp.paths
        md = sim.md
        start = sim.inp.forc.start_yyyymmdd
        os.makedirs(paths.outpath, exist_ok=True)
        b, a = bool(cs.binary), bool(cs.ascii)
        self.channels: list[tuple[PrintCtrl, str]] = []

        def ch(name, dt, key, is_flux, n):
            if dt > 0:
                pc = PrintCtrl(
                    os.path.join(paths.outpath, f"{paths.project}.{name}"),
                    start, dt, is_flux, n, binary=b, ascii_=a,
                )
                self.channels.append((pc, key))

        ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
        # storages
        ch("eleyic", cs.dt_ye_ic, "y_ic", False, ne)
        ch("eleysnow", cs.dt_ye_snow, "y_snow", False, ne)
        ch("eleysurf", cs.dt_ye_surf, "y_surf", False, ne)
        ch("eleyunsat", cs.dt_ye_unsat, "y_unsat", False, ne)
        ch("eleygw", cs.dt_ye_gw, "y_gw", False, ne)
        # fluxes
        ch("elevprcp", cs.dt_qe_prcp, "prcp", True, ne)
        ch("elevnetprcp", cs.dt_qe_prcp, "net_prcp", True, ne)
        ch("elevetp", cs.dt_qe_etp, "etp", True, ne)
        ch("eleveta", cs.dt_qe_eta, "eta", True, ne)
        ch("elevrech", cs.dt_qe_rech, "q_rech", True, ne)
        ch("eleqsub", cs.dt_Qe_sub, "q_sub_tot", True, ne)
        ch("eleqsurf", cs.dt_Qe_surf, "q_surf_tot", True, ne)
        ch("eleqrsub", cs.dt_Qe_rsub, "q_e2r_sub", True, ne)
        ch("eleqrsurf", cs.dt_Qe_rsurf, "q_e2r_surf", True, ne)
        ch("elevinfil", cs.dt_qe_infil, "q_infil", True, ne)
        ch("elevexfil", cs.dt_qe_infil, "q_exfil", True, ne)
        ch("elevetic", cs.dt_qe_et, "e_ic", True, ne)
        ch("elevettr", cs.dt_qe_et, "trans", True, ne)
        ch("elevetev", cs.dt_qe_et, "evapo", True, ne)
        ch("rn_h", cs.dt_qe_et, "rn_h", False, ne)
        ch("rn_t", cs.dt_qe_et, "rn_t", False, ne)
        ch("rn_factor", cs.dt_qe_et, "rn_factor", False, ne)
        # rivers
        ch("rivqup", cs.dt_Qr_up, "q_riv_up", True, nr)
        ch("rivqdown", cs.dt_Qr_down, "q_riv_down", True, nr)
        ch("rivqsub", cs.dt_Qr_sub, "q_riv_sub", True, nr)
        ch("rivqsurf", cs.dt_Qr_surf, "q_riv_surf", True, nr)
        ch("rivystage", cs.dt_yr_stage, "y_riv", False, nr)
        # lakes
        if nl > 0:
            ch("lakystage", cs.dt_lake, "y_lake", False, nl)
            ch("lakatop", cs.dt_lake, "lake_area", False, nl)
            ch("lakvevap", cs.dt_lake, "q_lake_evap", True, nl)
            ch("lakvprcp", cs.dt_lake, "q_lake_prcp", True, nl)
            ch("lakqrivin", cs.dt_lake, "q_lake_rivin", True, nl)
            # zeros channel for reference file-set parity (dead
            # accumulation in the reference, MD_update.cpp:184; IO.cpp:177)
            ch("lakqrivout", cs.dt_lake, "q_lake_rivout", True, nl)
            ch("lakqsurf", cs.dt_lake, "q_lake_surf", True, nl)
            ch("lakqsub", cs.dt_lake, "q_lake_sub", True, nl)

    def push(self, t: float, values: dict):
        for pc, key in self.channels:
            pc.push(t, values[key])

    def close(self):
        for pc, _ in self.channels:
            pc.close()


def collect_values(sim: Simulation, fs, cf, diag) -> dict:
    """Assemble the live-value dict the reference's channels point into, on
    the host; returns (values, state)."""
    ne, nr, nl = sim.md.num_ele, sim.md.num_riv, sim.md.num_lake
    h = _to_host({
        "y": sim.bdf.y, "ic": sim.buckets.ic_stg, "snow": sim.buckets.snow,
        "prcp": fs.prcp, "net_prcp": fs.net_prcp, "etp": cf.etp,
        "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor,
        "diag": diag,
    })
    y = h["y"]
    vals = {
        "y_ic": h["ic"],
        "y_snow": h["snow"],
        "y_surf": y[:ne],
        "y_unsat": y[ne : 2 * ne],
        "y_gw": y[2 * ne : 3 * ne],
        "y_riv": y[3 * ne : 3 * ne + nr],
        "prcp": h["prcp"],
        "net_prcp": h["net_prcp"],
        "etp": h["etp"],
        "rn_h": h["rn_h"],
        "rn_t": h["rn_t"],
        "rn_factor": h["rn_factor"],
    }
    d = h["diag"]
    es, eu, eg, tu, tg = d["es"], d["eu"], d["eg"], d["tu"], d["tg"]
    e_ic = d["e_ic"]
    vals.update(
        q_rech=d["q_rech"], q_sub_tot=d["q_sub_tot"],
        q_surf_tot=d["q_surf_tot"], q_e2r_sub=d["q_e2r_sub"],
        q_e2r_surf=d["q_e2r_surf"], q_infil=d["q_infil"],
        q_exfil=d["q_exfil"], e_ic=e_ic, trans=tu + tg,
        evapo=es + eu + eg, eta=e_ic + es + eu + eg + tu + tg,
        q_riv_up=d["q_riv_up"], q_riv_down=d["q_riv_down"],
        q_riv_sub=d["q_riv_sub"], q_riv_surf=d["q_riv_surf"],
    )
    if nl > 0:
        vals.update(
            y_lake=y[3 * ne + nr :], lake_area=d["lake_area"],
            q_lake_evap=d["q_lake_evap"], q_lake_prcp=d["q_lake_prcp"],
            q_lake_rivin=d["q_lake_rivin"], q_lake_surf=d["q_lake_surf"],
            q_lake_sub=d["q_lake_sub"],
            q_lake_rivout=np.zeros(nl),
        )
    return vals, y


def run_project(
    project: str,
    base: str = ".",
    end_day: float | None = None,
    verbose: bool = True,
    dummy: bool = False,
    outpath: str | None = None,
    device: "str | torch.device" = "cuda",
    **overrides,
):
    """Run a full simulation — equivalent of ``./shud <project>`` — on
    *device* (the card unless the caller asks for the CPU).  Returns the
    ``Simulation`` at the end of the run."""
    if end_day is not None:
        overrides.setdefault("day_end", end_day)
    sim = Simulation.create(project, base=base, device=device, dummy=dummy,
                            **overrides)
    if outpath:
        sim.inp.paths.outpath = outpath
    cs = sim.inp.control
    paths = sim.inp.paths
    md = sim.md
    t_end = cs.end_time if end_day is None else end_day * 1440.0
    out = OutputManager(sim)
    flood = FloodAlert(
        os.path.join(paths.outpath, f"{paths.project}.flood.csv"),
        md.riv_depth,
    )
    tlog = TimeLog(os.path.join(paths.outpath, f"{paths.project}.time.csv"))
    from shud_tpu_torch.io.project import write_calib

    write_calib(sim.inp.calib,
                os.path.join(paths.outpath, f"{paths.project}.cfg.calib.bak"))
    paths.save_project_file()  # <prj>.SHUD provenance manifest
    if os.environ.get("SHUD_DEBUG_TABLES", "0") not in ("0", ""):
        from shud_tpu_torch.io.debugtables import write_debug_tables

        write_debug_tables(md, sim.inp, paths.outpath)

    ne, nr = md.num_ele, md.num_riv
    host = _to_host({"y": sim.bdf.y, "ic": sim.buckets.ic_stg,
                     "snow": sim.buckets.snow})
    y0 = host["y"]
    write_restart(
        os.path.join(paths.outpath, f"{paths.project}.cfg.ic.bak"), 0.0,
        host["ic"], host["snow"],
        y0[:ne], y0[ne : 2 * ne], y0[2 * ne : 3 * ne],
        y0[3 * ne : 3 * ne + nr],
        y0[3 * ne + nr :] if md.num_lake else None,
    )

    wall0 = time.time()
    cpu0 = time.process_time()
    last_nfe = 0
    next_screen = sim.t
    step = cs.solver_step
    nwin = 0
    while sim.t < t_end - 1e-9:
        tout = min(sim.t + step, t_end)
        if not dummy:
            fs, cf = sim.advance_window(tout)
            diag = sim.diagnostics(fs)
            vals, y = collect_values(sim, fs, cf, diag)
            out.push(sim.t, vals)
            flood.check(sim.t, y[3 * ne : 3 * ne + nr],
                        vals["q_riv_down"])
        else:
            sim.t = tout
            y = y0
        nwin += 1
        if sim.t >= next_screen:
            nfe = int(sim.bdf.nfe)
            perc = 100.0 * (sim.t - cs.start_time) / (t_end - cs.start_time)
            if verbose:
                print(
                    f"{sim.t/1440.0:8.2f} day\t{perc:6.2f}%\t"
                    f"{time.process_time()-cpu0:8.2f} s\t"
                    f"{time.time()-wall0:8.2f} s\t{nfe - last_nfe}"
                )
            tlog.write(sim.t, perc, time.process_time() - cpu0,
                       time.time() - wall0, nfe - last_nfe)
            last_nfe = nfe
            next_screen += cs.screen_intv
        # restart snapshot every UpdateICStep minutes (y from the batched
        # per-window fetch above)
        if not dummy and int(sim.t) % cs.update_ic_step == 0:
            write_restart(
                os.path.join(paths.outpath,
                             f"{paths.project}.cfg.ic.update"),
                sim.t,
                vals["y_ic"], vals["y_snow"],
                y[:ne], y[ne : 2 * ne], y[2 * ne : 3 * ne],
                y[3 * ne : 3 * ne + nr],
                y[3 * ne + nr :] if md.num_lake else None,
            )

    out.close()
    flood.close()
    tlog.close()
    if verbose:
        print(f"\nNumber of RHS calls: {int(sim.bdf.nfe)}")
        print(f"Time used by model: {time.time()-wall0:.3f} seconds.")
    return sim
