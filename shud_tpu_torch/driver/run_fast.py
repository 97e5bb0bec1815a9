"""Production run path: fused driver + full output stack.

The counterpart of ``shud_tpu/driver/run_fast.py``: the same output files
(channels, restart, flood, time log, water balance, checkpoint), written one
output interval at a time from the fused driver's interval means.
Interval-mean channel semantics are identical to the reference's
Print_Ctrl accumulation (mean of per-window samples x tau).
"""

from __future__ import annotations

import math
import os
import struct
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from shud_tpu_torch import trace
from shud_tpu_torch.driver.fused import FusedSimulation
from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from shud_tpu_torch.io.output import (
    FloodAlert, PrintCtrl, TimeLog, write_restart)
from shud_tpu_torch.utils.errors import NanError


class IntervalWriter:
    """Binds fused-interval means to Print_Ctrl-format files, mirrored into
    CF/UGRID NetCDF-4 files (``.ele.nc``, ``.riv.nc``, ``.lak.nc``) under
    ``OUTPUT_MODE NETCDF|BOTH`` (NETCDF alone turns the binary files
    off).

    ``io_enabled=False`` runs the whole channel registration (so the output
    ``interval`` is the same) but opens no file: the ranks other than 0 of
    a sharded run (``parallel/runtime.py``), whose files rank 0 writes."""

    def __init__(self, sim: FusedSimulation, io_enabled: bool = True):
        cs = sim.inp.control
        paths = sim.inp.paths
        md = sim.md
        self.io_enabled = io_enabled
        netcdf = cs.output_mode in ("NETCDF", "BOTH")
        if netcdf:
            try:
                import h5py  # noqa: F401
            except ImportError as e:
                # refused here, before any solve, not at the first write
                raise RuntimeError(
                    f"OUTPUT_MODE {cs.output_mode} writes NetCDF-4 through "
                    "h5py, which is not installed; use OUTPUT_MODE LEGACY"
                ) from e
        if io_enabled:
            os.makedirs(paths.outpath, exist_ok=True)
        start = sim.inp.forc.start_yyyymmdd
        b, a = bool(cs.binary), bool(cs.ascii)
        self.channels = []
        self.interval = None
        from shud_tpu_torch.io.validate import read_output_masks

        masks = read_output_masks(sim.inp, md.num_ele, md.num_riv,
                                  md.num_lake)

        def ch(name, dt, key, is_flux, n, riv=False):
            if dt > 0:
                if self.interval is None:
                    self.interval = dt
                elif dt != self.interval:
                    raise ValueError(
                        "fused run path requires equal output intervals; "
                        f"{name} has {dt} != {self.interval} "
                        "(use the per-window driver instead)"
                    )
                if not io_enabled:
                    return
                mk = "lake" if riv == "lake" else ("riv" if riv else "ele")
                sel = np.where(masks[mk])[0]
                pc = PrintCtrl(
                    os.path.join(paths.outpath, f"{paths.project}.{name}"),
                    start, dt, is_flux, n, selected=sel, binary=b, ascii_=a,
                )
                self.channels.append((pc, key, is_flux, riv))

        self.nc = self.nc_riv = self.nc_lake = None
        if netcdf and io_enabled:
            from shud_tpu_torch.io.ncoutput import (
                UgridSink, read_ncoutput_cfg)

            nccfg = read_ncoutput_cfg(
                os.path.join(paths.inpath, cs.ncoutput_cfg)
                if cs.ncoutput_cfg and not os.path.isabs(cs.ncoutput_cfg)
                else cs.ncoutput_cfg)
            crs_wkt = nccfg.get("CRS_WKT_TEXT", "")
            self.nc = UgridSink(
                os.path.join(paths.outpath, f"{paths.project}.ele.nc"),
                md, "ele", sim.inp.nodes[:, 1:4], sim.inp.tri[:, 1:4],
                start, crs_wkt=crs_wkt,
            )
            self.nc_riv = UgridSink(
                os.path.join(paths.outpath, f"{paths.project}.riv.nc"),
                md, "riv", start_yyyymmdd=start, crs_wkt=crs_wkt,
            )
            if md.num_lake > 0:
                self.nc_lake = UgridSink(
                    os.path.join(paths.outpath, f"{paths.project}.lak.nc"),
                    md, "lake", start_yyyymmdd=start, crs_wkt=crs_wkt,
                )
            if cs.output_mode == "NETCDF":
                b = False  # the binary writers off in pure-NETCDF mode
        ne, nr = md.num_ele, md.num_riv
        ch("eleyic", cs.dt_ye_ic, "y_ic", False, ne)
        ch("eleysnow", cs.dt_ye_snow, "y_snow", False, ne)
        ch("eleysurf", cs.dt_ye_surf, "y_surf", False, ne)
        ch("eleyunsat", cs.dt_ye_unsat, "y_unsat", False, ne)
        ch("eleygw", cs.dt_ye_gw, "y_gw", False, ne)
        ch("elevprcp", cs.dt_qe_prcp, "prcp", True, ne)
        ch("elevnetprcp", cs.dt_qe_prcp, "net_prcp", True, ne)
        ch("elevetp", cs.dt_qe_etp, "etp", True, ne)
        ch("eleveta", cs.dt_qe_eta, "eta", True, ne)
        ch("elevrech", cs.dt_qe_rech, "q_rech", True, ne)
        ch("eleqsub", cs.dt_Qe_sub, "q_sub_tot", True, ne)
        ch("eleqsurf", cs.dt_Qe_surf, "q_surf_tot", True, ne)
        ch("eleqrsub", cs.dt_Qe_rsub, "q_e2r_sub", True, ne)
        ch("eleqrsurf", cs.dt_Qe_rsurf, "q_e2r_surf", True, ne)
        # per-edge flux channels (reference registers them at the dt_Qe_sub
        # / dt_Qe_surf interval, MD_initialize.cpp:283-296; fall back to
        # the *x key when the total-channel interval is off)
        if cs.dt_Qe_subx > 0:
            dtx = cs.dt_Qe_sub or cs.dt_Qe_subx
            for j in range(3):
                ch(f"eleqsub{j + 1}", dtx, f"q_esub{j}", True, ne)
        if cs.dt_Qe_surfx > 0:
            dtx = cs.dt_Qe_surf or cs.dt_Qe_surfx
            for j in range(3):
                ch(f"eleqsurf{j + 1}", dtx, f"q_esurf{j}", True, ne)
        ch("elevinfil", cs.dt_qe_infil, "q_infil", True, ne)
        ch("elevexfil", cs.dt_qe_infil, "q_exfil", True, ne)
        ch("elevetic", cs.dt_qe_et, "e_ic", True, ne)
        ch("elevettr", cs.dt_qe_et, "trans", True, ne)
        ch("elevetev", cs.dt_qe_et, "evapo", True, ne)
        ch("rn_h", cs.dt_qe_et, "rn_h", False, ne)
        ch("rn_t", cs.dt_qe_et, "rn_t", False, ne)
        ch("rn_factor", cs.dt_qe_et, "rn_factor", False, ne)
        ch("rivqup", cs.dt_Qr_up, "q_riv_up", True, nr, riv=True)
        ch("rivqdown", cs.dt_Qr_down, "q_riv_down", True, nr, riv=True)
        ch("rivqsub", cs.dt_Qr_sub, "q_riv_sub", True, nr, riv=True)
        ch("rivqsurf", cs.dt_Qr_surf, "q_riv_surf", True, nr, riv=True)
        ch("rivystage", cs.dt_yr_stage, "y_riv", False, nr, riv=True)
        nl = md.num_lake
        if nl > 0:
            ch("lakystage", cs.dt_lake, "y_lake", False, nl, riv="lake")
            ch("lakatop", cs.dt_lake, "lake_area", False, nl, riv="lake")
            ch("lakvevap", cs.dt_lake, "q_lake_evap", True, nl, riv="lake")
            ch("lakvprcp", cs.dt_lake, "q_lake_prcp", True, nl, riv="lake")
            ch("lakqrivin", cs.dt_lake, "q_lake_rivin", True, nl, riv="lake")
            # registered by the reference (MD_initialize.cpp:339) but never
            # accumulated: identically zero, emitted for file-set parity
            ch("lakqrivout", cs.dt_lake, "q_lake_rivout", True, nl,
               riv="lake")
            ch("lakqsurf", cs.dt_lake, "q_lake_surf", True, nl, riv="lake")
            ch("lakqsub", cs.dt_lake, "q_lake_sub", True, nl, riv="lake")
        if self.nc is not None:
            for _pc, key, _fx, riv in self.channels:
                sink = self._sink(riv)
                if sink is not None and key not in sink.vars:
                    sink.add_channel(key)
        if self.interval is None:
            self.interval = 1440

    def _sink(self, riv):
        """The NetCDF sink of a channel's entity kind."""
        if riv == "lake":
            return self.nc_lake
        return self.nc_riv if riv else self.nc

    def write(self, t_end: float, mean_e: dict, mean_r: dict,
              mean_l: dict | None = None):
        """Append one interval; the means are host (numpy) arrays."""
        for pc, key, is_flux, riv in self.channels:
            if riv == "lake":
                vals = mean_l[key]
            elif riv:
                vals = mean_r[key]
            else:
                vals = mean_e[key]
            out = np.asarray(vals)[pc.selected] * pc.tau
            t_q = float(int(math.floor(t_end + 0.001)) - pc.interval)
            if pc.fb is not None:
                pc.fb.write(struct.pack("<d", t_q))
                pc.fb.write(out.astype(np.float64).tobytes())
            if pc.fa is not None:
                pc.fa.write(
                    f"{t_q:.1f}\t" + "\t".join(f"{v:e}" for v in out) + "\t\n"
                )
            if self.nc is not None:
                sink = self._sink(riv)
                if sink is not None:
                    sink.write(key, t_q, np.asarray(vals) * pc.tau)

    def close(self):
        for pc, *_ in self.channels:
            pc.close()
        for sink in (self.nc, self.nc_riv, self.nc_lake):
            if sink is not None:
                sink.close()


@trace.spanned("shud.fetch")
def _to_host(tree):
    """Tensors (in dicts, to any depth) -> numpy, other leaves unchanged:
    the tensors of one dtype and device packed into one buffer and fetched
    in one transfer (one host sync), as JAX's ``jax.device_get`` fetches
    the tree at once.  States the tensors' bytes as the counter
    ``shud.fetch.bytes``."""
    leaves, spec = pytree.tree_flatten(tree)
    groups = {}
    nbytes = 0
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.dtype, x.device), []).append(i)
            nbytes += x.numel() * x.element_size()
    trace.count("shud.fetch.bytes", nbytes)
    for idx in groups.values():
        parts = [leaves[i].detach() for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        off = 0
        for i, p in zip(idx, parts):
            leaves[i] = flat[off:off + p.numel()].reshape(p.shape)
            off += p.numel()
    return pytree.tree_unflatten(leaves, spec)


def run_project_fast(project: str, base: str = ".", end_day=None,
                     float_dtype: torch.dtype = torch.float64, verbose=True,
                     outpath=None, resume=None, inp=None,
                     device: "str | torch.device" = "cuda",
                     mega: "bool | str" = "auto",
                     solver_kernel: bool = True, **overrides):
    """Run a project through the fused driver, writing the full output set.
    Returns the ``FusedSimulation`` at the end of the run.  Runs on the
    card unless *device* says otherwise; ``mega`` and ``solver_kernel`` as
    in ``FusedSimulation.create``."""
    if end_day is not None:
        overrides.setdefault("day_end", end_day)
    sim = FusedSimulation.create(project, base=base, float_dtype=float_dtype,
                                 inp=inp, device=device, mega=mega,
                                 solver_kernel=solver_kernel, **overrides)
    if outpath:
        sim.inp.paths.outpath = outpath
    if resume:
        load_checkpoint(resume, sim)
        if verbose:
            print(f"resumed from {resume} at t={sim.t/1440.0:.2f} days")
    cs = sim.inp.control
    paths = sim.inp.paths
    md = sim.md
    ne, nr = md.num_ele, md.num_riv
    t_end = cs.end_time if end_day is None else end_day * 1440.0
    writer = IntervalWriter(sim)
    interval = writer.interval
    flood = FloodAlert(
        os.path.join(paths.outpath, f"{paths.project}.flood.csv"),
        md.riv_depth,
    )
    tlog = TimeLog(os.path.join(paths.outpath, f"{paths.project}.time.csv"))
    from shud_tpu_torch.diag.waterbalance import WaterBalance
    from shud_tpu_torch.io.project import write_calib

    wb = WaterBalance(
        md, os.path.join(paths.outpath, f"{paths.project}.wb.basin.csv")
    )
    # per-element residual channel, opt-in like the reference's
    # SHUD_WB_DIAG=1 (WaterBalanceDiag.cpp:258-370)
    wb_ele = None
    if os.environ.get("SHUD_WB_DIAG", "0") not in ("0", ""):
        wb_ele = PrintCtrl(
            os.path.join(paths.outpath, f"{paths.project}.elevwbres"),
            sim.inp.forc.start_yyyymmdd, int(interval), False, ne,
        )

    write_calib(sim.inp.calib,
                os.path.join(paths.outpath, f"{paths.project}.cfg.calib.bak"))
    paths.save_project_file()  # <prj>.SHUD provenance manifest
    if os.environ.get("SHUD_DEBUG_TABLES", "0") not in ("0", ""):
        from shud_tpu_torch.io.debugtables import write_debug_tables

        write_debug_tables(md, sim.inp, paths.outpath)

    def _fetch(s, extra=None):
        """Everything an interval's bookkeeping needs, on the host."""
        tree = {
            "y": s.y_dev(), "ic": s.buckets.ic_stg, "snow": s.buckets.snow,
            "quad": s.bdf.quad, "nfe": s.bdf.nfe,
        }
        if extra:
            tree.update(extra)
        return _to_host(tree)

    host = _fetch(sim)
    _y0 = host["y"]
    write_restart(
        os.path.join(paths.outpath, f"{paths.project}.cfg.ic.bak"), 0.0,
        host["ic"], host["snow"],
        _y0[:ne], _y0[ne:2*ne], _y0[2*ne:3*ne], _y0[3*ne:3*ne+nr],
        _y0[3*ne+nr:] if md.num_lake else None,
    )

    from shud_tpu_torch.utils.timectx import TimeContext

    tc = TimeContext(sim.inp.forc.start_yyyymmdd)
    wall0 = time.time()
    cpu0 = time.process_time()
    last_nfe = int(host["nfe"])  # nonzero after --resume
    win = cs.solver_step
    while sim.t < t_end - 1e-9:
        this_int = min(interval, t_end - sim.t)
        y0 = host["y"]
        bk0 = (host["ic"], host["snow"])
        quad0 = ({k: float(v) for k, v in host["quad"].items()}
                 if host["quad"] is not None else None)
        t0 = sim.t
        mean_e_d, mean_r_d, stages_d, qdowns_d = sim.advance_interval(
            this_int)
        host = _fetch(sim, extra={
            "mean_e": mean_e_d, "mean_r": mean_r_d,
            "mean_l": sim.last_mean_l, "stages": stages_d,
            "qdowns": qdowns_d,
        })
        mean_e = host["mean_e"]
        mean_r = host["mean_r"]
        mean_l = host["mean_l"]
        writer.write(sim.t, mean_e, mean_r, mean_l)
        stages = host["stages"]
        qdowns = host["qdowns"]
        nw = stages.shape[0]
        for w in range(nw):
            flood.check(t0 + (w + 1) * win, stages[w], qdowns[w])
        quad_kwargs = {}
        if quad0 is not None:
            q1 = {k: float(v) for k, v in host["quad"].items()}
            quad_kwargs = dict(
                et_m3=q1["et"] - quad0["et"],
                qout_m3=q1["qout"] - quad0["qout"],
                qedge_m3=q1["qedge"] - quad0["qedge"],
                qbc_m3=q1["qbc"] - quad0["qbc"],
                qss_m3=q1["qss"] - quad0["qss"],
                nc_m3=q1["nc"] - quad0["nc"],
                lake_p_m3=q1["lake_p"] - quad0["lake_p"],
                lake_e_m3=q1["lake_e"] - quad0["lake_e"],
            )
        wb.interval(t0, sim.t, y0, host["y"], mean_e, mean_r,
                    buckets0=bk0,
                    buckets1=(host["ic"], host["snow"]),
                    mean_lake=mean_l,
                    **quad_kwargs)
        if wb_ele is not None:
            wb_ele.push(sim.t, wb.element_residuals(
                t0, sim.t, y0, host["y"], mean_e))
        nfe = int(host["nfe"])
        perc = 100.0 * (sim.t - cs.start_time) / (t_end - cs.start_time)
        if verbose:
            print(f"{tc.iso(sim.t)}\t{sim.t/1440.0:8.2f} day\t{perc:6.2f}%\t"
                  f"{time.time()-wall0:8.2f} s\t{nfe - last_nfe}")
        tlog.write(sim.t, perc, time.process_time() - cpu0,
                   time.time() - wall0, nfe - last_nfe)
        last_nfe = nfe
        # restart snapshot (UpdateICStep-aligned; intervals are multiples)
        if int(sim.t) % cs.update_ic_step == 0 or sim.t >= t_end - 1e-9:
            y = host["y"]
            if not np.isfinite(y).all():
                bad = int(np.flatnonzero(~np.isfinite(y))[0])
                raise NanError(
                    f"non-finite state at t={sim.t:.1f} min (index {bad})"
                )
            write_restart(
                os.path.join(paths.outpath, f"{paths.project}.cfg.ic.update"),
                sim.t,
                host["ic"], host["snow"],
                y[:ne], y[ne:2*ne], y[2*ne:3*ne], y[3*ne:3*ne+nr],
                y[3*ne+nr:] if md.num_lake else None,
            )
            save_checkpoint(
                os.path.join(paths.outpath, f"{paths.project}.ckpt.npz"), sim
            )
    writer.close()
    flood.close()
    tlog.close()
    wb.close()
    if wb_ele is not None:
        wb_ele.close()
    if verbose:
        # final solver counters (the reference's PrintFinalStats,
        # cvode_config.cpp:33: nst/nfe/netf/ncfn)
        b = sim.bdf
        print(f"\nFinal stats: nsteps={int(b.nsteps)} nfe={int(b.nfe)} "
              f"netf={int(b.nfails)} ncfn={int(b.nnifails)}; wall "
              f"{time.time()-wall0:.1f} s")
    return sim
