# Copied verbatim from shud_tpu/analysis.py; only the package imports and the
# docstring example's input path differ.
"""Post-processing / analysis toolkit (the rSHUD / `rAnalysis/*.R` layer).

The reference ships R scripts (`rAnalysis/ccw.R`) built on the rSHUD
package: ``shud.env`` → ``readout('rivqdown')`` → outlet hydrograph vs the
``.tsd.obs`` gauge, plus ``wb.all`` basin water-balance summaries
(SURVEY.md §1 L7).  This module provides the Python-native equivalent over
the same binary ``.dat`` outputs, so a full simulate→analyse workflow needs
no R.

Typical use::

    from shud_tpu_torch.analysis import Run
    run = Run("ccw", inpath="input/ccw",
              outpath="output/ccw.out")
    t, q = run.readout("rivqdown")           # [K], [K, Nriv] per-day means
    sim, obs, t_d = run.outlet_vs_obs()      # aligned daily series
    print(run.nse())                          # Nash-Sutcliffe efficiency
    print(run.water_balance())                # P/ET/Q/dS table [m/day]
"""

from __future__ import annotations

import glob
import os

import numpy as np

from shud_tpu_torch.io.output import read_dat


def ts2daily(t_min: np.ndarray, v: np.ndarray):
    """Aggregate a (t [minutes], values) series to daily means
    (rSHUD ``ts2Daily``)."""
    days = np.floor(t_min / 1440.0).astype(np.int64)
    uniq = np.unique(days)
    out = np.empty((len(uniq),) + v.shape[1:], dtype=np.float64)
    for k, d in enumerate(uniq):
        out[k] = v[days == d].mean(axis=0)
    return uniq.astype(np.float64), out


def nse(sim: np.ndarray, obs: np.ndarray) -> float:
    """Nash–Sutcliffe efficiency."""
    obs = np.asarray(obs, dtype=np.float64)
    sim = np.asarray(sim, dtype=np.float64)
    m = np.isfinite(obs) & np.isfinite(sim)
    o = obs[m]
    s = sim[m]
    denom = np.sum((o - o.mean()) ** 2)
    if denom == 0:
        return -np.inf
    return 1.0 - float(np.sum((s - o) ** 2) / denom)


class Run:
    """One simulated project: paths + lazy readers (rSHUD ``shud.env``)."""

    def __init__(self, project: str, inpath: str, outpath: str):
        self.project = project
        self.inpath = inpath
        self.outpath = outpath
        self._mesh = None

    # -- raw output access ------------------------------------------------
    def _dat(self, var: str) -> str:
        pat = os.path.join(self.outpath, f"{self.project}.{var}.dat")
        hits = glob.glob(pat)
        if not hits:
            raise FileNotFoundError(pat)
        return hits[0]

    def readout(self, var: str):
        """(t_minutes[K], values[K, nvar]) of one output channel
        (rSHUD ``readout``)."""
        start, ids, t, v = read_dat(self._dat(var))
        return t, v

    # -- mesh-derived helpers --------------------------------------------
    @property
    def mesh(self):
        if self._mesh is None:
            from shud_tpu_torch.core.mesh import build_mesh
            from shud_tpu_torch.io.project import load_project

            base = os.path.dirname(os.path.dirname(self.inpath.rstrip("/")))
            inp = load_project(self.project, base=base)
            self._mesh = (inp, build_mesh(inp))
        return self._mesh

    def area(self) -> float:
        """Basin area [m^2] (rSHUD ``getArea``)."""
        return float(self.mesh[1].watershed_area)

    def outlets(self) -> np.ndarray:
        """0-based outlet reach indices (rSHUD ``getOutlets``):
        reaches with a negative downstream code."""
        md = self.mesh[1]
        return np.where(np.asarray(md.riv_down) < 0)[0]

    # -- gauge comparison -------------------------------------------------
    def obs(self):
        """(t_minutes, q) from ``<prj>.tsd.obs`` (first column)."""
        from shud_tpu_torch.io.project import read_tsd_csv

        path = os.path.join(self.inpath, f"{self.project}.tsd.obs")
        _, t_min, data = read_tsd_csv(path)
        return t_min, data[:, 0]

    def outlet_vs_obs(self):
        """Aligned daily (sim, obs, t_days) discharge at the first outlet.

        Simulated ``rivqdown`` is written as interval means in m³/day
        (PrintCtrl flux scaling); observations are as stored in the gauge
        file.  Mirrors the ccw.R workflow (align on common days).
        """
        t_s, q = self.readout("rivqdown")
        oid = self.outlets()[0]
        td_s, q_d = ts2daily(t_s, np.abs(q[:, oid]))
        t_o, qo = self.obs()
        td_o, qo_d = ts2daily(t_o, qo[:, None])
        common, ia, ib = np.intersect1d(td_s, td_o, return_indices=True)
        return q_d[ia], qo_d[ib, 0], common

    def nse(self) -> float:
        sim, obs, _ = self.outlet_vs_obs()
        return nse(sim, obs)

    # -- water balance ----------------------------------------------------
    def water_balance(self):
        """Basin-mean daily budget [m/day]: P, AET, outlet Q/A, dStorage
        (rSHUD ``wb.all``).  Returns a dict of aligned daily arrays."""
        md = self.mesh[1]
        a_cell = np.asarray(md.area)
        a_tot = a_cell.sum()
        w = a_cell / a_tot

        def cellmean(var):
            # weight by the areas of the cells actually present in the file
            # (cfg.output masks may select a subset; ids are 1-based)
            _, ids, t, v = read_dat(self._dat(var))
            a_sel = a_cell[np.asarray(ids) - 1]
            return ts2daily(t, v @ (a_sel / a_sel.sum()))

        out = {}
        t_ref = None
        for key, var in (("prcp", "elevprcp"), ("aet", "eleveta")):
            try:
                t, v = cellmean(var)
                out[key] = v
                t_ref = t
            except FileNotFoundError:
                pass
        try:
            t_q, q = self.readout("rivqdown")
            oid = self.outlets()
            td, qd = ts2daily(t_q, np.abs(q[:, oid]).sum(axis=1))
            out["q_out"] = qd / a_tot  # m3/day -> m/day
            t_ref = td if t_ref is None else t_ref
        except FileNotFoundError:
            pass
        # storage change from state channels (interval means of stages)
        try:
            t1, ysf = cellmean("eleysurf")
            _, yus = cellmean("eleyunsat")
            _, ygw = cellmean("eleygw")
            md_inp = self.mesh[1]
            sy = float((np.asarray(md_inp.sy) * w).sum())
            stor = ysf + yus * sy + ygw * sy
            ds = np.diff(stor, prepend=stor[0])
            out["d_storage"] = ds
        except FileNotFoundError:
            pass
        out["t_day"] = t_ref
        return out
