"""Forcing runtime: dense step-function arrays + per-window slice assembly.

The counterpart of ``shud_tpu/driver/forcing.py``: the tables stay numpy on
the host; the calibration scalars are float64 tensors, cast to the run's
dtype and device by ``FusedSimulation.create``.

The reference streams CSV rows through a ring buffer with step-function
semantics (``TimeSeriesData::getX/movePointer``); here all series are dense
host arrays indexed by ``searchsorted`` — identical step semantics
(current-interval value, no interpolation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shud_tpu_torch.core import solar
from shud_tpu_torch.core.landsurface import CalibScalars
from shud_tpu_torch.core.mesh import MeshData
from shud_tpu_torch.io.project import ProjectInput


@dataclasses.dataclass
class ForcingRuntime:
    # station forcing, one merged time axis per station set
    t_axis: np.ndarray  # [K] interval start times (station 0's axis)
    fvals: np.ndarray  # [K, S, 5]
    station_z: np.ndarray  # [S]
    lai_t: np.ndarray
    lai_vals: np.ndarray  # [Kl, C]
    mf_t: np.ndarray
    mf_vals: np.ndarray
    cal: CalibScalars
    # TSR per-interval solar samples
    tsr_sx: np.ndarray  # [K, n]
    tsr_sy: np.ndarray
    tsr_sz: np.ndarray
    tsr_wdt: np.ndarray
    tsr_den: np.ndarray  # [K]
    terrain_radiation: bool
    swnet_mode: bool
    rad_factor_cap: float
    rad_cosz_min: float
    et_mode: int = 0  # 0 PM | 1 Hargreaves | 2 Priestley-Taylor
    # boundary conditions (optional)
    bc: dict = dataclasses.field(default_factory=dict)

    def interval_index(self, t: float) -> int:
        return int(np.searchsorted(self.t_axis, t + 1e-9, side="right") - 1)

    def station_values(self, t: float) -> np.ndarray:
        return self.fvals[self.interval_index(t)]

    def lai_at(self, t: float) -> np.ndarray:
        return self.lai_vals[
            int(np.searchsorted(self.lai_t, t + 1e-9, side="right") - 1)
        ]

    def mf_at(self, t: float) -> np.ndarray:
        return self.mf_vals[
            int(np.searchsorted(self.mf_t, t + 1e-9, side="right") - 1)
        ]

    def tsr_sample(self, t: float):
        ki = self.interval_index(t)
        return (
            self.tsr_sx[ki], self.tsr_sy[ki], self.tsr_sz[ki],
            self.tsr_wdt[ki], self.tsr_den[ki],
        )

    def bc_values(self, md: MeshData, t: float):
        """Resolve per-entity BC/SS values at time t (step semantics),
        mirroring ``f_update``'s TSD lookups (MD_update.cpp:110-168)."""
        ne, nr = md.num_ele, md.num_riv
        out = {
            "ele_ybc": np.zeros(ne), "ele_qbc": np.zeros(ne),
            "ele_qss": np.zeros(ne),
            "riv_ybc": np.zeros(nr), "riv_qbc": np.zeros(nr),
        }

        def lookup(key):
            ts, vals = self.bc[key]
            k = int(np.searchsorted(ts, t + 1e-9, side="right") - 1)
            return vals[max(k, 0)]

        if "ele_y" in self.bc:
            row = lookup("ele_y")
            sel = md.i_bc > 0
            out["ele_ybc"][sel] = row[md.i_bc[sel] - 1]
        if "ele_q" in self.bc:
            row = lookup("ele_q")
            sel = md.i_bc < 0
            out["ele_qbc"][sel] = row[-md.i_bc[sel] - 1]
        if "ele_ss" in self.bc:
            row = lookup("ele_ss")
            sel = md.i_ss != 0
            out["ele_qss"][sel] = row[np.abs(md.i_ss[sel]) - 1]
        if "riv_y" in self.bc:
            row = lookup("riv_y")
            sel = md.riv_bc > 0
            out["riv_ybc"][sel] = row[md.riv_bc[sel] - 1]
        if "riv_q" in self.bc:
            row = lookup("riv_q")
            sel = md.riv_bc < 0
            out["riv_qbc"][sel] = row[-md.riv_bc[sel] - 1]
        return out


def rebuild_cal(fr: ForcingRuntime, calib) -> ForcingRuntime:
    """Copy of *fr* with the calibration scalars rebuilt from *calib*.

    The expensive parts of a ForcingRuntime (merged station tables, TSR
    solar-sample precompute over the whole forcing axis) do not depend on
    calibration — autocalibration loops reuse them across candidates and
    only swap the scalars (shud_tpu_torch/tools/autocalibrate.py)."""
    return dataclasses.replace(fr, cal=calib_scalars(calib))


def calib_scalars(calib) -> CalibScalars:
    """The forcing-transform calibration scalars as float64 0-d tensors."""
    def t(v):
        return torch.tensor(float(v), dtype=torch.float64)

    return CalibScalars(
        c_prcp=t(calib.ts_prcp), c_temp=t(calib.ts_sfctmp_add),
        c_lai=t(calib.ts_lai), c_mf=t(calib.ts_mf), c_etp=t(calib.et_etp),
        c_ismax=t(calib.lc_ismax),
    )


def build_forcing(inp: ProjectInput, md: MeshData) -> ForcingRuntime:
    cs = inp.control
    # merge stations onto station-0's time axis (the usual case is a shared
    # axis; per-station step lookup falls back to searchsorted per station)
    t_axis = inp.forc.t_min[0]
    k = len(t_axis)
    s = inp.forc.num_stations
    fvals = np.zeros((k, s, 5))
    for j in range(s):
        tj = inp.forc.t_min[j]
        if len(tj) == k and np.array_equal(tj, t_axis):
            fvals[:, j, :] = inp.forc.data[j][:, :5]
        else:
            idx = np.clip(
                np.searchsorted(tj, t_axis + 1e-9, side="right") - 1, 0, None
            )
            fvals[:, j, :] = inp.forc.data[j][idx, :5]

    if cs.et_mode == 1:
        # Hargreaves needs daily station Tmax/Tmin and extraterrestrial
        # radiation H0: append them as forcing columns 5-7 (one value per
        # forcing interval, constant within each civil day)
        from shud_tpu_torch.utils.timectx import TimeContext

        tc = TimeContext(inp.forc.start_yyyymmdd)
        day = np.floor(t_axis / 1440.0).astype(np.int64)
        udays, dinv = np.unique(day, return_inverse=True)
        ext = np.zeros((k, s, 3))
        lat_rad = np.deg2rad(np.asarray(inp.forc.lat, dtype=np.float64))
        for di, d in enumerate(udays):
            rows = dinv == di
            tmax = fvals[rows, :, 1].max(axis=0)
            tmin = fvals[rows, :, 1].min(axis=0)
            doy = tc.day_of_year(float(d) * 1440.0)
            b = 2.0 * np.pi / 365.0 * doy
            dr = 1.0 + 0.033 * np.cos(b)
            decl = 0.409 * np.sin(b - 1.39)
            ws = np.arccos(np.clip(-np.tan(lat_rad) * np.tan(decl), -1, 1))
            h0 = (24.0 * 60.0 / np.pi) * 0.0820 * dr * (
                ws * np.sin(lat_rad) * np.sin(decl)
                + np.cos(lat_rad) * np.cos(decl) * np.sin(ws)
            )  # FAO-56 eq 21 [MJ/m2/day]
            ext[rows, :, 0] = tmax
            ext[rows, :, 1] = tmin
            ext[rows, :, 2] = h0
        fvals = np.concatenate([fvals, ext], axis=2)

    cal = calib_scalars(inp.calib)

    # solar lon/lat selection (read_forc_csv, MD_readin.cpp:645-717)
    if cs.solar_lonlat_mode == 2:
        lon, lat = cs.solar_lon_deg_fixed, cs.solar_lat_deg_fixed
    elif cs.solar_lonlat_mode == 1:
        lon, lat = float(np.mean(inp.forc.lon)), float(np.mean(inp.forc.lat))
    else:
        lon, lat = float(inp.forc.lon[0]), float(inp.forc.lat[0])
    cs.solar_lon_deg, cs.solar_lat_deg = lon, lat

    t1 = np.concatenate(
        [t_axis[1:], [t_axis[-1] + (t_axis[-1] - t_axis[-2])]]
    ) if k > 1 else t_axis + cs.solver_step
    if cs.terrain_radiation:
        sx, sy, sz, wdt, den = solar.interval_samples(
            t_axis, t1, cs.tsr_integration_step_min, lat, lon,
            inp.forc.start_yyyymmdd,
        )
    else:
        sx = sy = sz = wdt = np.zeros((k, 1))
        den = np.zeros(k)

    bc = {}
    for key, pair in inp.bc.items():
        bc[key] = (pair[0], pair[1])

    return ForcingRuntime(
        t_axis=t_axis, fvals=fvals,
        station_z=np.asarray(inp.forc.xyz[:, 2]),
        lai_t=inp.lai_t, lai_vals=inp.lai, mf_t=inp.mf_t, mf_vals=inp.mf,
        cal=cal, tsr_sx=sx, tsr_sy=sy, tsr_sz=sz, tsr_wdt=wdt, tsr_den=den,
        terrain_radiation=bool(cs.terrain_radiation),
        swnet_mode=(cs.radiation_input_mode == 1),
        rad_factor_cap=cs.rad_factor_cap, rad_cosz_min=cs.rad_cosz_min,
        et_mode=int(cs.et_mode), bc=bc,
    )
