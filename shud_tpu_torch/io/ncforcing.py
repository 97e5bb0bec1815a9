# Copied verbatim from shud_tpu/io/ncforcing.py; only the package imports differ.
"""NetCDF forcing provider: CMFD2 / ERA5 / GLDAS product adapters.

Python equivalent of the reference's largest component
(``src/classes/NetcdfForcingProvider.cpp``, 2.6k LoC): a key-value config
selects the product, file layout and variable names; per-station
nearest-grid-point series are extracted and converted to the model's five
forcing columns (precip mm/day, temp C, RH 0-1, wind m/s, SW W/m2) with the
exact unit rules and AutoSHUD-compatible quantisation of the reference:

* CMFD2 (monthly per-variable files): precip AUTO|KG_M2_S|MM_HR|MM_DAY,
  RH from specific humidity ``0.263 p q / exp(17.67 (T-273.15)/(T-29.65))``
  (NetcdfForcingProvider.cpp:1500);
* ERA5 (daily files): accumulated tp/ssr decoded to interval increments
  with reset tolerance, dewpoint -> RH via Magnus (cpp:2303-2312), wind
  from u10/v10;
* GLDAS (3-hourly per-step files): kg/m2/s precip, RH from q as CMFD.

Instead of the reference's per-timestep cache, the whole simulation period
is materialised into dense step-function arrays feeding the standard
forcing runtime (identical step semantics).
"""

from __future__ import annotations

import os

import numpy as np

from shud_tpu_torch.io.netcdf import (
    NcDataset,
    parse_time_units,
    resolve_single_glob,
    yyyymmdd_to_epoch_minutes,
)
from shud_tpu_torch.io.project import ForcingCSV


def read_kv_cfg(path: str) -> dict:
    kv = {}
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split(None, 1)
            if len(parts) == 2:
                kv[parts[0].upper()] = parts[1].strip()
            elif "=" in s:
                k, v = s.split("=", 1)
                kv[k.strip().upper()] = v.strip()
    return kv


def _quantise(prcp_mm_day, temp_c, rh, wind, rn):
    """AutoSHUD-compatible quantisation + clamps (cpp:1486-1546)."""
    prcp = np.round(np.nan_to_num(np.maximum(prcp_mm_day, 0.0)), 4)
    prcp = np.where(prcp < 0.0001, 0.0, prcp)
    temp = np.round(np.nan_to_num(temp_c), 2)
    rh = np.round(np.clip(np.nan_to_num(rh), 0.0, 1.0), 4)
    rh = np.clip(rh, 0.0, 1.0)
    wind = np.round(np.abs(np.nan_to_num(wind)), 2)
    wind = np.maximum(wind, 0.05)
    rn = np.round(np.maximum(np.nan_to_num(rn), 0.0))
    return prcp, temp, rh, wind, rn


def _rh_from_q(pres_pa, shum, temp_k):
    rh_pct = 0.263 * pres_pa * shum / np.exp(
        17.67 * (temp_k - 273.15) / (temp_k - 29.65)
    )
    return np.clip(np.nan_to_num(rh_pct), 0.0, 100.0) / 100.0


class _Grid:
    def __init__(self, ds: NcDataset, lat_var: str, lon_var: str):
        self.lat = ds.var(lat_var)[:]
        self.lon = ds.var(lon_var)[:]

    def nearest(self, lon, lat):
        ilat = int(np.argmin(np.abs(self.lat - lat)))
        ilon = int(np.argmin(np.abs(self.lon - lon)))
        return ilat, ilon


def _time_axis_minutes(ds: NcDataset, time_var: str, forc_start: int):
    tv = ds.var(time_var)
    units = tv.attrs.get("units", "")
    base_min, factor = parse_time_units(str(units))
    start_min = yyyymmdd_to_epoch_minutes(forc_start)
    return base_min + tv[:] * factor - start_min


def load_netcdf_forcing(
    cfg_path: str,
    stations: np.ndarray,  # [S, 3]: lon, lat, z
    forc_start_yyyymmdd: int,
    sim_start_min: float,
    sim_end_min: float,
) -> ForcingCSV:
    kv = read_kv_cfg(cfg_path)
    product = kv.get("PRODUCT", "").upper()
    data_root = kv.get("DATA_ROOT", ".")
    if not os.path.isabs(data_root):
        run_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(cfg_path))))
        data_root = os.path.join(run_dir, data_root)
    pattern = kv.get("LAYOUT_FILE_PATTERN", kv.get(f"{product}_FILE_PATTERN", ""))
    time_var = kv.get("TIME_VAR", kv.get("NC_DIM_TIME", "time"))
    lat_var = kv.get("LAT_VAR", kv.get("NC_DIM_LAT", "lat"))
    lon_var = kv.get("LON_VAR", kv.get("NC_DIM_LON", "lon"))
    nc_var = {k[len("NC_VAR_"):]: v for k, v in kv.items()
              if k.startswith("NC_VAR_")}
    var_dir = {k[len("LAYOUT_VAR_DIR_"):]: v for k, v in kv.items()
               if k.startswith("LAYOUT_VAR_DIR_")}

    if product == "CMFD2":
        t_min, cols = _load_cmfd(
            kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
            var_dir, stations, forc_start_yyyymmdd, sim_start_min,
            sim_end_min,
        )
    elif product == "ERA5":
        t_min, cols = _load_era5(
            kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
            stations, forc_start_yyyymmdd, sim_start_min, sim_end_min,
        )
    elif product == "GLDAS":
        t_min, cols = _load_gldas(
            kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
            stations, forc_start_yyyymmdd, sim_start_min, sim_end_min,
        )
    else:
        raise ValueError(f"unsupported PRODUCT {product!r} in {cfg_path}")

    s = len(stations)
    fc = ForcingCSV(
        num_stations=s, start_yyyymmdd=forc_start_yyyymmdd,
        lon=stations[:, 0].copy(), lat=stations[:, 1].copy(),
        xyz=np.stack([stations[:, 0], stations[:, 1], stations[:, 2]], 1),
        filenames=[f"netcdf:{product}"] * s,
    )
    for i in range(s):
        fc.t_min.append(t_min.copy())
        fc.data.append(cols[:, i, :].copy())
    return fc


def _month_list(forc_start, sim_start_min, sim_end_min):
    import datetime

    base = datetime.date(forc_start // 10000, (forc_start // 100) % 100,
                         forc_start % 100)
    d0 = base + datetime.timedelta(days=int(sim_start_min // 1440))
    d1 = base + datetime.timedelta(days=int(max(sim_end_min - 1e-9, 0) // 1440))
    months = []
    y, m = d0.year, d0.month
    while (y, m) <= (d1.year, d1.month):
        months.append(f"{y:04d}{m:02d}")
        m += 1
        if m > 12:
            m = 1
            y += 1
    return months


def _read_station_series(path, varname, time_var, lat_var, lon_var,
                         stations, forc_start):
    """Read [T, S] nearest-point series + the local time axis [T]."""
    ds = NcDataset(path)
    try:
        grid = _Grid(ds, lat_var, lon_var)
        t = _time_axis_minutes(ds, time_var, forc_start)
        v = ds.var(varname)
        data = v[:]
        if data.ndim == 2:
            data = data[None]
        out = np.empty((len(t), len(stations)))
        for i, (lon, lat, _z) in enumerate(stations):
            ilat, ilon = grid.nearest(lon, lat)
            out[:, i] = data[:, ilat, ilon]
        return np.asarray(t, dtype=np.float64), out
    finally:
        ds.close()


def _cmfd_precip_factor(units_attr: str, cfg_units: str):
    u = (cfg_units or "AUTO").upper()
    if u == "KG_M2_S":
        return 86400.0
    if u in ("MM_HR", "MM/HR", "MM_H-1"):
        return 24.0
    if u in ("MM_DAY", "MM/DAY", "MM_D-1"):
        return 1.0
    ua = (units_attr or "").lower().replace(" ", "")
    if "kg" in ua and ("s-1" in ua or "/s" in ua):
        return 86400.0
    if "mm/hr" in ua or "mmhr-1" in ua or "mmh-1" in ua:
        return 24.0
    if "mm/day" in ua or "mmday-1" in ua or "mmd-1" in ua:
        return 1.0
    raise ValueError(
        f"cannot auto-detect CMFD precip units from {units_attr!r}; set "
        "CMFD_PRECIP_UNITS (AUTO|KG_M2_S|MM_HR|MM_DAY)"
    )


def _load_cmfd(kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
               var_dir, stations, forc_start, t0, t1):
    months = _month_list(forc_start, t0, t1)
    need = ["PREC", "TEMP", "SHUM", "SRAD", "WIND", "PRES"]
    series = {k: [] for k in need}
    taxis = []
    precip_units_attr = ""
    for yyyymm in months:
        for key in need:
            vname = nc_var[key]
            pat = pattern.replace("{var_lower}", vname.lower()).replace(
                "{yyyymm}", yyyymm
            )
            d = var_dir.get(key, var_dir.get(vname.upper(), ""))
            path = resolve_single_glob(os.path.join(data_root, d, pat))
            t, vals = _read_station_series(
                path, vname, time_var, lat_var, lon_var, stations, forc_start
            )
            if key == "PREC" and not precip_units_attr:
                ds = NcDataset(path)
                precip_units_attr = str(
                    ds.var(vname).attrs.get("units", "")
                )
                ds.close()
            series[key].append(vals)
            if key == "PREC":
                taxis.append(t)
    t_min = np.concatenate(taxis)
    v = {k: np.concatenate(series[k], axis=0) for k in need}
    pf = _cmfd_precip_factor(precip_units_attr,
                             kv.get("CMFD_PRECIP_UNITS", "AUTO"))
    prcp, temp, rh, wind, rn = _quantise(
        v["PREC"] * pf,
        v["TEMP"] - 273.15,
        _rh_from_q(v["PRES"], v["SHUM"], v["TEMP"]),
        v["WIND"],
        v["SRAD"],
    )
    cols = np.stack([prcp, temp, rh, wind, rn], axis=-1)
    keep = (t_min >= -1e-9) & (t_min <= t1 + 1440.0)
    return t_min[keep], cols[keep]


def _load_era5(kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
               stations, forc_start, t0, t1):
    import datetime

    base = datetime.date(forc_start // 10000, (forc_start // 100) % 100,
                         forc_start % 100)
    d0 = int(t0 // 1440)
    d1 = int(max(t1 - 1e-9, 0) // 1440)
    need = ["T2M", "D2M", "U10", "V10", "TP", "SSR"]
    taxis = []
    series = {k: [] for k in need}
    for day in range(d0, d1 + 1):
        date = base + datetime.timedelta(days=day)
        yyyymmdd = f"{date.year:04d}{date.month:02d}{date.day:02d}"
        pat = pattern.replace("{yyyymmdd}", yyyymmdd).replace(
            "{yyyy}", f"{date.year:04d}"
        )
        sub = f"{date.year:04d}" if kv.get(
            "LAYOUT_YEAR_SUBDIR", kv.get("ERA5_YEAR_SUBDIR", "")
        ).upper() in ("1", "TRUE", "YES") else ""
        path = resolve_single_glob(os.path.join(data_root, sub, pat))
        for key in need:
            t, vals = _read_station_series(
                path, nc_var[key], time_var, lat_var, lon_var, stations,
                forc_start,
            )
            series[key].append(vals)
            if key == "T2M":
                taxis.append(t)
    t_min = np.concatenate(taxis)
    v = {k: np.concatenate(series[k], axis=0) for k in need}

    # accumulated tp/ssr -> interval increments with reset tolerance
    nt = len(t_min)
    dt_sec = np.diff(t_min, append=t_min[-1] + 60.0) * 60.0
    dt_sec[-1] = dt_sec[-2] if nt > 1 else 3600.0

    def increments(acc, tol_abs, tol_rel):
        nxt = np.vstack([acc[1:], acc[-1:]])
        d = nxt - acc
        tol = np.maximum(tol_abs, tol_rel * np.maximum(np.abs(acc),
                                                       np.abs(nxt)))
        inc = np.where(d >= -tol, np.maximum(0.0, d), nxt)
        inc[-1] = 0.0
        return inc

    tp_inc = increments(v["TP"], 1e-5, 1e-4)
    ssr_inc = increments(v["SSR"], 1000.0, 1e-4)
    prcp_mm_day = tp_inc * 1000.0 * (86400.0 / dt_sec[:, None])
    rn_wm2 = ssr_inc / dt_sec[:, None]

    temp_c = np.round(v["T2M"] - 273.15, 2)
    td_c = v["D2M"] - 273.15
    es = 6.112 * np.exp(17.67 * temp_c / (temp_c + 243.5))
    ea = 6.112 * np.exp(17.67 * td_c / (td_c + 243.5))
    rh = np.where((es > 0) & np.isfinite(es) & np.isfinite(ea), ea / es, 0.0)
    wind = np.hypot(v["U10"], v["V10"])

    prcp, temp, rh, wind, rn = _quantise(prcp_mm_day, temp_c, rh, wind,
                                         rn_wm2)
    cols = np.stack([prcp, temp, rh, wind, rn], axis=-1)
    return t_min, cols


def _load_gldas(kv, data_root, pattern, time_var, lat_var, lon_var, nc_var,
                stations, forc_start, t0, t1):
    import datetime

    base = datetime.date(forc_start // 10000, (forc_start // 100) % 100,
                         forc_start % 100)
    dt_min = 180.0  # GLDAS_NOAH025_3H
    s0 = int(t0 // dt_min)
    s1 = max(int(max(t1 - 1e-9, 0) // dt_min), s0)
    need = ["PREC", "TEMP", "SHUM", "SRAD", "WIND", "PRES"]
    taxis = []
    series = {k: [] for k in need}
    for step in range(s0, s1 + 1):
        tm = step * dt_min
        date = base + datetime.timedelta(days=int(tm // 1440))
        min_in_day = int(tm % 1440)
        yyyy = f"{date.year:04d}"
        yyyymmdd = f"{yyyy}{date.month:02d}{date.day:02d}"
        hhmm = f"{min_in_day // 60:02d}{min_in_day % 60:02d}"
        doy = f"{date.timetuple().tm_yday:03d}"
        pat = (pattern.replace("{year}", yyyy).replace("{yyyy}", yyyy)
               .replace("{doy}", doy).replace("{yyyymmdd}", yyyymmdd)
               .replace("{hhmm}", hhmm))
        path = resolve_single_glob(os.path.join(data_root, pat))
        row = {}
        for key in need:
            _, vals = _read_station_series(
                path, nc_var[key], time_var, lat_var, lon_var, stations,
                forc_start,
            )
            row[key] = vals[0]
        taxis.append(tm)
        for key in need:
            series[key].append(row[key])
    t_min = np.asarray(taxis, dtype=np.float64)
    v = {k: np.stack(series[k], axis=0) for k in need}
    prcp, temp, rh, wind, rn = _quantise(
        v["PREC"] * 86400.0,
        v["TEMP"] - 273.15,
        _rh_from_q(v["PRES"], v["SHUM"], v["TEMP"]),
        v["WIND"],
        v["SRAD"],
    )
    cols = np.stack([prcp, temp, rh, wind, rn], axis=-1)
    return t_min, cols
