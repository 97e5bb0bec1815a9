# A frozen copy of shud_tpu_torch/core/solar.py,
# its imports rewritten to this package; otherwise unchanged.
"""Solar geometry and terrain solar radiation (TSR).

The counterpart of ``shud_tpu/core/solar.py``: the reference's NOAA-style
solar position (``src/Equations/SolarRadiation.cpp:95-180``) and the
per-forcing-interval cosZ-weighted terrain factor
(``src/ModelData/MD_ET.cpp:62-204``).  The per-interval solar samples are
shared across cells and precomputed on the host in numpy float64 for all
forcing intervals; the per-cell factor (``tsr_factor``) runs on the device
in each window.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from portbench.reference.physics import maximum, minimum


def day_of_year_table(base_yyyymmdd: int, num_days: int) -> np.ndarray:
    """Day-of-year for each simulated day since the forcing base date."""
    y = base_yyyymmdd // 10000
    m = (base_yyyymmdd // 100) % 100
    d = base_yyyymmdd % 100
    base = datetime.date(y, m, d)
    out = np.empty(num_days, dtype=np.int32)
    for i in range(num_days):
        out[i] = (base + datetime.timedelta(days=i)).timetuple().tm_yday
    return out


def solar_position(t_min, doy, lat_deg, lon_deg, timezone_hours=0.0):
    """Vectorised solarPosition (SolarRadiation.cpp:95-180), UTC, numpy.

    Returns (cosZ, azimuth [rad, North=0 East=pi/2], declination)."""
    t_min = np.asarray(t_min, dtype=np.float64)
    lat = np.clip(lat_deg, -90.0, 90.0)
    lon = lon_deg  # assumed already in [-180, 180]

    mod_min = np.mod(t_min, 1440.0)
    hour = mod_min / 60.0

    two_pi = 2.0 * np.pi
    gamma = (two_pi / 365.0) * (
        (np.asarray(doy) - 1).astype(t_min.dtype) + (hour - 12.0) / 24.0)
    sin_g, cos_g = np.sin(gamma), np.cos(gamma)
    sin_2g, cos_2g = np.sin(2 * gamma), np.cos(2 * gamma)
    sin_3g, cos_3g = np.sin(3 * gamma), np.cos(3 * gamma)

    eq_time = 229.18 * (
        0.000075 + 0.001868 * cos_g - 0.032077 * sin_g
        - 0.014615 * cos_2g - 0.040849 * sin_2g
    )
    decl = (
        0.006918 - 0.399912 * cos_g + 0.070257 * sin_g - 0.006758 * cos_2g
        + 0.000907 * sin_2g - 0.002697 * cos_3g + 0.00148 * sin_3g
    )
    time_offset = eq_time + 4.0 * lon - 60.0 * timezone_hours
    tst = np.mod(mod_min + time_offset, 1440.0)
    ha = (tst / 4.0 - 180.0) * (np.pi / 180.0)

    lat_r = lat * (np.pi / 180.0)
    cosz = np.clip(
        np.sin(lat_r) * np.sin(decl)
        + np.cos(lat_r) * np.cos(decl) * np.cos(ha),
        -1.0, 1.0,
    )
    east = -np.cos(decl) * np.sin(ha)
    north = (np.cos(lat_r) * np.sin(decl)
             - np.sin(lat_r) * np.cos(decl) * np.cos(ha))
    az = np.mod(np.arctan2(east, north), 2.0 * np.pi)
    return cosz, az, decl


def interval_samples(
    t0: np.ndarray,
    t1: np.ndarray,
    dt_int_min: int,
    lat_deg: float,
    lon_deg: float,
    base_yyyymmdd: int,
):
    """Precompute per-forcing-interval solar sample vectors.

    Mirrors the bucket fill at MD_ET.cpp:94-160: for interval k the factor
    integrand is sampled at ``n = ceil((t1-t0)/dt_int)`` midpoints, each with
    weight ``max(cosZ,0)*dt_seg``.

    Returns (sx, sy, sz, wdt) each [K, nmax] plus den [K]."""
    t0 = np.asarray(t0, dtype=np.float64)
    t1 = np.asarray(t1, dtype=np.float64)
    dt_forc = t1 - t0
    dt_int = np.minimum(float(dt_int_min), dt_forc)
    n = np.maximum(np.ceil(dt_forc / dt_int).astype(int), 1)
    nmax = int(n.max())
    dt_seg = dt_forc / n

    # sample times [K, nmax]
    ks = np.arange(nmax)[None, :]
    tk = t0[:, None] + (ks + 0.5) * dt_seg[:, None]
    valid = ks < n[:, None]

    max_day = int(np.ceil(t1.max() / 1440.0)) + 2
    doy_tab = day_of_year_table(base_yyyymmdd, max_day)
    day_idx = np.clip((tk // 1440.0).astype(int), 0, max_day - 1)
    doy = doy_tab[day_idx]

    cosz, az, _ = solar_position(tk, doy, lat_deg, lon_deg, 0.0)

    cosz_cl = np.clip(cosz, -1.0, 1.0)
    sinz = np.sqrt(np.maximum(0.0, 1.0 - cosz_cl**2))
    sx = sinz * np.sin(az)
    sy = sinz * np.cos(az)
    sz = cosz_cl
    wdt = np.maximum(0.0, cosz_cl) * dt_seg[:, None]
    wdt = np.where(valid & (cosz > 0.0) & (wdt > 0.0), wdt, 0.0)
    den = wdt.sum(axis=1)
    return sx, sy, sz, wdt, den


def tsr_factor(nx, ny, nz, sx, sy, sz, wdt, den, cap, cosz_min):
    """Per-cell equivalent terrain factor for one forcing interval.

    nx/ny/nz: [Ne]; sx/sy/sz/wdt: [n] samples; den: 0-d.
    Mirrors MD_ET.cpp:163-204."""
    cosi = (
        nx[:, None] * sx[None, :]
        + ny[:, None] * sy[None, :]
        + nz[:, None] * sz[None, :]
    )  # [Ne, n]
    denom = maximum(sz, cosz_min)[None, :]
    fk = cosi / denom
    fk = torch.where((cosi > 0.0) & (fk > 0.0), minimum(fk, cap), 0.0)
    num = torch.sum(wdt[None, :] * fk, dim=1)
    feff = torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 0.0)
    feff = torch.where(feff > 0.0, minimum(feff, cap), 0.0)
    return feff
