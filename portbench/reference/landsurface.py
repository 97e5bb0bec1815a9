# A frozen copy of shud_tpu_torch/core/landsurface.py,
# its imports rewritten to this package; otherwise unchanged.
"""Land-surface forcing transform, potential ET, and bucket stores.

The counterpart of ``shud_tpu/core/landsurface.py``: vectorises
``Model_Data::tReadForcing`` (MD_ET.cpp:21-281: per-cell forcing with
lapse-rate temperature, TSR-scaled shortwave, Penman–Monteith PET) and
``Model_Data::ET`` (MD_ET.cpp:282-342: snow + canopy-interception buckets,
explicit step at the forcing cadence).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.config import (
    CONST_RH,
    CP_AIR,
    DTDZ,
    IC_MAX,
    NA_VALUE,
    ROUGHNESS_WATER,
    SEC_A_DAY,
    T0_MELT,
    TRAIN,
    TSNOW,
    ZERO,
)
from portbench.reference.physics import absolute, clip, maximum


class CalibScalars(NamedTuple):
    c_prcp: torch.Tensor
    c_temp: torch.Tensor
    c_lai: torch.Tensor
    c_mf: torch.Tensor
    c_etp: torch.Tensor
    c_ismax: torch.Tensor


class CellForcing(NamedTuple):
    """Per-cell forcing at one step (the t_* arrays of the reference)."""

    prcp: torch.Tensor  # [m/min]
    temp: torch.Tensor  # [C]
    rh: torch.Tensor
    wind: torch.Tensor  # [m/s]
    rn: torch.Tensor  # net MJ/m2/s
    lai: torch.Tensor
    mf: torch.Tensor  # [m/min/C]
    pot_evap: torch.Tensor  # [m/min]
    pot_tran: torch.Tensor  # [m/min]
    etp: torch.Tensor  # [m/min]
    rn_h: torch.Tensor  # diagnostic: horizontal-plane SW [W/m2]
    rn_t: torch.Tensor  # diagnostic: terrain-corrected SW [W/m2]
    rn_factor: torch.Tensor  # diagnostic: TSR factor


def cell_forcing(
    m,
    forc_vals,  # [S, 5] station (prcp mm/d, temp C, rh, wind, rn W/m2);
    #            [S, 8] with ET_MODE=1 (+ tmax C, tmin C, H0 MJ/m2/d)
    station_z,  # [S]
    lai_vals,  # [C_lai] LAI columns (1-based LC index selects col iLC-1)
    mf_vals,  # [C_mf]
    factor,  # [Ne] TSR factor for the current forcing interval (1.0 if off)
    cal: CalibScalars,
    swnet_mode: bool = False,
    terrain_radiation: bool = True,
    et_mode: int = 0,  # 0 Penman-Monteith | 1 Hargreaves | 2 Priestley-
    # Taylor (the reference declares all three, Model_Control.hpp:184-187)
) -> CellForcing:
    # station/class lookups: per-cell gathers from tiny tables
    ifc = m.i_forc - 1  # [Ne] 0-based station
    sv = forc_vals[ifc]  # [Ne, 5 (or 8)]
    prcp_mmday = sv[:, 0] * cal.c_prcp
    t0 = sv[:, 1]
    zt = station_z[ifc]
    # TemperatureOnElevation (Equations.hpp:66-73): NA station z -> no lapse
    lapse_ok = (zt != NA_VALUE) & (m.z_surf != NA_VALUE)
    temp = torch.where(lapse_ok, t0 + (zt - m.z_surf) * DTDZ, t0) + cal.c_temp

    # clamp column lookups: some projects have more landcover classes than
    # LAI columns; clamp to the last column (as the reference package does)
    lai = lai_vals[torch.clamp(m.i_lc - 1, 0, lai_vals.shape[0] - 1)] \
        * cal.c_lai
    mf = mf_vals[torch.clamp(m.i_mf - 1, 0, mf_vals.shape[0] - 1)] \
        * cal.c_mf / 1440.0

    dswrf_h = sv[:, 4]
    if terrain_radiation:
        dswrf_t = dswrf_h * factor
    else:
        factor = torch.ones_like(dswrf_h)
        dswrf_t = dswrf_h
    if swnet_mode:
        rn = dswrf_t
    else:
        rn = dswrf_t * (1.0 - m.albedo)

    wind = absolute(sv[:, 3]) + 0.001
    rh = clip(sv[:, 2], CONST_RH, 1.0)
    prcp = prcp_mmday * 0.001 / 1440.0
    rn = rn * 1.0e-6  # W/m2 -> MJ/m2/s

    # Penman-Monteith pieces (is_sm_et.hpp; Maidment Handbook eq 4.2.x)
    lam = 2.501 - 0.002361 * temp
    gamma = 0.0016286 * m.fix_pressure / lam
    es = 0.6108 * torch.exp(17.27 * temp / (temp + 237.3))
    ed = es * (1.0 - rh)
    delta = 4098.0 * es / (temp + 237.3) ** 2
    rho = 3.486 * m.fix_pressure / (275.0 + temp)

    is_lake = m.i_lake > 0
    ghf = torch.where(
        is_lake,
        0.0,
        torch.where(lai > 0.0, 0.4 * torch.exp(-0.5 * lai) * rn, 0.1 * rn),
    )
    rg = rn - ghf

    # open-water PET (eq 4.2.30), wind at 2 m via log profile
    u2 = wind * math.log(2.0 / ROUGHNESS_WATER) / torch.log(
        m.wind_h / ROUGHNESS_WATER
    )
    pet_ow = (
        (delta * rg * SEC_A_DAY + gamma * 6.43 * (1.0 + 0.536 * u2) * ed)
        / (delta + gamma)
    ) / lam * 0.001 / SEC_A_DAY  # [m/s]
    pot_evap = cal.c_etp * pet_ow * 60.0  # [m/min]

    # vegetation PM transpiration (eq 4.2.27)
    hc = lai * 0.5
    zm = hc * 1.3333
    d = 0.67 * hc
    z_om = 0.123 * hc
    z_ov = 0.0123 * hc
    safe = lai > 0.0
    z_om_s = torch.where(safe, z_om, 1.0)
    z_ov_s = torch.where(safe, z_ov, 1.0)
    ra = (
        torch.log(absolute(zm - d) / z_om_s)
        * torch.log(absolute(zm - d) / z_ov_s)
        / (0.4 * 0.4 * wind)
    )
    rs = 200.0 / torch.where(safe, lai, 1.0)
    e_rad = delta * rg
    e_air = rho * CP_AIR * ed / torch.where(safe, ra, 1.0)
    pm = (e_rad + e_air) / (delta + gamma * (1.0 + rs / torch.where(safe, ra,
                                                                    1.0)))
    pot_tran_raw = cal.c_etp * (pm / lam * 0.001) * 60.0

    veg = safe & ~is_lake
    pot_tran = torch.where(veg, pot_tran_raw, 0.0)

    if et_mode == 1:
        # Hargreaves (SWAT 2:2.2.24, PET_Hargreaves is_sm_et.cpp:3-15), with
        # daily station Tmax/Tmin and H0 in forcing columns 5-7
        tmax = sv[:, 5]
        tmin = sv[:, 6]
        h0 = sv[:, 7]
        tavg = 0.5 * (tmax + tmin) + (temp - t0)
        pet_mmday = (
            0.023 * h0 * torch.sqrt(maximum(tmax - tmin, 0.0))
            * maximum(tavg - 17.8, 0.0) / lam
        )
        pet = cal.c_etp * pet_mmday * 0.001 / 1440.0  # [m/min]
        pot_evap = pet
        pot_tran = torch.where(veg, pet, 0.0)
    elif et_mode == 2:
        # Priestley-Taylor (SWAT 2:2.2.23, PET_Priestley_Taylor
        # is_sm_et.cpp:16-30): Eo = a D/(D+g) (Hnet-G)/lambda, a=1.26
        pet_mmday = maximum(
            1.26 * delta / (delta + gamma) * (rg * SEC_A_DAY) / lam, 0.0
        )
        pet = cal.c_etp * pet_mmday * 0.001 / 1440.0  # [m/min]
        pot_evap = pet
        pot_tran = torch.where(veg, pet, 0.0)

    etp = torch.where(
        veg,
        pot_tran * m.veg_frac + pot_evap * (1.0 - m.veg_frac),
        pot_evap,
    )

    return CellForcing(
        prcp=prcp, temp=temp, rh=rh, wind=wind, rn=rn, lai=lai, mf=mf,
        pot_evap=pot_evap, pot_tran=pot_tran, etp=etp,
        rn_h=dswrf_h, rn_t=dswrf_t, rn_factor=factor,
    )


class BucketState(NamedTuple):
    ic_stg: torch.Tensor  # yEleIS canopy interception [m]
    snow: torch.Tensor  # yEleSnow [m SWE]


class BucketOut(NamedTuple):
    state: BucketState
    net_prcp: torch.Tensor  # qEleNetPrep [m/min]
    e_ic: torch.Tensor  # qEleE_IC [m/min]
    sn_frac: torch.Tensor


def frozen_fraction(t, high, low):
    x = (high - t) / (high - low)
    return torch.where(t > high, 0.0,
                       torch.where(t < low, 1.0, clip(x, 0.0, 1.0)))


def et_bucket_step(
    m, cf: CellForcing, bs: BucketState, dt_min, c_ismax
) -> BucketOut:
    """Snow + interception bucket update (``Model_Data::ET``,
    MD_ET.cpp:282-342).  Explicit step over ``dt_min`` minutes."""
    t = cf.temp
    prcp = cf.prcp
    sn_frac = frozen_fraction(t, TRAIN, TSNOW)
    sn_acc = sn_frac * prcp
    sn_melt = torch.where(t > T0_MELT, (t - T0_MELT) * cf.mf, 0.0)
    sn_melt = torch.minimum(
        maximum(bs.snow / dt_min, 0.0), maximum(sn_melt, 0.0)
    )
    snow = bs.snow + (sn_acc - sn_melt) * dt_min

    vg = m.veg_frac
    ic_stg = torch.where(vg > ZERO,
                         bs.ic_stg / torch.where(vg > ZERO, vg, 1.0), 0.0)
    has_lai = cf.lai > ZERO
    ic_max = c_ismax * IC_MAX * cf.lai
    ic_acc = torch.where(
        has_lai,
        torch.minimum(prcp - sn_acc, maximum((ic_max - ic_stg) / dt_min, 0.0)),
        0.0,
    )
    ic_evap = torch.where(
        has_lai,
        torch.minimum(maximum(ic_stg / dt_min, 0.0), cf.pot_evap),
        0.0,
    )
    ic_stg = ic_stg + (ic_acc - ic_evap) * dt_min

    return BucketOut(
        state=BucketState(ic_stg=ic_stg * vg, snow=snow),
        net_prcp=(1.0 - sn_frac) * prcp + sn_melt - ic_acc * vg,
        e_ic=ic_evap * vg,
        sn_frac=sn_frac,
    )
