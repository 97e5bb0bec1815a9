# Copied verbatim from shud_tpu/diag/waterbalance.py; only the package imports differ.
"""Water-balance diagnostics — runtime conservation checker.

Equivalent of the reference's opt-in WaterBalanceDiag subsystem
(``src/Model/WaterBalanceDiag.{hpp,cpp}``, env ``SHUD_WB_DIAG=1``): per
output interval it compares basin storage change against the integrated
flux budget

    dS  ?=  P - ET - Qout - Qedge + QBC + QSS

(all in m^3 over the interval; the reference's 9-column basin budget,
``WaterBalanceDiag.cpp:440-530``), plus per-element residuals between the
storage change and the per-cell flux budget.  Qedge is the open-boundary
kinematic edge drainage (``basinBoundaryEdgeOutflow_m3min``); QBC covers
flux BCs only (element iBC<0 and river qBC — head BCs are outside the
budget, matching ``WaterBalanceDiag.cpp:476-494``); QSS is the
source/sink injection.  Going beyond the reference, lake storage (the
bathymetry volume) and lake precip/evap on the bathymetry area are
included, so the budget closes on lake watersheds (qhh) too.

Doubles as the conservation oracle in the test suite: the physics
conserves mass by construction, so the residual measures solver
integration error.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def lake_toparea_np(md, stg: np.ndarray) -> np.ndarray:
    """NumPy port of ``core.rhs._lake_toparea`` (Lake.cpp:toparea:59-78),
    including the reference's interpolation quirk (denominator yi[i]-y)."""
    yq = np.asarray(stg) + md.lake_zmin
    yi = np.asarray(md.lake_bathy_y)
    ai = np.asarray(md.lake_bathy_a)
    k = yi.shape[1]
    ta = ai[:, 0].copy()
    done = yq <= yi[:, 0]
    for i in range(1, k):
        below = yq < yi[:, i]
        den = np.where(yi[:, i] == yq, 1.0, yi[:, i] - yq)
        interp = (ai[:, i] - ta) / den * (yq - yi[:, i - 1]) + ta
        new_ta = np.where(below, interp, ai[:, i])
        ta = np.where(done, ta, new_ta)
        done = done | below
    return ta


def lake_volume_m3(md, stg: np.ndarray, n: int = 512) -> float:
    """Lake storage above the bathymetry bottom: V(stage) = int_0^stage
    A(s) ds with A the SAME stage->area function the RHS uses, so that
    dV/dt equals the lake flux assembly exactly (chain rule) and the basin
    budget closes.  A is integrated numerically (fine trapezoid) because
    the reference's piecewise form has no convenient antiderivative."""
    stg = np.asarray(stg, dtype=float)
    if stg.size == 0:
        return 0.0
    s = np.linspace(0.0, 1.0, n)[:, None] * np.maximum(stg, 0.0)[None, :]
    areas = np.stack([lake_toparea_np(md, row) for row in s])
    v = np.trapezoid(areas, x=s, axis=0) if hasattr(np, "trapezoid") \
        else np.trapz(areas, x=s, axis=0)
    return float(np.sum(v))


@dataclasses.dataclass
class BasinBudget:
    t0: float
    t1: float
    ds_m3: float  # storage change (elements + rivers + lakes)
    p_m3: float  # precip onto land cells + lake surfaces
    et_m3: float  # land ET + lake evaporation
    qout_m3: float
    qedge_m3: float  # open-boundary edge drainage
    qbc_m3: float  # flux-BC injection (element iBC<0 + river qBC)
    qss_m3: float  # source/sink injection
    nc_m3: float = 0.0  # river non-conservation (dA clamp + fun_dAtodY
    # conversion; the reference's noncons diagnostics)

    @property
    def residual_m3(self) -> float:
        return self.ds_m3 - (
            self.p_m3 - self.et_m3 - self.qout_m3 - self.qedge_m3
            + self.qbc_m3 + self.qss_m3 + self.nc_m3
        )

    @property
    def residual_relative(self) -> float:
        scale = max(
            abs(self.p_m3), abs(self.et_m3), abs(self.qout_m3),
            abs(self.qedge_m3), abs(self.ds_m3), 1e-12,
        )
        return self.residual_m3 / scale


class WaterBalance:
    """Accumulates basin storage/flux terms over output intervals."""

    def __init__(self, md, out_path: str | None = None):
        self.md = md
        self.rows: list[BasinBudget] = []
        self.out_path = out_path
        self._fp = open(out_path, "w") if out_path else None
        if self._fp:
            self._fp.write(
                "t0_min,t1_min,dS_m3,P_m3,ET_m3,Qout_m3,Qedge_m3,QBC_m3,"
                "QSS_m3,NC_m3,residual_m3,residual_rel\n"
            )

    def storage_m3(self, y: np.ndarray, buckets=None) -> float:
        """Basin storage: ponding + Sy-scaled subsurface + river volume +
        lake bathymetry volume (mirrors basinElementStorageFull_m3 /
        basinRiverStorage_m3, plus the lake term the reference omits).

        Uses RAW state values (no positivity clamps): the ODE integrates
        slightly-negative ponding/stage (the model has no positivity
        enforcement, like the reference), and that phantom reservoir must
        stay in the accounting for the budget to close."""
        md = self.md
        ne, nr = md.num_ele, md.num_riv
        sf = y[:ne]
        us = y[ne : 2 * ne]
        gw = y[2 * ne : 3 * ne]
        # (lake cells are inert columns — dsf=dus=dgw=0 — so their constant
        # column storage cancels in dS and can stay in the sum)
        s_ele = np.sum((sf + (us + gw) * md.sy) * md.area)
        if buckets is not None:
            ic, snow = buckets
            s_ele += np.sum((np.asarray(ic) + np.asarray(snow)) * md.area)
        stage = y[3 * ne : 3 * ne + nr]
        csa = stage * (md.riv_bottom_width + stage * md.riv_bank_slope)
        s_riv = np.sum(csa * md.riv_length)
        s_lake = 0.0
        if md.num_lake > 0:
            s_lake = lake_volume_m3(md, y[3 * ne + nr :])
        return float(s_ele + s_riv + s_lake)

    def interval(
        self,
        t0: float,
        t1: float,
        y0: np.ndarray,
        y1: np.ndarray,
        mean_vals: dict,
        mean_riv: dict,
        buckets0=None,
        buckets1=None,
        et_m3=None,
        qout_m3=None,
        qedge_m3=None,
        qbc_m3=None,
        qss_m3=None,
        nc_m3=None,
        lake_p_m3=None,
        lake_e_m3=None,
        mean_lake: dict | None = None,
    ) -> BasinBudget:
        """Close the budget over [t0, t1) from interval-mean diagnostics
        (rates in m/min or m3/min).  Pass the ``*_m3`` terms from the
        solver's quadrature accumulators for exact closure (the sampled
        means carry the switching-bias documented in docs/VALIDATION.md);
        without them the interval means are used, including ``mean_lake``
        for the lake precip/evap terms on lake watersheds."""
        md = self.md
        dt = t1 - t0
        area = md.area
        land = np.ones(md.num_ele, dtype=bool)
        if md.num_lake > 0:
            land = md.i_lake <= 0
        p_m3 = float(np.sum(mean_vals["prcp"] * area * land) * dt)
        if et_m3 is None:
            et_m3 = float(np.sum(mean_vals["eta"] * area * land) * dt)
        outlet = (md.riv_down < 0) & (md.riv_to_lake < 0)
        if qout_m3 is None:
            qout_m3 = float(np.sum(mean_riv["q_riv_down"][outlet]) * dt)
        if qedge_m3 is None:
            qedge_m3 = float(np.sum(mean_vals.get("q_edge_out", 0.0)) * dt)
        if qbc_m3 is None:
            qbc_m3 = 0.0
        if qss_m3 is None:
            qss_m3 = 0.0
        if nc_m3 is None:
            nc_m3 = 0.0
        if md.num_lake > 0:
            if lake_p_m3 is None and mean_lake is not None:
                lake_p_m3 = float(np.sum(
                    mean_lake["q_lake_prcp"] * mean_lake["lake_area"]) * dt)
            if lake_e_m3 is None and mean_lake is not None:
                lake_e_m3 = float(np.sum(
                    mean_lake["q_lake_evap"] * mean_lake["lake_area"]) * dt)
        p_m3 += lake_p_m3 or 0.0
        et_m3 += lake_e_m3 or 0.0
        row = BasinBudget(
            t0=t0, t1=t1,
            ds_m3=self.storage_m3(y1, buckets1) - self.storage_m3(y0, buckets0),
            p_m3=p_m3, et_m3=et_m3, qout_m3=qout_m3, qedge_m3=qedge_m3,
            qbc_m3=qbc_m3, qss_m3=qss_m3, nc_m3=nc_m3,
        )
        self.rows.append(row)
        if self._fp:
            self._fp.write(
                f"{row.t0:.1f},{row.t1:.1f},{row.ds_m3:.6e},{row.p_m3:.6e},"
                f"{row.et_m3:.6e},{row.qout_m3:.6e},{row.qedge_m3:.6e},"
                f"{row.qbc_m3:.6e},{row.qss_m3:.6e},{row.nc_m3:.6e},"
                f"{row.residual_m3:.6e},{row.residual_relative:.6e}\n"
            )
            self._fp.flush()
        return row

    def element_residuals(
        self,
        t0: float,
        t1: float,
        y0: np.ndarray,
        y1: np.ndarray,
        mean_vals: dict,
    ) -> np.ndarray:
        """Per-element 3-state residual [m]: change in (sf + (us+gw)*Sy)
        vs the integrated per-cell flux budget (the reference's flux3
        residual, WaterBalanceDiag.cpp).  Uses interval means of the
        boundary-sampled fluxes, so the residual bounds solver integration
        + sampling error, not conservation (conservation is exact in the
        RHS by construction)."""
        md = self.md
        ne = md.num_ele
        dt = t1 - t0
        ds = (
            (y1[:ne] - y0[:ne])
            + (y1[ne : 2 * ne] - y0[ne : 2 * ne]) * md.sy
            + (y1[2 * ne : 3 * ne] - y0[2 * ne : 3 * ne]) * md.sy
        )
        flux = (
            mean_vals["net_prcp"]
            - (mean_vals["eta"] - mean_vals["e_ic"])
            - mean_vals["q_surf_tot"] / md.area
            - mean_vals["q_sub_tot"] / md.area
        ) * dt
        return ds - flux

    def close(self):
        if self._fp:
            self._fp.close()
            self._fp = None
