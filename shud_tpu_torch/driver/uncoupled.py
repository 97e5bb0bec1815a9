"""Operator-split ("uncoupled") mode — the reference's ``-g`` driver.

The counterpart of ``shud_tpu/driver/uncoupled.py``.  Five sub-systems
(surface, unsaturated, groundwater, river, lake) are advanced sequentially
over each window, each treating the others as frozen (Gauss–Seidel
splitting; reference ``SHUD_uncouple`` at shud.cpp:171-357 and the
sub-RHS set in ``MD_f_uncouple.cpp``).  It is an independent second solver
path over the same physics: implicit-vs-split agreement at splitting error
is a regression oracle.

Structural notes kept from the reference (and the JAX package):
* the surface sub-DY has NO surface-evaporation sink (f_applyDYi flag 1);
* recharge/exfiltration are FROZEN during the groundwater solve (f_loop3
  recomputes only lateral fluxes);
* river dV is converted by the top area, not the bank-slope quadratic
  (f_applyDYi flag 4);
* the ET partition is evaluated once per window at the frozen stage
  states;
* the 5th (lake) sub-solve is real: the implicit-mode lake budget
  (MD_f.cpp:180-191) with element/river states frozen at their staged
  values (the reference's ``f_loop5`` is empty; see the JAX module).

The mode runs in float64 only, as the JAX package's does (its
``run_project_split`` takes no dtype), so the edge stencil is the eager
one and no CUDA kernel runs on this path.  Each sub-solve takes
``solve_to``'s default route: the sub-RHS once and ``torch.func.jvp`` of
it per Krylov vector, as JAX takes ``jax.linearize`` of the same f.
Every ``segment_sum`` of the JAX module is a fixed-width gather list of the
mesh (``device.gather_sum``), as in ``core/rhs.py``, so the sums are
deterministic on the card.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from shud_tpu_torch.config import EPSILON, GRAV, ZERO
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core.device import gather_sum
from shud_tpu_torch.core.physics import maximum
from shud_tpu_torch.core.rhs import (
    _lake_toparea,
    edge_fluxes,
    et_flux,
    flux_infiltration,
    flux_recharge,
    lake_cell_update,
    update_element,
)
from shud_tpu_torch.core.state import ForcingSlice
from shud_tpu_torch.solver.bdf import SolverConfig, bdf_init, solve_to


def _seg_surface(m, fs, sf, q_infil, q_exfil, riv_stage):
    se, sr = m.seg_ele, m.seg_riv
    seg_isf = maximum(sf[se] - q_infil[se] + q_exfil[se], 0.0)
    zs_e = m.z_surf[se]
    return ph.weir_flow_jtoi(
        zs_e, seg_isf, zs_e - m.riv_depth[sr], riv_stage[sr],
        zs_e, m.seg_cwr, m.seg_length, m.depression[se],
    )


def _seg_sub(m, fs, gw, effkh, riv_stage):
    se, sr = m.seg_ele, m.seg_riv
    zs_e = m.z_surf[se]
    return ph.flux_r2e_gw(
        riv_stage[sr], zs_e - m.riv_depth[sr], gw[se], m.z_bottom[se],
        effkh[se], m.riv_ksat_h[sr], m.seg_length, m.riv_bed_thick[sr],
    ) * fs.fu_sub[se]


def _cell_update_split(m, sf, us, gw):
    """updateElement + the lake-cell overrides (rhs_full does the same)."""
    cu = update_element(m, sf, us, gw)
    if m.num_lake > 0:
        cu = lake_cell_update(m, cu)
    return cu


def _frozen_lake(m, lake0, like):
    if m.num_lake > 0:
        if lake0 is None:
            # a forgotten lake0 on a lake mesh would silently drop every
            # lake-bank flux (wrong physics, not an error)
            raise ValueError(
                "mesh has lakes but lake0 is None — pass the frozen lake "
                "stage to the sub-RHS (advance_window_uncoupled does)")
        return maximum(lake0, 0.0)
    return like.new_zeros(0)


def rhs_surf(m, fs: ForcingSlice, t, sf, us0, gw0, riv0, lake0=None,
             close_boundary=True):
    """d(sf)/dt with us/gw/riv/lake frozen (f_surf: f_loop1 +
    f_applyDYi(1))."""
    sf = maximum(sf, 0.0)  # f_updatei clamps (MD_update.cpp:49-53)
    cu = _cell_update_split(m, sf, us0, gw0)
    qi, qex = flux_infiltration(m, cu, sf, us0, gw0, fs.net_prcp)
    q_infil = qi * fs.fu_surf
    q_exfil = qex * fs.fu_surf
    lake_stg = _frozen_lake(m, lake0, sf)
    if m.num_lake > 0:
        is_lake = m.i_lake > 0
        q_infil = torch.where(is_lake, 0.0, q_infil)
        q_exfil = torch.where(is_lake, 0.0, q_exfil)
    q_esurf, _, _, _ = edge_fluxes(m, cu, sf, gw0, lake_stg, close_boundary)
    if m.num_lake > 0:
        q_esurf = torch.where(is_lake[:, None], 0.0, q_esurf)
    q_seg = _seg_surface(m, fs, sf, q_infil, q_exfil, riv0)
    q_e2r = gather_sum(-q_seg, m.lists.seg_to_ele)
    q_tot = q_e2r + q_esurf.sum(dim=1)
    dsf = fs.net_prcp - q_infil + q_exfil - q_tot / m.area
    dsf = dsf + torch.where(m.i_ss > 0, fs.ele_qss / m.area, 0.0)
    if m.num_lake > 0:
        dsf = torch.where(is_lake, 0.0, dsf)
    return dsf


def rhs_unsat(m, fs: ForcingSlice, t, us, sf0, gw0, close_boundary=True):
    """d(us)/dt (f_unsat: f_loop2 + f_applyDYi(2))."""
    us = maximum(us, 0.0)
    cu = _cell_update_split(m, sf0, us, gw0)
    es, eu, eg, tu, tg, _, _ = et_flux(m, fs, sf0, us, gw0, cu.satn)
    qi, qex = flux_infiltration(m, cu, sf0, us, gw0, fs.net_prcp)
    q_infil = qi * fs.fu_surf
    q_rech = flux_recharge(m, cu, us, gw0) * fs.fu_sub
    evapo = es + eu + eg
    trans = tu + tg
    dus = q_infil - q_rech - evapo
    dus = dus - torch.where(gw0 > m.rootreach_level, 0.0, trans)
    if m.num_lake > 0:
        dus = torch.where(m.i_lake > 0, 0.0, dus)
    return dus / m.sy


def rhs_gw(m, fs: ForcingSlice, t, gw, sf0, us0, riv0, q_rech0, q_exfil0,
           evapo0, trans0, lake0=None, close_boundary=True):
    """d(gw)/dt with frozen recharge/exfiltration (f_gw: f_loop3 +
    f_applyDY_gw)."""
    gw_c = maximum(gw, 0.0)
    gw_bc = torch.where(m.i_bc > 0, fs.ele_ybc, gw_c)
    cu = _cell_update_split(m, sf0, us0, gw_bc)
    lake_stg = _frozen_lake(m, lake0, gw)
    _, q_esub, _, _ = edge_fluxes(m, cu, sf0, gw_bc, lake_stg, close_boundary)
    q_esub = q_esub * fs.fu_sub[:, None]
    if m.num_lake > 0:
        is_lake = m.i_lake > 0
        q_esub = torch.where(is_lake[:, None], 0.0, q_esub)
    q_seg = _seg_sub(m, fs, gw_bc, cu.eff_kh, riv0)
    q_e2r = gather_sum(-q_seg, m.lists.seg_to_ele)
    q_tot = q_e2r + q_esub.sum(dim=1)
    dgw = q_rech0 - q_exfil0 - q_tot / m.area
    no_pond = sf0 < EPSILON
    dgw = dgw - torch.where(no_pond & (gw_bc >= m.wetland_level), evapo0,
                            0.0)
    dgw = dgw - torch.where(gw_bc > m.rootreach_level, trans0, 0.0)
    dgw = torch.where(m.i_bc > 0, 0.0, dgw)
    dgw = dgw + torch.where(m.i_bc < 0, fs.ele_qbc / m.area, 0.0)
    dgw = dgw + torch.where(m.i_ss < 0, fs.ele_qss / m.area, 0.0)
    if m.num_lake > 0:
        dgw = torch.where(is_lake, 0.0, dgw)
    return dgw / m.sy


def rhs_lake(m, fs: ForcingSlice, t, lake_stg, sf0, us0, gw0, q_lake_rivin0,
             close_boundary=True):
    """d(lake stage)/dt with element/river states frozen (the real 5th
    sub-solve; implicit-mode budget MD_f.cpp:180-191)."""
    lake_c = maximum(lake_stg, 0.0)
    # Dirichlet-BC cells contribute lake-bank fluxes at the prescribed
    # head, as rhs_full/rhs_gw do before edge_fluxes
    gw_bc = torch.where(m.i_bc > 0, fs.ele_ybc, gw0)
    cu = _cell_update_split(m, sf0, us0, gw_bc)
    is_lake = m.i_lake > 0
    _, _, q_lake_surf_e, q_lake_sub_e = edge_fluxes(
        m, cu, sf0, gw_bc, lake_c, close_boundary)
    # lake cells have no lateral fluxes (fun_Ele_lakeHorizon)
    q_lake_surf_e = torch.where(is_lake[:, None], 0.0, q_lake_surf_e)
    q_lake_sub_e = torch.where(is_lake[:, None], 0.0, q_lake_sub_e)
    lists = m.lists
    q_lake_surf = gather_sum(q_lake_surf_e.reshape(-1), lists.edge_to_lake)
    q_lake_sub = gather_sum(q_lake_sub_e.reshape(-1), lists.edge_to_lake)
    lk_cell = torch.where(is_lake, m.i_lake - 1, 0)
    inv_nele = 1.0 / maximum(m.lake_num_ele.to(lake_c.dtype), 1.0)
    q_lake_evap = gather_sum(
        torch.where(is_lake, fs.pot_evap * inv_nele[lk_cell], 0.0),
        lists.cell_to_lake)
    q_lake_prcp = gather_sum(
        torch.where(is_lake, fs.prcp * inv_nele[lk_cell], 0.0),
        lists.cell_to_lake)
    # clamp (MD_f.cpp:44-47): min first, then max — not clip
    q_lake_evap = maximum(torch.minimum(q_lake_evap, q_lake_prcp + lake_c),
                          0.0)
    lake_area = _lake_toparea(m, lake_c)
    return q_lake_prcp - q_lake_evap + (
        q_lake_rivin0 + q_lake_sub + q_lake_surf) / lake_area


def _riv_geometry(m, riv_stage):
    """(cross-section area, hydraulic radius) of each reach at a stage."""
    r_csa = maximum(
        riv_stage * (m.riv_bottom_width + riv_stage * m.riv_bank_slope), 0.0)
    r_per = maximum(
        2.0 * ph.absolute(riv_stage) * torch.sqrt(1.0 + m.riv_bank_slope**2)
        + m.riv_bottom_width, 0.0)
    r_hyd = torch.where(r_per <= ZERO, 0.0,
                        r_csa / torch.where(r_per <= ZERO, 1.0, r_per))
    return r_csa, r_hyd


def rhs_river(m, fs: ForcingSlice, t, riv, q_riv_surf0, q_riv_sub0):
    """d(stage)/dt with frozen exchange fluxes (f_river: f_loop4 +
    f_applyDYi(4)); dV -> dStage via the top area."""
    riv_c = maximum(riv, 0.0)
    riv_stage = torch.where(m.riv_bc > 0, fs.riv_ybc, riv_c)
    r_csa, r_hyd = _riv_geometry(m, riv_stage)
    r_eqw = maximum(
        0.5 * (riv_stage * m.riv_bank_slope * 2.0 + 2.0 * m.riv_bottom_width),
        0.0)
    top_area = maximum(r_eqw * m.riv_length, 1e-12)

    has_down = m.riv_down >= 0
    dn = torch.where(has_down, m.riv_down, 0)
    s_mean = 0.5 * (m.riv_bed_slope + m.riv_bed_slope[dn])
    s_down = ((riv_stage - m.riv_depth)
              - (riv_stage[dn] - m.riv_depth[dn])) / m.riv_dist2down + s_mean
    q_down_int = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_down)
    s_out = m.riv_bed_slope + riv_stage * 2.0 / m.riv_length
    q_out_zdg = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_out)
    q_out_crit = r_csa * torch.sqrt(GRAV * maximum(riv_stage, 1e-30)) * 60.0
    # lake-bound reaches: zero-depth-gradient Manning into the lake
    # (MD_RiverFlux.cpp:17-24), the same precedence as rhs_full
    q_riv_down = torch.where(
        m.riv_to_lake >= 0, q_out_zdg,
        torch.where(
            has_down, q_down_int,
            torch.where(m.riv_outlet_code == -4, q_out_crit, q_out_zdg),
        ),
    )
    q_riv_up = gather_sum(-q_riv_down, m.lists.riv_to_down)
    driv = (-q_riv_up - q_riv_surf0 - q_riv_sub0 - q_riv_down
            + fs.riv_qbc) / top_area
    return torch.where(m.riv_bc > 0, 0.0, driv)


@dataclasses.dataclass
class UncoupledStates:
    surf: object
    unsat: object
    gw: object
    riv: object
    lake: object = None  # None when the mesh has no lakes


# the five sub-RHS adapters, one set per close_boundary (as the JAX
# module's, whose identities keep its jit cache): the frozen stage states
# ride in the params tuple
@lru_cache(maxsize=None)
def _split_fns(close_boundary: bool):
    def f1(tt, yy, p):  # surface
        dm, fs, (us0, gw0, riv0, lake0) = p
        return rhs_surf(dm, fs, tt, yy, us0, gw0, riv0, lake0,
                        close_boundary)

    def f2(tt, yy, p):  # unsaturated
        dm, fs, (sf1, gw0) = p
        return rhs_unsat(dm, fs, tt, yy, sf1, gw0, close_boundary)

    def f3(tt, yy, p):  # groundwater
        dm, fs, (sf1, us1, riv0, q_rech0, q_exfil0, evapo0, trans0,
                 lake0) = p
        return rhs_gw(dm, fs, tt, yy, sf1, us1, riv0, q_rech0, q_exfil0,
                      evapo0, trans0, lake0, close_boundary)

    def f4(tt, yy, p):  # river
        dm, fs, (q_riv_surf0, q_riv_sub0) = p
        return rhs_river(dm, fs, tt, yy, q_riv_surf0, q_riv_sub0)

    def f5(tt, yy, p):  # lake
        dm, fs, (sf1, us1, gw1, q_lake_rivin0) = p
        return rhs_lake(dm, fs, tt, yy, sf1, us1, gw1, q_lake_rivin0,
                        close_boundary)

    return f1, f2, f3, f4, f5


def advance_window_uncoupled(dm, fs: ForcingSlice, states: UncoupledStates,
                             t: float, tout: float, cfg: SolverConfig,
                             close_boundary=True) -> UncoupledStates:
    """One Gauss-Seidel sweep: surf -> unsat -> gw -> river -> lake, each
    advanced over [t, tout] by its own adaptive implicit solver instance."""
    has_lake = dm.num_lake > 0 and states.lake is not None
    f1, f2, f3, f4, f5 = _split_fns(bool(close_boundary))

    us0 = maximum(states.unsat.y, 0.0)
    gw0 = maximum(states.gw.y, 0.0)
    riv0 = maximum(states.riv.y, 0.0)
    lake0 = maximum(states.lake.y, 0.0) if has_lake else None

    # 1) surface
    st1 = solve_to(f1, states.surf, tout,
                   (dm, fs, (us0, gw0, riv0, lake0)), cfg)
    sf1 = maximum(st1.y, 0.0)

    # 2) unsaturated
    st2 = solve_to(f2, states.unsat, tout, (dm, fs, (sf1, gw0)), cfg)
    us1 = maximum(st2.y, 0.0)

    # 3) groundwater: recharge/exfiltration/ET frozen at the staged states
    cu = _cell_update_split(dm, sf1, us1, gw0)
    es, eu, eg, tu, tg, _, _ = et_flux(dm, fs, sf1, us1, gw0, cu.satn)
    _, qex = flux_infiltration(dm, cu, sf1, us1, gw0, fs.net_prcp)
    q_rech0 = flux_recharge(dm, cu, us1, gw0) * fs.fu_sub
    q_exfil0 = qex * fs.fu_surf
    if has_lake:
        is_lake = dm.i_lake > 0
        q_rech0 = torch.where(is_lake, 0.0, q_rech0)
        q_exfil0 = torch.where(is_lake, 0.0, q_exfil0)
    st3 = solve_to(
        f3, states.gw, tout,
        (dm, fs, (sf1, us1, riv0, q_rech0, q_exfil0, es + eu + eg,
                  tu + tg, lake0)), cfg)
    gw1 = maximum(st3.y, 0.0)

    # 4) river: exchange fluxes frozen at the staged states
    cu1 = _cell_update_split(dm, sf1, us1, gw1)
    qi1, qex1 = flux_infiltration(dm, cu1, sf1, us1, gw1, fs.net_prcp)
    q_if1, q_ex1 = qi1 * fs.fu_surf, qex1 * fs.fu_surf
    if has_lake:
        q_if1 = torch.where(is_lake, 0.0, q_if1)
        q_ex1 = torch.where(is_lake, 0.0, q_ex1)
    q_seg_s = _seg_surface(dm, fs, sf1, q_if1, q_ex1, riv0)
    q_seg_b = _seg_sub(dm, fs, gw1, cu1.eff_kh, riv0)
    q_riv_surf0 = gather_sum(q_seg_s, dm.lists.seg_to_riv)
    q_riv_sub0 = gather_sum(q_seg_b, dm.lists.seg_to_riv)
    st4 = solve_to(f4, states.riv, tout,
                   (dm, fs, (q_riv_surf0, q_riv_sub0)), cfg)

    # 5) lake: element states and river inflow frozen at staged values
    st5 = states.lake
    if has_lake:
        q_rd1 = _riv_down_frozen(dm, fs, maximum(st4.y, 0.0))
        q_lake_rivin0 = gather_sum(q_rd1, dm.lists.riv_to_lake)
        st5 = solve_to(f5, states.lake, tout,
                       (dm, fs, (sf1, us1, gw1, q_lake_rivin0)), cfg)

    return UncoupledStates(surf=st1, unsat=st2, gw=st3, riv=st4, lake=st5)


def _riv_down_frozen(m, fs, riv):
    """Downstream discharge at a frozen river stage (the lake-inflow side
    of Flux_RiverDown; only the to-lake entries are read)."""
    riv_stage = torch.where(m.riv_bc > 0, fs.riv_ybc, riv)
    r_csa, r_hyd = _riv_geometry(m, riv_stage)
    s_out = m.riv_bed_slope + riv_stage * 2.0 / m.riv_length
    return ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_out)


def init_uncoupled(y0: torch.Tensor, ne: int, nr: int, t0: float,
                   cfg: SolverConfig, nl: int = 0) -> UncoupledStates:
    return UncoupledStates(
        surf=bdf_init(t0, y0[:ne], cfg),
        unsat=bdf_init(t0, y0[ne:2 * ne], cfg),
        gw=bdf_init(t0, y0[2 * ne:3 * ne], cfg),
        riv=bdf_init(t0, y0[3 * ne:3 * ne + nr], cfg),
        lake=(bdf_init(t0, y0[3 * ne + nr:3 * ne + nr + nl], cfg)
              if nl > 0 else None),
    )


class _SplitCheckpointShim:
    """The split driver's five solver states behind the ``.bdf/.buckets/
    .cryo/.t`` surface that ``io.checkpoint`` reads (the bdf slot holds a
    dict of the five ``BDFState``s, ``None`` for an absent lake), so a
    ``-g`` checkpoint has the JAX package's keys (``bdf/surf/y``, ...)."""

    def __init__(self, states: UncoupledStates, buckets, t: float):
        self.bdf = {"surf": states.surf, "unsat": states.unsat,
                    "gw": states.gw, "riv": states.riv,
                    "lake": states.lake}
        self.buckets = buckets
        self.cryo = None
        self.t = t

    def states(self) -> UncoupledStates:
        return UncoupledStates(**self.bdf)


def _window_vals(dm, fs, cf, y_dense, ic, snow, close_boundary, per_edge):
    """Channel values at the composed split state — the field set the
    fused driver accumulates — from one diagnostic RHS eval per window
    (the reference's ExportResults semantics)."""
    from shud_tpu_torch.core.rhs import rhs_full

    ne, nr, nl = dm.num_ele, dm.num_riv, dm.num_lake
    _, d = rhs_full(dm, fs, 0.0, y_dense, close_boundary=close_boundary)
    e_ic = d["e_ic"]
    ve = {
        "y_ic": ic, "y_snow": snow,
        "y_surf": y_dense[:ne], "y_unsat": y_dense[ne:2 * ne],
        "y_gw": y_dense[2 * ne:3 * ne],
        "prcp": cf.prcp, "net_prcp": fs.net_prcp, "etp": cf.etp,
        "eta": e_ic + d["es"] + d["eu"] + d["eg"] + d["tu"] + d["tg"],
        "rn_h": cf.rn_h, "rn_t": cf.rn_t, "rn_factor": cf.rn_factor,
        "q_rech": d["q_rech"], "q_sub_tot": d["q_sub_tot"],
        "q_surf_tot": d["q_surf_tot"], "q_e2r_sub": d["q_e2r_sub"],
        "q_e2r_surf": d["q_e2r_surf"], "q_infil": d["q_infil"],
        "q_exfil": d["q_exfil"], "e_ic": e_ic,
        "trans": d["tu"] + d["tg"],
        "evapo": d["es"] + d["eu"] + d["eg"],
    }
    if per_edge:
        for j in range(3):
            ve[f"q_esub{j}"] = d["q_esub"][:, j]
            ve[f"q_esurf{j}"] = d["q_esurf"][:, j]
    vr = {
        "q_riv_up": d["q_riv_up"], "q_riv_down": d["q_riv_down"],
        "q_riv_sub": d["q_riv_sub"], "q_riv_surf": d["q_riv_surf"],
        "y_riv": y_dense[3 * ne:3 * ne + nr],
    }
    vl = {}
    if nl > 0:
        vl = {
            "y_lake": y_dense[3 * ne + nr:],
            "lake_area": d["lake_area"],
            "q_lake_evap": d["q_lake_evap"],
            "q_lake_prcp": d["q_lake_prcp"],
            "q_lake_rivin": d["q_lake_rivin"],
            "q_lake_surf": d["q_lake_surf"],
            "q_lake_sub": d["q_lake_sub"],
            "q_lake_rivout": torch.zeros_like(d["lake_area"]),
        }
    return ve, vr, vl


def _dense(st: UncoupledStates) -> torch.Tensor:
    parts = [st.surf.y, st.unsat.y, st.gw.y, st.riv.y]
    if st.lake is not None:
        parts.append(st.lake.y)
    return torch.cat(parts)


def run_project_split(project: str, base: str = ".", end_day=None,
                      verbose=True, outpath=None, calib=None, inp=None,
                      resume=None, device: "str | torch.device" = "cuda",
                      **overrides) -> UncoupledStates:
    """Operator-split full run (the reference's ``-g`` driver loop,
    shud.cpp:171-357) on *device* (the card unless the caller asks for the
    CPU), in float64: per window, a Gauss-Seidel sweep of the five
    sub-solvers, then the full output stack the reference runs every step
    (``ExportResults`` + ``FloodWarning`` + ``PrintInit``,
    shud.cpp:316-323) through the fused driver's ``IntervalWriter``, flood,
    water-balance, restart and checkpoint machinery, so a ``-g`` run can be
    flood-monitored, budget-checked and resumed.  ``inp`` takes a project
    in memory; ``overrides`` are Control_Data attribute overrides (e.g.
    ``solver_step=60.0``).  A ``cryosphere=1`` project is refused (the
    frozen-ground module runs only in the fused driver).  Returns the
    final ``UncoupledStates``."""
    import os
    import time

    import numpy as np

    from shud_tpu_torch.diag.waterbalance import WaterBalance
    from shud_tpu_torch.driver.run_fast import IntervalWriter, _to_host
    from shud_tpu_torch.driver.simulate import Simulation
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from shud_tpu_torch.io.output import FloodAlert, TimeLog, write_restart
    from shud_tpu_torch.io.project import write_calib
    from shud_tpu_torch.utils.errors import NanError
    from shud_tpu_torch.utils.timectx import TimeContext

    if end_day is not None:
        overrides.setdefault("day_end", end_day)
    sim = Simulation.create(project, base=base, float_dtype=torch.float64,
                            calib=calib, device=device, inp=inp,
                            **overrides)
    if outpath:
        sim.inp.paths.outpath = outpath
    cs = sim.inp.control
    md, dm = sim.md, sim.dm
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    paths = sim.inp.paths
    os.makedirs(paths.outpath, exist_ok=True)
    t_end = cs.end_time if end_day is None else end_day * 1440.0
    cb = bool(cs.close_boundary)

    states = init_uncoupled(sim.bdf.y, ne, nr, cs.start_time, sim.cfg, nl=nl)
    if resume:
        shim = _SplitCheckpointShim(states, sim.buckets, sim.t)
        load_checkpoint(resume, shim)
        states = shim.states()
        sim.buckets = shim.buckets
        sim.t = float(shim.t)
        if verbose:
            print(f"resumed from {resume} at t={sim.t/1440.0:.2f} days")

    writer = IntervalWriter(sim)
    interval = writer.interval
    flood = FloodAlert(
        os.path.join(paths.outpath, f"{paths.project}.flood.csv"),
        md.riv_depth,
    )
    tlog = TimeLog(os.path.join(paths.outpath, f"{paths.project}.time.csv"))
    wb = WaterBalance(
        md, os.path.join(paths.outpath, f"{paths.project}.wb.basin.csv"))
    write_calib(sim.inp.calib,
                os.path.join(paths.outpath,
                             f"{paths.project}.cfg.calib.bak"))
    paths.save_project_file()
    if os.environ.get("SHUD_DEBUG_TABLES", "0") not in ("0", ""):
        from shud_tpu_torch.io.debugtables import write_debug_tables

        write_debug_tables(md, sim.inp, paths.outpath)

    per_edge = bool(cs.dt_Qe_subx > 0 or cs.dt_Qe_surfx > 0)

    def _restart(path, t, host_y, ic, snow):
        write_restart(
            path, t, ic, snow, host_y[:ne], host_y[ne:2 * ne],
            host_y[2 * ne:3 * ne], host_y[3 * ne:3 * ne + nr],
            host_y[3 * ne + nr:] if nl else None,
        )

    host0 = _to_host({"y": _dense(states), "ic": sim.buckets.ic_stg,
                      "snow": sim.buckets.snow})
    _restart(os.path.join(paths.outpath, f"{paths.project}.cfg.ic.bak"),
             0.0, host0["y"], host0["ic"], host0["snow"])

    tc = TimeContext(sim.inp.forc.start_yyyymmdd)
    wall0 = time.time()
    cpu0 = time.process_time()
    last_nfe = 0
    t = sim.t
    step = cs.solver_step
    y_host, bk_host = host0["y"], (host0["ic"], host0["snow"])
    while t < t_end - 1e-9:
        this_int = min(interval, t_end - t)
        t0, y0, bk0 = t, y_host, bk_host
        acc_e = acc_r = acc_l = None
        nwin = 0
        while t < t0 + this_int - 1e-9:
            tout = min(t + step, t0 + this_int)
            fs, cf = sim.forcing_slice(tout)
            states = advance_window_uncoupled(dm, fs, states, t, tout,
                                              sim.cfg, close_boundary=cb)
            t = tout
            y_dense = _dense(states)
            ve, vr, vl = _window_vals(dm, fs, cf, y_dense,
                                      sim.buckets.ic_stg, sim.buckets.snow,
                                      cb, per_edge)
            # one batched fetch per window (as the per-window driver)
            host = _to_host({"e": ve, "r": vr, "l": vl, "y": y_dense})
            nwin += 1
            if acc_e is None:
                acc_e, acc_r, acc_l = host["e"], host["r"], host["l"]
            else:
                acc_e = {k: acc_e[k] + host["e"][k] for k in acc_e}
                acc_r = {k: acc_r[k] + host["r"][k] for k in acc_r}
                acc_l = {k: acc_l[k] + host["l"][k] for k in acc_l}
            flood.check(t, host["r"]["y_riv"], host["r"]["q_riv_down"])
        y_host = host["y"]
        bk_host = (host["e"]["y_ic"], host["e"]["y_snow"])
        mean_e = {k: v / nwin for k, v in acc_e.items()}
        mean_r = {k: v / nwin for k, v in acc_r.items()}
        mean_l = {k: v / nwin for k, v in acc_l.items()}
        writer.write(t, mean_e, mean_r, mean_l)
        wb.interval(t0, t, y0, y_host, mean_e, mean_r, buckets0=bk0,
                    buckets1=bk_host, mean_lake=mean_l if nl else None)
        nfe = sum(s.nfe for s in
                  (states.surf, states.unsat, states.gw, states.riv)) \
            + (states.lake.nfe if nl else 0)
        perc = 100.0 * (t - cs.start_time) / (t_end - cs.start_time)
        if verbose:
            print(f"{tc.iso(t)}\t{t/1440.0:8.2f} day\t{perc:6.2f}%\t"
                  f"{time.time()-wall0:8.2f} s\t{nfe - last_nfe}\t(split)",
                  flush=True)
        tlog.write(t, perc, time.process_time() - cpu0,
                   time.time() - wall0, nfe - last_nfe)
        last_nfe = nfe
        if int(t) % cs.update_ic_step == 0 or t >= t_end - 1e-9:
            if not np.isfinite(y_host).all():
                bad = int(np.flatnonzero(~np.isfinite(y_host))[0])
                raise NanError(
                    f"non-finite state at t={t:.1f} min (index {bad})")
            _restart(
                os.path.join(paths.outpath,
                             f"{paths.project}.cfg.ic.update"),
                t, y_host, bk_host[0], bk_host[1])
            save_checkpoint(
                os.path.join(paths.outpath, f"{paths.project}.ckpt.npz"),
                _SplitCheckpointShim(states, sim.buckets, t))
    writer.close()
    flood.close()
    tlog.close()
    wb.close()
    if verbose:
        print(f"\nFinal stats (split): nfe_total={nfe} "
              f"(surf {states.surf.nfe}, unsat {states.unsat.nfe},"
              f" gw {states.gw.nfe}, riv {states.riv.nfe}"
              + (f", lake {states.lake.nfe}" if nl else "")
              + f"); wall {time.time()-wall0:.1f} s")
    return states
