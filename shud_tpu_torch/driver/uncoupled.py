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
one and no CUDA kernel runs on this path.  Each Newton iteration of a
sub-solve linearizes its sub-RHS once, as JAX calls ``jax.linearize``:
``linearize_surf`` ... ``linearize_lake`` run the sub-RHS's primal once
and return its J·v as tensor arithmetic on the kept chain-rule factors
(``advance_window_uncoupled(..., linearize=False)`` takes
``torch.func.jvp`` of the sub-RHS per Krylov vector instead, the
reference route).  On the card each window's sweep, the five solves and
the window's values, is one launch of a captured CUDA graph
(``SplitGraph``), as JAX runs each sub-solve as one jit; the host reads
the device once a window.  Every ``segment_sum`` of the JAX module is a
fixed-width gather list of the mesh (``device.gather_sum``), as in
``core/rhs.py``, so the sums are deterministic on the card.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch
from torch.utils import _pytree as pytree

from shud_tpu_torch.config import EPSILON, GRAV, ZERO
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core.device import gather_sum
from shud_tpu_torch.core.edge import edge_apply_plain
from shud_tpu_torch.core.physics import maximum
from shud_tpu_torch.core.rhs import (
    _cell_update_lin,
    _lake_bank_lin,
    _lake_lin,
    _lake_toparea,
    _reach_lin,
    _vertical_lin,
    edge_fluxes,
    et_flux,
    flux_infiltration,
    flux_recharge,
    lake_cell_update,
    update_element,
)
from shud_tpu_torch.core.state import ForcingSlice
from shud_tpu_torch.solver import bdf
from shud_tpu_torch.solver import graph as graph_mod
from shud_tpu_torch.solver.bdf import (
    COUNTS, STEPS, SolverConfig, bdf_init, from_carry, functions, scalars,
    solve_to, to_carry)
from shud_tpu_torch.solver.graph import (
    Program, SolverPieces, clone, copy_into)

PARTS = ("surf", "unsat", "gw", "riv", "lake")
# each solver's scalars in SplitGraph's output buffer (bdf.scalars)
N_SCALARS = len(STEPS) + len(COUNTS)


def _seg_surface(m, fs, sf, q_infil, q_exfil, riv_stage):
    se, sr = m.seg_ele, m.seg_riv
    seg_isf = maximum(sf[se] - q_infil[se] + q_exfil[se], 0.0)
    zs_e = m.z_surf[se]
    return ph.weir_flow_jtoi(
        zs_e, seg_isf, zs_e - m.riv_depth[sr], riv_stage[sr],
        zs_e, m.seg_cwr, m.seg_length, m.depression[se],
    )


def _seg_sub_args(m, gw, effkh, riv_stage):
    """``flux_r2e_gw``'s arguments at each segment (absolute heads)."""
    se, sr = m.seg_ele, m.seg_riv
    zs_e = m.z_surf[se]
    return (riv_stage[sr], zs_e - m.riv_depth[sr], gw[se], m.z_bottom[se],
            effkh[se], m.riv_ksat_h[sr], m.seg_length, m.riv_bed_thick[sr])


def _seg_sub(m, fs, gw, effkh, riv_stage):
    return ph.flux_r2e_gw(*_seg_sub_args(m, gw, effkh, riv_stage)) \
        * fs.fu_sub[m.seg_ele]


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


def _lake_mask(m, x, zero=0.0):
    """*x* with lake cells' rows set to *zero* (cells [Ne] or edges
    [Ne,3]); unchanged on a mesh without lakes."""
    if m.num_lake == 0:
        return x
    lake = m.i_lake > 0
    return torch.where(lake if x.dim() == 1 else lake[:, None], zero, x)


# Each sub-RHS is a body that also returns what its linearization reads;
# given a list as *coeffs* its edge fluxes come from the coefficient
# function (rhs.edge_fluxes), whose flux values are the primal's.


def _surf(m, fs, sf, us0, gw0, riv0, lake0, close_boundary, coeffs=None):
    sf = maximum(sf, 0.0)  # f_updatei clamps (MD_update.cpp:49-53)
    cu = _cell_update_split(m, sf, us0, gw0)
    qi, qex = flux_infiltration(m, cu, sf, us0, gw0, fs.net_prcp)
    q_infil = _lake_mask(m, qi * fs.fu_surf)
    q_exfil = _lake_mask(m, qex * fs.fu_surf)
    lake_stg = _frozen_lake(m, lake0, sf)
    q_esurf, _, _, _ = edge_fluxes(m, cu, sf, gw0, lake_stg, close_boundary,
                                   coeffs=coeffs)
    q_esurf = _lake_mask(m, q_esurf)
    q_seg = _seg_surface(m, fs, sf, q_infil, q_exfil, riv0)
    q_e2r = gather_sum(-q_seg, m.lists.seg_to_ele)
    q_tot = q_e2r + q_esurf.sum(dim=1)
    dsf = fs.net_prcp - q_infil + q_exfil - q_tot / m.area
    dsf = dsf + torch.where(m.i_ss > 0, fs.ele_qss / m.area, 0.0)
    return _lake_mask(m, dsf), (sf, cu, q_infil, q_exfil, lake_stg)


def rhs_surf(m, fs: ForcingSlice, t, sf, us0, gw0, riv0, lake0=None,
             close_boundary=True):
    """d(sf)/dt with us/gw/riv/lake frozen (f_surf: f_loop1 +
    f_applyDYi(1))."""
    return _surf(m, fs, sf, us0, gw0, riv0, lake0, close_boundary)[0]


def _unsat(m, fs, us, sf0, gw0):
    us = maximum(us, 0.0)
    cu = _cell_update_split(m, sf0, us, gw0)
    es, eu, eg, tu, tg, _, ibeta = et_flux(m, fs, sf0, us, gw0, cu.satn)
    qi, qex = flux_infiltration(m, cu, sf0, us, gw0, fs.net_prcp)
    q_infil = qi * fs.fu_surf
    q_rech = flux_recharge(m, cu, us, gw0) * fs.fu_sub
    evapo = es + eu + eg
    trans = tu + tg
    dus = q_infil - q_rech - evapo
    dus = dus - torch.where(gw0 > m.rootreach_level, 0.0, trans)
    return _lake_mask(m, dus) / m.sy, (us, cu, ibeta)


def rhs_unsat(m, fs: ForcingSlice, t, us, sf0, gw0, close_boundary=True):
    """d(us)/dt (f_unsat: f_loop2 + f_applyDYi(2))."""
    return _unsat(m, fs, us, sf0, gw0)[0]


def _gw(m, fs, gw, sf0, us0, riv0, q_rech0, q_exfil0, evapo0, trans0, lake0,
        close_boundary, coeffs=None):
    gw_c = maximum(gw, 0.0)
    gw_bc = torch.where(m.i_bc > 0, fs.ele_ybc, gw_c)
    cu = _cell_update_split(m, sf0, us0, gw_bc)
    lake_stg = _frozen_lake(m, lake0, gw)
    _, q_esub, _, _ = edge_fluxes(m, cu, sf0, gw_bc, lake_stg, close_boundary,
                                  coeffs=coeffs)
    q_esub = _lake_mask(m, q_esub * fs.fu_sub[:, None])
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
    return _lake_mask(m, dgw) / m.sy, (gw_bc, cu, lake_stg)


def rhs_gw(m, fs: ForcingSlice, t, gw, sf0, us0, riv0, q_rech0, q_exfil0,
           evapo0, trans0, lake0=None, close_boundary=True):
    """d(gw)/dt with frozen recharge/exfiltration (f_gw: f_loop3 +
    f_applyDY_gw)."""
    return _gw(m, fs, gw, sf0, us0, riv0, q_rech0, q_exfil0, evapo0, trans0,
               lake0, close_boundary)[0]


def _lake(m, fs, lake_stg, sf0, us0, gw0, q_lake_rivin0, close_boundary):
    lake_c = maximum(lake_stg, 0.0)
    # Dirichlet-BC cells contribute lake-bank fluxes at the prescribed
    # head, as rhs_full/rhs_gw do before edge_fluxes
    gw_bc = torch.where(m.i_bc > 0, fs.ele_ybc, gw0)
    cu = _cell_update_split(m, sf0, us0, gw_bc)
    is_lake = m.i_lake > 0
    _, _, q_lake_surf_e, q_lake_sub_e = edge_fluxes(
        m, cu, sf0, gw_bc, lake_c, close_boundary)
    # lake cells have no lateral fluxes (fun_Ele_lakeHorizon)
    q_lake_surf_e = _lake_mask(m, q_lake_surf_e)
    q_lake_sub_e = _lake_mask(m, q_lake_sub_e)
    lists = m.lists
    q_lake_surf = gather_sum(q_lake_surf_e.reshape(-1), lists.edge_to_lake)
    q_lake_sub = gather_sum(q_lake_sub_e.reshape(-1), lists.edge_to_lake)
    lk_cell = torch.where(is_lake, m.i_lake - 1, 0)
    inv_nele = 1.0 / maximum(m.lake_num_ele.to(lake_c.dtype), 1.0)
    q_lake_evap_raw = gather_sum(
        torch.where(is_lake, fs.pot_evap * inv_nele[lk_cell], 0.0),
        lists.cell_to_lake)
    q_lake_prcp = gather_sum(
        torch.where(is_lake, fs.prcp * inv_nele[lk_cell], 0.0),
        lists.cell_to_lake)
    # clamp (MD_f.cpp:44-47): min first, then max — not clip
    q_lake_evap = maximum(
        torch.minimum(q_lake_evap_raw, q_lake_prcp + lake_c), 0.0)
    lake_area = _lake_toparea(m, lake_c)
    inflow = q_lake_rivin0 + q_lake_sub + q_lake_surf
    dl = q_lake_prcp - q_lake_evap + inflow / lake_area
    return dl, (lake_c, gw_bc, cu, q_lake_evap_raw, q_lake_prcp, inflow,
                lake_area)


def rhs_lake(m, fs: ForcingSlice, t, lake_stg, sf0, us0, gw0, q_lake_rivin0,
             close_boundary=True):
    """d(lake stage)/dt with element/river states frozen (the real 5th
    sub-solve; implicit-mode budget MD_f.cpp:180-191)."""
    return _lake(m, fs, lake_stg, sf0, us0, gw0, q_lake_rivin0,
                 close_boundary)[0]


def _riv_geometry(m, riv_stage):
    """(cross-section area, wetted perimeter, hydraulic radius) of each
    reach at a stage."""
    r_csa = maximum(
        riv_stage * (m.riv_bottom_width + riv_stage * m.riv_bank_slope), 0.0)
    r_per = maximum(
        2.0 * ph.absolute(riv_stage) * torch.sqrt(1.0 + m.riv_bank_slope**2)
        + m.riv_bottom_width, 0.0)
    r_hyd = torch.where(r_per <= ZERO, 0.0,
                        r_csa / torch.where(r_per <= ZERO, 1.0, r_per))
    return r_csa, r_per, r_hyd


def _river(m, fs, riv, q_riv_surf0, q_riv_sub0):
    riv_c = maximum(riv, 0.0)
    riv_stage = torch.where(m.riv_bc > 0, fs.riv_ybc, riv_c)
    r_csa, r_per, r_hyd = _riv_geometry(m, riv_stage)
    eqw_raw = 0.5 * (riv_stage * m.riv_bank_slope * 2.0
                     + 2.0 * m.riv_bottom_width)
    top_raw = maximum(eqw_raw, 0.0) * m.riv_length
    top_area = maximum(top_raw, 1e-12)

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
    return torch.where(m.riv_bc > 0, 0.0, driv), (
        riv_stage, r_csa, r_per, r_hyd, s_down, s_out, eqw_raw, top_raw,
        top_area, driv)


def rhs_river(m, fs: ForcingSlice, t, riv, q_riv_surf0, q_riv_sub0):
    """d(stage)/dt with frozen exchange fluxes (f_river: f_loop4 +
    f_applyDYi(4)); dV -> dStage via the top area."""
    return _river(m, fs, riv, q_riv_surf0, q_riv_sub0)[0]


# ---------------------------------------------------------------------------
# hand linearizations: (f(y), v -> J(y)·v), f run once, the chain-rule
# factors and branch masks kept as tensors (rhs.linearize's contract and
# jax.jvp's conventions: 0.5 at a maximum/minimum tie, +1 for |x| at 0,
# where selects, no tangent across a switch); each sub-RHS's tangent is in
# its own state only, the frozen inputs carry none
# ---------------------------------------------------------------------------


def linearize_surf(m, fs: ForcingSlice, t, sf, us0, gw0, riv0, lake0=None,
                   close_boundary=True):
    """``rhs_surf`` linearized in sf: the clamp (0.5 where sf == 0, which
    every dry cell is), infiltration, the edge surface flux from its
    coefficients (no gw or eff_kh tangent), the lake-bank weir, the
    segment weir through ``sf - q_infil + q_exfil``."""
    coeffs = []
    dsf, (sfc, cu, q_infil, q_exfil, lake_stg) = _surf(
        m, fs, sf, us0, gw0, riv0, lake0, close_boundary, coeffs)
    m0 = ph.d_max(sf, 0.0)
    c = _cell_update_lin(m, sfc, us0, gw0)
    ibeta = et_flux(m, fs, sfc, us0, gw0, cu.satn)[6]
    v = _vertical_lin(m, fs, sfc, us0, gw0, cu, ibeta, c)
    qi_sf, qx_sf = v["qi"]["sf"], v["qx"]["sf"]
    se, sr = m.seg_ele, m.seg_riv
    isf_raw = sfc[se] - q_infil[se] + q_exfil[se]
    zs_e = m.z_surf[se]
    w_i, _ = ph.weir_flow_jtoi_lin(
        zs_e, maximum(isf_raw, 0.0), zs_e - m.riv_depth[sr], riv0[sr], zs_e,
        m.seg_cwr, m.seg_length, m.depression[se])
    b_sf = w_i * ph.d_max(isf_raw, 0.0) * (1.0 - qi_sf + qx_sf)[se]
    if m.num_lake > 0:
        ls_sf = _lake_bank_lin(m, sfc, gw0, lake_stg, cu.eff_kh,
                               c["kh_gw"])[0]
    zero = torch.zeros_like(sf)
    et, lists, area = m.edge_tables, m.lists, m.area

    def jvp(vec):
        ts = m0 * vec
        tqs, _ = edge_apply_plain(coeffs, ts, zero, zero, et)
        if m.num_lake > 0:
            tqs = torch.where(m.has_lake, ls_sf * ts[:, None], tqs)
        tqs = _lake_mask(m, tqs)
        t_tot = gather_sum(-(b_sf * ts[se]), lists.seg_to_ele) + tqs.sum(1)
        return _lake_mask(m, (qx_sf - qi_sf) * ts - t_tot / area)

    return dsf, jvp


def linearize_unsat(m, fs: ForcingSlice, t, us, sf0, gw0,
                    close_boundary=True):
    """``rhs_unsat`` linearized in us: satn and theta through
    ``_cell_update_lin``, infiltration, recharge and ET through
    ``_vertical_lin``, the ``gw0 > rootreach_level`` mask a constant.  Each
    cell's rate depends on its own us only: J is diagonal."""
    dus, (usc, cu, ibeta) = _unsat(m, fs, us, sf0, gw0)
    c = _cell_update_lin(m, sf0, usc, gw0)
    v = _vertical_lin(m, fs, sf0, usc, gw0, cu, ibeta, c)
    d = (v["qi"]["us"] - v["qr"]["us"]
         - (v["es"]["us"] + v["eu"]["us"] + v["eg"]["us"])
         - torch.where(gw0 > m.rootreach_level, 0.0,
                       v["tu"]["us"] + v["tg"]["us"]))
    diag = _lake_mask(m, d) * ph.d_max(us, 0.0) / m.sy
    return dus, lambda vec: diag * vec


def linearize_gw(m, fs: ForcingSlice, t, gw, sf0, us0, riv0, q_rech0,
                 q_exfil0, evapo0, trans0, lake0=None, close_boundary=True):
    """``rhs_gw`` linearized in gw: recharge, exfiltration and ET frozen
    (no tangent), head-BC cells fixed (tangent 0), the wetland and
    root-reach masks switches; the edge subsurface flux from its
    coefficients with eff_kh's tangent ``kh_gw·t_gw``, the lake-bank Darcy
    flux and the river-bed exchange."""
    coeffs = []
    dgw, (gw_bc, cu, lake_stg) = _gw(
        m, fs, gw, sf0, us0, riv0, q_rech0, q_exfil0, evapo0, trans0, lake0,
        close_boundary, coeffs)
    k_gw = torch.where(m.i_bc > 0, 0.0, ph.d_max(gw, 0.0))
    kh_gw = _cell_update_lin(m, sf0, us0, gw_bc)["kh_gw"]
    if m.num_lake > 0:
        _, _, lb_gw, half_k, _ = _lake_bank_lin(m, sf0, gw_bc, lake_stg,
                                                cu.eff_kh, kh_gw)
        lb_gwn = half_k * kh_gw[m.nb]
    se = m.seg_ele
    _, r_ye, r_k = ph.flux_r2e_gw_lin(*_seg_sub_args(m, gw_bc, cu.eff_kh,
                                                     riv0))
    sb_gw = (r_ye + r_k * kh_gw[se]) * fs.fu_sub[se]
    keep = _lake_mask(m, m.i_bc <= 0, False)
    zero = torch.zeros_like(gw)
    et, lists, nb, fu_sub = m.edge_tables, m.lists, m.nb, fs.fu_sub

    def jvp(vec):
        tg = k_gw * vec
        _, tqb = edge_apply_plain(coeffs, zero, tg, kh_gw * tg, et)
        if m.num_lake > 0:
            tqb = torch.where(m.has_lake,
                              lb_gw * tg[:, None] + lb_gwn * tg[nb], tqb)
        tqb = _lake_mask(m, tqb * fu_sub[:, None])
        t_tot = gather_sum(-(sb_gw * tg[se]), lists.seg_to_ele) + tqb.sum(1)
        return torch.where(keep, -t_tot / m.area, 0.0) / m.sy

    return dgw, jvp


def linearize_river(m, fs: ForcingSlice, t, riv, q_riv_surf0, q_riv_sub0):
    """``rhs_river`` linearized in the stage: Manning down the chain and
    the outlets (``rhs._reach_lin``), dV -> dstage by the top area, whose
    own derivative comes through r_eqw (clamped at 1e-12); stage-BC
    reaches 0, the frozen exchange fluxes without tangent."""
    driv, (rs, r_csa, r_per, r_hyd, s_down, s_out, eqw_raw, top_raw,
           top_area, driv_raw) = _river(m, fs, riv, q_riv_surf0, q_riv_sub0)
    k_rs = torch.where(m.riv_bc > 0, 0.0, ph.d_max(riv, 0.0))
    _, p_self, p_dn = _reach_lin(m, rs, r_csa, r_per, r_hyd, s_down, s_out)
    top_rs = (ph.d_max(top_raw, 1e-12) * m.riv_length
              * ph.d_max(eqw_raw, 0.0) * m.riv_bank_slope)
    c_top = driv_raw * top_rs
    keep = m.riv_bc <= 0
    dn = torch.where(m.riv_down >= 0, m.riv_down, 0)
    to_down = m.lists.riv_to_down

    def jvp(vec):
        tr = k_rs * vec
        t_down = p_self * tr + p_dn * tr[dn]
        t_num = gather_sum(t_down, to_down) - t_down
        return torch.where(keep, (t_num - c_top * tr) / top_area, 0.0)

    return driv, jvp


def linearize_lake(m, fs: ForcingSlice, t, lake_stg, sf0, us0, gw0,
                   q_lake_rivin0, close_boundary=True):
    """``rhs_lake`` linearized in the lake stage: the lake-bank surface
    and subsurface fluxes (``rhs._lake_bank_lin``'s d/d lake stage), the
    evaporation clamp (min, then max) and the division by the top area
    (``rhs._lake_lin``)."""
    dl, (lake_c, gw_bc, cu, ev_raw, prcp, inflow, area) = _lake(
        m, fs, lake_stg, sf0, us0, gw0, q_lake_rivin0, close_boundary)
    k_lk = ph.d_max(lake_stg, 0.0)
    _, ls_lk, _, _, lb_lk = _lake_bank_lin(m, sf0, gw_bc, lake_c, cu.eff_kh,
                                           torch.zeros_like(gw_bc))
    lake_edge = m.has_lake & (m.i_lake <= 0)[:, None]
    c_lk = _lake_lin(m, lake_c, ev_raw, prcp, inflow, area)
    inv_area = 1.0 / area
    lk, to_lake = m.lk, m.lists.edge_to_lake

    def jvp(vec):
        tl = k_lk * vec
        tlk = tl[lk]
        t_in = (gather_sum(torch.where(lake_edge, lb_lk * tlk, 0.0)
                           .reshape(-1), to_lake)
                + gather_sum(torch.where(lake_edge, ls_lk * tlk, 0.0)
                             .reshape(-1), to_lake))
        return t_in * inv_area + c_lk * tl

    return dl, jvp


@dataclasses.dataclass
class UncoupledStates:
    surf: object
    unsat: object
    gw: object
    riv: object
    lake: object = None  # None when the mesh has no lakes


def _adapters(close_boundary: bool, surf, unsat, gw, river, lake):
    """``solve_to``'s ``(t, y, params)`` adapters of the five sub-solves'
    *surf* ... *lake* (the sub-RHS, or their linearizations, which take
    the same arguments): the frozen stage states ride in the params
    tuple."""

    def f1(tt, yy, p):
        dm, fs, (us0, gw0, riv0, lake0) = p
        return surf(dm, fs, tt, yy, us0, gw0, riv0, lake0, close_boundary)

    def f2(tt, yy, p):
        dm, fs, (sf1, gw0) = p
        return unsat(dm, fs, tt, yy, sf1, gw0, close_boundary)

    def f3(tt, yy, p):
        dm, fs, (sf1, us1, riv0, q_rech0, q_exfil0, evapo0, trans0,
                 lake0) = p
        return gw(dm, fs, tt, yy, sf1, us1, riv0, q_rech0, q_exfil0, evapo0,
                  trans0, lake0, close_boundary)

    def f4(tt, yy, p):
        dm, fs, (q_riv_surf0, q_riv_sub0) = p
        return river(dm, fs, tt, yy, q_riv_surf0, q_riv_sub0)

    def f5(tt, yy, p):
        dm, fs, (sf1, us1, gw1, q_lake_rivin0) = p
        return lake(dm, fs, tt, yy, sf1, us1, gw1, q_lake_rivin0,
                    close_boundary)

    return f1, f2, f3, f4, f5


# one set per close_boundary, as the JAX module's, whose identities keep
# its jit cache
@lru_cache(maxsize=None)
def _split_fns(close_boundary: bool):
    return _adapters(close_boundary, rhs_surf, rhs_unsat, rhs_gw, rhs_river,
                     rhs_lake)


@lru_cache(maxsize=None)
def _split_lins(close_boundary: bool):
    return _adapters(close_boundary, linearize_surf, linearize_unsat,
                     linearize_gw, linearize_river, linearize_lake)


# the glue between the sub-solves: what each holds fixed, computed from
# the staged states (shared by the eager sweep and SplitGraph)


def _gw_frozen(dm, fs, sf1, us1, gw0, has_lake):
    """Recharge, exfiltration, evaporation and transpiration at the staged
    states: the groundwater solve's frozen inputs."""
    cu = _cell_update_split(dm, sf1, us1, gw0)
    es, eu, eg, tu, tg, _, _ = et_flux(dm, fs, sf1, us1, gw0, cu.satn)
    _, qex = flux_infiltration(dm, cu, sf1, us1, gw0, fs.net_prcp)
    q_rech0 = flux_recharge(dm, cu, us1, gw0) * fs.fu_sub
    q_exfil0 = qex * fs.fu_surf
    if has_lake:
        q_rech0 = _lake_mask(dm, q_rech0)
        q_exfil0 = _lake_mask(dm, q_exfil0)
    return q_rech0, q_exfil0, es + eu + eg, tu + tg


def _riv_frozen(dm, fs, sf1, us1, gw1, riv0, has_lake):
    """The segments' surface and bed exchange per reach at the staged
    states: the river solve's frozen inputs."""
    cu1 = _cell_update_split(dm, sf1, us1, gw1)
    qi1, qex1 = flux_infiltration(dm, cu1, sf1, us1, gw1, fs.net_prcp)
    q_if1, q_ex1 = qi1 * fs.fu_surf, qex1 * fs.fu_surf
    if has_lake:
        q_if1, q_ex1 = _lake_mask(dm, q_if1), _lake_mask(dm, q_ex1)
    q_seg_s = _seg_surface(dm, fs, sf1, q_if1, q_ex1, riv0)
    q_seg_b = _seg_sub(dm, fs, gw1, cu1.eff_kh, riv0)
    return (gather_sum(q_seg_s, dm.lists.seg_to_riv),
            gather_sum(q_seg_b, dm.lists.seg_to_riv))


def _lake_inflow(dm, fs, riv):
    """Each lake's river inflow at the river solve's end state: the lake
    solve's frozen input."""
    q_rd1 = _riv_down_frozen(dm, fs, maximum(riv, 0.0))
    return gather_sum(q_rd1, dm.lists.riv_to_lake)


def advance_window_uncoupled(dm, fs: ForcingSlice, states: UncoupledStates,
                             t: float, tout: float, cfg: SolverConfig,
                             close_boundary=True, linearize=True,
                             solver_kernel: bool = True) -> UncoupledStates:
    """One Gauss-Seidel sweep: surf -> unsat -> gw -> river -> lake, each
    advanced over [t, tout] by its own adaptive implicit solver instance.
    *linearize*: each Newton iteration linearizes the sub-RHS once through
    its hand linearization (``linearize_surf`` ...), as JAX calls
    ``jax.linearize``; False takes ``torch.func.jvp`` of the sub-RHS per
    Krylov vector (``solve_to``'s default, the reference route).
    *solver_kernel*: each solve's step body through the solver kernels
    (``solve_to``'s)."""
    has_lake = dm.num_lake > 0 and states.lake is not None
    f1, f2, f3, f4, f5 = _split_fns(bool(close_boundary))
    l1, l2, l3, l4, l5 = (_split_lins(bool(close_boundary)) if linearize
                          else (None,) * 5)

    us0 = maximum(states.unsat.y, 0.0)
    gw0 = maximum(states.gw.y, 0.0)
    riv0 = maximum(states.riv.y, 0.0)
    lake0 = maximum(states.lake.y, 0.0) if has_lake else None

    # 1) surface
    st1 = solve_to(f1, states.surf, tout,
                   (dm, fs, (us0, gw0, riv0, lake0)), cfg, linearize=l1,
                   solver_kernel=solver_kernel)
    sf1 = maximum(st1.y, 0.0)

    # 2) unsaturated
    st2 = solve_to(f2, states.unsat, tout, (dm, fs, (sf1, gw0)), cfg,
                   linearize=l2, solver_kernel=solver_kernel)
    us1 = maximum(st2.y, 0.0)

    # 3) groundwater: recharge/exfiltration/ET frozen at the staged states
    st3 = solve_to(
        f3, states.gw, tout,
        (dm, fs, (sf1, us1, riv0,
                  *_gw_frozen(dm, fs, sf1, us1, gw0, has_lake), lake0)),
        cfg, linearize=l3, solver_kernel=solver_kernel)
    gw1 = maximum(st3.y, 0.0)

    # 4) river: exchange fluxes frozen at the staged states
    st4 = solve_to(f4, states.riv, tout,
                   (dm, fs, _riv_frozen(dm, fs, sf1, us1, gw1, riv0,
                                        has_lake)), cfg, linearize=l4,
                   solver_kernel=solver_kernel)

    # 5) lake: element states and river inflow frozen at staged values
    st5 = states.lake
    if has_lake:
        st5 = solve_to(f5, states.lake, tout,
                       (dm, fs, (sf1, us1, gw1, _lake_inflow(dm, fs, st4.y))),
                       cfg, linearize=l5, solver_kernel=solver_kernel)

    return UncoupledStates(surf=st1, unsat=st2, gw=st3, riv=st4, lake=st5)


def _riv_down_frozen(m, fs, riv):
    """Downstream discharge at a frozen river stage (the lake-inflow side
    of Flux_RiverDown; only the to-lake entries are read)."""
    riv_stage = torch.where(m.riv_bc > 0, fs.riv_ybc, riv)
    r_csa, _, r_hyd = _riv_geometry(m, riv_stage)
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


def sweep_window(dm, fs, cf, buckets, states: UncoupledStates, t, tout,
                 cfg: SolverConfig, close_boundary=True, per_edge=False,
                 linearize=True, solver_kernel: bool = True):
    """One window of the eager loop: ``advance_window_uncoupled``, then the
    window's values at the composed state (``_window_vals``), fetched with
    the state in one transfer.  Returns (states, host values ``{"e", "r",
    "l", "y"}``)."""
    from shud_tpu_torch.driver.run_fast import _to_host

    states = advance_window_uncoupled(dm, fs, states, t, tout, cfg,
                                      close_boundary, linearize,
                                      solver_kernel)
    y = _dense(states)
    ve, vr, vl = _window_vals(dm, fs, cf, y, buckets.ic_stg, buckets.snow,
                              close_boundary, per_edge)
    return states, _to_host({"e": ve, "r": vr, "l": vl, "y": y})


class SplitPieces:
    """The pieces of ``SplitGraph``'s program over its static buffers: the
    window's forcing, cell forcing and buckets; the five solvers
    (``solver/graph.SolverPieces``, named ``surf_begin`` ...; one ``tout``
    for all); the frozen inputs of each sub-solve; ``out``, one float64
    buffer of each solver's scalars, the composed state and the window's
    values.  The glue pieces between the solves compute what
    ``advance_window_uncoupled`` computes there, then start the next
    solve (its step count at the window's start, its Newton iterations
    zeroed, ``active``).  Nothing here refers to the program that runs the
    pieces, so that dropping the graph frees it."""

    def __init__(self, dm, cfg: SolverConfig, close_boundary: bool,
                 per_edge: bool, fs, cf, buckets, states: UncoupledStates,
                 solver_kernel: bool = True):
        self.dm, self.cb, self.per_edge = dm, close_boundary, per_edge
        self.has_lake = dm.num_lake > 0 and states.lake is not None
        y = states.surf.y
        self.fs, self.cf, self.bk = clone(fs), clone(cf), clone(buckets)
        self.tout = torch.zeros((), dtype=y.dtype, device=y.device)
        ne, nr = dm.num_ele, dm.num_riv
        nl = states.lake.y.numel() if self.has_lake else 0
        (self.us0, self.gw0, self.sf1, self.us1, self.gw1, self.q_rech0,
         self.q_exfil0, self.evapo0, self.trans0) = (
            y.new_zeros(ne) for _ in range(9))
        self.riv0, self.q_riv_surf0, self.q_riv_sub0 = (
            y.new_zeros(nr) for _ in range(3))
        self.lake0 = y.new_zeros(nl) if self.has_lake else None
        self.q_lake_rivin0 = y.new_zeros(nl)
        frozen = {
            "surf": (self.us0, self.gw0, self.riv0, self.lake0),
            "unsat": (self.sf1, self.gw0),
            "gw": (self.sf1, self.us1, self.riv0, self.q_rech0,
                   self.q_exfil0, self.evapo0, self.trans0, self.lake0),
            "riv": (self.q_riv_surf0, self.q_riv_sub0),
            "lake": (self.sf1, self.us1, self.gw1, self.q_lake_rivin0)}
        self.solvers = {}
        for k, f, lin in zip(PARTS, _split_fns(close_boundary),
                             _split_lins(close_boundary)):
            if k == "lake" and not self.has_lake:
                continue
            params = (dm, self.fs, frozen[k])
            rhs, ln = functions(f, params, lin)
            self.solvers[k] = SolverPieces(
                rhs, ln, cfg, None, params,
                clone(to_carry(getattr(states, k))), prefix=k + "_",
                tout=self.tout, kernel=solver_kernel)
        # the window's values: their layout from one eager evaluation
        leaves, self.spec = pytree.tree_flatten(self.values())
        self.shapes = [x.shape for x in leaves]
        self.out = y.new_zeros(len(self.solvers) * N_SCALARS
                               + sum(x.numel() for x in leaves))

    def values(self):
        """The composed state and the window's values (``_window_vals``)."""
        y = torch.cat([p.c.y for p in self.solvers.values()])
        ve, vr, vl = _window_vals(self.dm, self.fs, self.cf, y,
                                  self.bk.ic_stg, self.bk.snow, self.cb,
                                  self.per_edge)
        return {"e": ve, "r": vr, "l": vl, "y": y}

    def pieces(self) -> dict:
        """The pieces in the order of a warm-up."""
        s, out = self.solvers, {"start": self.start}
        glue = {"unsat": self.to_unsat, "gw": self.to_gw, "riv": self.to_riv,
                "lake": self.to_lake}
        for k, p in s.items():
            if k in glue:
                out["to_" + k] = glue[k]
            out.update(p.pieces())
        out["out"] = self.pack
        return out

    def nodes(self) -> tuple:
        """Each solve's step loop after the glue that starts it."""
        nodes = []
        for k, p in self.solvers.items():
            nodes += ["start" if k == "surf" else "to_" + k, p.loop()]
        return (*nodes, "out")

    def start(self):
        s = self.solvers
        self.us0.copy_(maximum(s["unsat"].c.y, 0.0))
        self.gw0.copy_(maximum(s["gw"].c.y, 0.0))
        self.riv0.copy_(maximum(s["riv"].c.y, 0.0))
        if self.has_lake:
            self.lake0.copy_(maximum(s["lake"].c.y, 0.0))
        s["surf"].start()

    def to_unsat(self):
        self.sf1.copy_(maximum(self.solvers["surf"].c.y, 0.0))
        self.solvers["unsat"].start()

    def to_gw(self):
        self.us1.copy_(maximum(self.solvers["unsat"].c.y, 0.0))
        copy_into((self.q_rech0, self.q_exfil0, self.evapo0, self.trans0),
                  _gw_frozen(self.dm, self.fs, self.sf1, self.us1, self.gw0,
                             self.has_lake))
        self.solvers["gw"].start()

    def to_riv(self):
        self.gw1.copy_(maximum(self.solvers["gw"].c.y, 0.0))
        copy_into((self.q_riv_surf0, self.q_riv_sub0),
                  _riv_frozen(self.dm, self.fs, self.sf1, self.us1,
                              self.gw1, self.riv0, self.has_lake))
        self.solvers["riv"].start()

    def to_lake(self):
        self.q_lake_rivin0.copy_(_lake_inflow(self.dm, self.fs,
                                              self.solvers["riv"].c.y))
        self.solvers["lake"].start()

    def pack(self):
        leaves = pytree.tree_leaves(self.values())
        self.out.copy_(torch.cat(
            [scalars(p.c) for p in self.solvers.values()]
            + [x.reshape(-1) for x in leaves]))


class SplitGraph:
    """The ``-g`` driver's window on the device: the Gauss-Seidel sweep of
    the five sub-solvers and the window's values in one launch of a CUDA
    graph, as JAX runs each sub-solve as one jit.

    The program (``solver/graph.Program``) of ``SplitPieces``: ``start``
    (the frozen stage states, the surface solve started) → the surface
    solve's WHILE(active) {``surf_begin`` → Newton iterations
    2..``newton_iters`` under nested IFs → ``surf_end``} → ``to_unsat`` →
    the unsaturated solve → ``to_gw`` → the groundwater solve → ``to_riv``
    → the river solve → [``to_lake`` → the lake solve] → ``out``.  Each
    sub-solve linearizes its sub-RHS once per Newton iteration
    (``linearize_surf`` ...).  Before a launch the host copies the
    window's forcing, cell forcing and buckets into the static buffers and
    writes ``tout``; after it, it reads ``out`` (one host sync: the five
    solvers' scalars, the state and the values, the host's one fetch a
    window) and returns copies, never the buffers the next window
    overwrites; states handed back unchanged (``states is`` the last
    returned) are not uploaded again.

    *capture*: build and replay the graph (the default on the card); False
    runs the same pieces eagerly, each WHILE and IF decided on the host
    (the CPU).  A capture, an instantiation or a launch that fails raises:
    nothing falls back to the eager loop.  ``stats``: graph launches, host
    syncs, each window's steps per sub-solver, the warm-up, capture and
    instantiation seconds and the warm-up's Newton iterations.
    *solver_kernel*: each solver's step body through the solver kernels
    (``solver/graph.SolverPieces``), a scratch each."""

    def __init__(self, dm, cfg: SolverConfig, close_boundary: bool = True,
                 per_edge: bool = False, capture: "bool | None" = None,
                 solver_kernel: bool = True):
        self.dm, self.cfg = dm, cfg
        self.cb, self.per_edge = bool(close_boundary), bool(per_edge)
        self.capture, self.solver_kernel = capture, solver_kernel
        self.pieces = self.program = self._last = None
        self.stats = {"syncs": 0, "steps": [], "warmup_newton_iters": 0}

    def sweep(self, fs, cf, buckets, states: UncoupledStates, t, tout):
        """``sweep_window`` on the device: the window [t, tout] under its
        forcing *fs*, cell forcing *cf* and (updated) *buckets*.  Returns
        (states, host values ``{"e", "r", "l", "y"}``)."""
        if self.pieces is None:
            self.pieces = SplitPieces(self.dm, self.cfg, self.cb,
                                      self.per_edge, fs, cf, buckets, states,
                                      self.solver_kernel)
            if self.capture is None:
                self.capture = states.surf.y.is_cuda
            self.program = Program(self.pieces.pieces(), self.pieces.nodes(),
                                   self.capture)
            self.program.stats.update(self.stats)
            self.stats = self.program.stats  # one dict: the launches too
        p = self.pieces
        copy_into(p.fs, fs)
        copy_into(p.cf, cf)
        copy_into(p.bk, buckets)
        dev = p.tout.device
        if self.capture and not self.program.built:
            self.program.build(dev)
            self._last = None  # the warm-up moved the carries
            n = 2 * len(p.solvers)
            self.stats["warmup_newton_iters"] = n
            graph_mod.warmup_newton_iters += n
        if states is not self._last:
            for k, sp in p.solvers.items():
                copy_into(sp.c, to_carry(getattr(states, k)))
        p.tout.fill_(float(tout))
        self.program.launch(dev)
        host = p.out.to("cpu", copy=True).numpy()
        bdf.host_syncs += 1
        self.stats["syncs"] += 1
        new, steps = {}, {}
        for i, (k, sp) in enumerate(p.solvers.items()):
            sc = host[i * N_SCALARS:(i + 1) * N_SCALARS]
            bdf.newton_iters += int(sc[-1])  # nni, the last of COUNTS
            c = sp.c
            new[k] = from_carry(
                c._replace(y=c.y.clone(), y_prev=c.y_prev.clone(),
                           y_prev2=c.y_prev2.clone()), sc, False)
            steps[k] = new[k].nsteps - getattr(states, k).nsteps
        self.stats["steps"].append(steps)
        out = UncoupledStates(**new)
        self._last = out
        flat, off, leaves = host[len(p.solvers) * N_SCALARS:], 0, []
        for shape in p.shapes:
            n = shape.numel()
            leaves.append(flat[off:off + n].reshape(shape))
            off += n
        return out, pytree.tree_unflatten(leaves, p.spec)

    def close(self) -> None:
        """Free the graph."""
        if self.program is not None:
            self.program.close()


def run_project_split(project: str, base: str = ".", end_day=None,
                      verbose=True, outpath=None, calib=None, inp=None,
                      resume=None, device: "str | torch.device" = "cuda",
                      captured: "bool | None" = None,
                      solver_kernel: bool = True,
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
    frozen-ground module runs only in the fused driver).

    *captured* (default: on the card): each window's sweep is one launch
    of a ``SplitGraph``; on the CPU, True runs the same program's pieces
    eagerly.  False (the default on the CPU): the eager loop
    (``sweep_window``).  Both linearize each sub-RHS once per Newton
    iteration.  *solver_kernel*: every sub-solve's step body through the
    solver kernels (their plain versions on the CPU); False, the solver's
    torch pieces.  Returns the final ``UncoupledStates``."""
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
    if sim.bdf.y.is_cuda if captured is None else captured:
        sweep = SplitGraph(dm, sim.cfg, cb, per_edge,
                           solver_kernel=solver_kernel).sweep
    else:
        def sweep(fs, cf, buckets, states, t, tout):
            return sweep_window(dm, fs, cf, buckets, states, t, tout,
                                sim.cfg, cb, per_edge,
                                solver_kernel=solver_kernel)

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
            # the state and the window's values fetched in one transfer
            states, host = sweep(fs, cf, sim.buckets, states, t, tout)
            t = tout
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
