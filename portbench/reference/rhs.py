# A frozen copy of shud_tpu_torch/core/rhs.py,
# its imports rewritten to this package; the primal only, in the C++
# operation order.
"""The fused right-hand side dY/dt = f(t, Y) on tensors.

The counterpart of ``shud_tpu/core/rhs.py``, reproducing the reference RHS
dataflow (``src/ModelData/MD_f.cpp``, ``MD_ElementFlux.cpp``,
``MD_RiverFlux.cpp``, ``MD_update.cpp``, ``MD_ET.cpp:343-404``): pointwise
cell update -> 3-edge neighbour stencil -> bipartite segment stencil ->
river-chain stencil -> reductions -> pointwise assembly.

Every reduction is a fixed-width gather list summed in a fixed order
(``device.gather_sum``), so the RHS is deterministic on the GPU as well.
Heads are absolute (elevation plus depth), as the C++ code computes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.config import EPSILON, GRAV, MAXYSURF, ZERO
from portbench.reference import physics as ph
from portbench.reference.device import gather_sum
from portbench.reference.physics import maximum, minimum
from portbench.reference.state import ForcingSlice, split_y


class CellUpdate(NamedTuple):
    eff_kh: torch.Tensor
    deficit: torch.Tensor
    satn: torch.Tensor
    sat_kr: torch.Tensor
    theta: torch.Tensor
    kmax: torch.Tensor


def update_element(m, sf, us, gw):
    """Vectorised ``_Element::updateElement`` (Element.cpp:384-432)."""
    effkh = ph.eff_kh(gw, m.aq_depth, m.mac_d, m.mac_ksat_h, m.geo_v_area_f,
                      m.ksat_h)
    deficit = m.aq_depth - gw
    kmax = m.inf_ksat_v * (1.0 - m.h_area_f) + m.mac_ksat_v * m.h_area_f

    saturated = deficit <= 0.0
    deficit = maximum(deficit, 0.0)
    theta_raw = us / torch.where(saturated, 1.0, deficit) * m.theta_s
    theta = torch.where(saturated, m.theta_s, theta_raw)
    satn = torch.where(
        saturated, 1.0, (theta - m.theta_r) / (m.theta_s - m.theta_r)
    )

    hi = satn > 0.99
    lo = satn <= ZERO
    satn_mid = ph.clip(satn, 1e-12, 1.0 - 1e-12)  # safe for pow branches
    sat_kr_mid = ph.sat_k_fun(satn_mid, m.beta)
    satn = torch.where(hi, 1.0, torch.where(lo, 0.0, satn))
    sat_kr = torch.where(hi, 1.0, torch.where(lo, 0.0, sat_kr_mid))
    theta = torch.where(hi, m.theta_s, torch.where(lo, m.theta_r, theta))
    return CellUpdate(effkh, deficit, satn, sat_kr, theta, kmax)


def lake_cell_update(m, cu: CellUpdate) -> CellUpdate:
    """``updateLakeElement`` overrides for cells inside a lake
    (Element.cpp:373-383)."""
    is_lake = m.i_lake > 0
    return CellUpdate(
        eff_kh=torch.where(is_lake, m.ksat_h, cu.eff_kh),
        deficit=torch.where(is_lake, 0.0, cu.deficit),
        satn=torch.where(is_lake, 1.0, cu.satn),
        sat_kr=torch.where(is_lake, 1.0, cu.sat_kr),
        theta=torch.where(is_lake, m.theta_s, cu.theta),
        kmax=torch.where(is_lake, m.inf_ksat_v, cu.kmax),
    )


def et_flux(m, fs: ForcingSlice, sf, us, gw, satn):
    """Vectorised ``f_etFlux`` (MD_ET.cpp:343-404).

    Returns (Es, Eu, Eg, Tu, Tg, e_ic_out, ibeta); ``e_ic_out`` reproduces
    the in-call overwrite of qEleE_IC."""
    va = m.veg_frac
    vb = 1.0 - m.veg_frac
    pj = 1.0 - m.imp_af
    # SoilMoistureStress (is_sm_et.cpp:175-188); soil-table thetas == cell
    fc = m.theta_s * 0.75
    beta_s = (satn * (m.theta_s - m.theta_r) - m.theta_r) / (fc - m.theta_r)
    beta_s = ph.clip(beta_s, 0.0, 1.0)
    # the reference uses its truncated PI macro here (Macros.hpp:46)
    ibeta = 0.5 * (1.0 - torch.cos(3.1415926 * beta_s))

    es = torch.minimum(maximum(sf, 0.0), fs.pot_evap) * vb
    rem = fs.pot_evap - es
    some_left = es < fs.pot_evap
    gw_high = gw > m.wetland_level
    eg = torch.where(
        some_left & gw_high, torch.minimum(maximum(gw, 0.0), rem) * pj * vb,
        0.0,
    )
    eu = torch.where(
        some_left & ~gw_high,
        torch.minimum(maximum(us, 0.0), ibeta * rem) * pj * vb,
        0.0,
    )

    has_veg = fs.lai > ZERO
    ic_dominates = fs.e_ic >= fs.pot_tran
    root_deep = gw > m.rootreach_level
    tg = torch.where(
        has_veg & ~ic_dominates & root_deep,
        torch.minimum(maximum(gw, 0.0), fs.pot_tran - fs.e_ic) * pj * va,
        0.0,
    )
    tu = torch.where(
        has_veg & ~ic_dominates & ~root_deep,
        torch.minimum(maximum(us, 0.0), ibeta * (fs.pot_tran - fs.e_ic))
        * pj * va,
        0.0,
    )
    e_ic_out = torch.where(
        has_veg,
        torch.where(ic_dominates, fs.pot_tran * pj * va, fs.e_ic),
        0.0,
    )
    return es, eu, eg, tu, tg, e_ic_out, ibeta


def flux_infiltration(m, cu: CellUpdate, sf, us, gw, net_prcp):
    """``_Element::Flux_Infiltration`` (Element.cpp:273-303)."""
    av = sf + net_prcp
    gw_at_surface = (gw + us > m.aq_depth) | (cu.deficit < us)
    qex = ph.absolute(gw + us - m.aq_depth) / m.aq_depth * cu.kmax

    grad = 1.0 + av / m.inf_d
    heavy = av > cu.kmax
    medium = av > m.inf_ksat_v
    effk = torch.where(
        heavy,
        m.inf_ksat_v * (1.0 - m.h_area_f) + m.h_area_f * m.mac_ksat_v * cu.satn,
        torch.where(
            medium,
            cu.sat_kr * m.inf_ksat_v * (1.0 - m.h_area_f)
            + m.h_area_f * m.mac_ksat_v * cu.satn,
            cu.sat_kr * m.inf_ksat_v * (1.0 - m.h_area_f),
        ),
    )
    qi = torch.minimum(av, maximum(grad * effk, 0.0))
    qi = torch.where((av > 0.0) & (cu.deficit > m.inf_d), qi, 0.0)

    qi = torch.where(gw_at_surface, 0.0, qi)
    qex = torch.where(gw_at_surface, qex, 0.0)
    return qi, qex


def flux_recharge(m, cu: CellUpdate, us, gw):
    """``_Element::Flux_Recharge`` (Element.cpp:304-334)."""
    skip = (gw > m.aq_depth - m.inf_d) & (us < cu.deficit)
    grad = torch.where(
        (cu.theta > m.theta_r) & (us > EPSILON),
        maximum((cu.theta - m.theta_r) / (m.theta_fc - m.theta_r), 0.0),
        0.0,
    )
    ku = m.inf_ksat_v * cu.sat_kr
    # harmonic mean with safe denominator (meanHarmonic, Equations.hpp:44-48)
    denom = cu.deficit * m.ksat_v + gw * ku
    ke = ku * m.ksat_v * (cu.deficit + gw) / torch.where(denom == 0.0, 1.0,
                                                         denom)
    ke = torch.where(denom == 0.0, 0.0, ke)
    qr = torch.where(
        (m.inf_ksat_v <= 0.0) | (m.ksat_v <= 0.0), 0.0, grad * ke
    )
    return torch.where(skip, 0.0, qr)



def _edge_fluxes_exact(m, cu, sf, gw, lake_stg, close_boundary: bool):
    """The reference's absolute-head edge fluxes (``rhs.edge_fluxes`` with
    ``exact_parity``: separate gathers, the C++ operation order)."""
    nb, has_nabr, has_lake, lk = m.nb, m.has_nabr, m.has_lake, m.lk
    isf = maximum(sf, 0.0)[:, None]
    z = m.z_surf[:, None]
    B = m.edge
    nsf = maximum(sf[nb], 0.0)
    zn = m.z_surf[nb]
    gw_nb = gw[nb]
    zb_nb = m.z_bottom[nb]
    effkh_nb = cu.eff_kh[nb]
    has_lakes = lake_stg.shape[0] > 0

    lake_nsf = maximum(lake_stg[lk], 0.0) if has_lakes else torch.zeros_like(B)
    q_surf_lake = ph.weir_flow_jtoi(
        m.lake_zmin[lk] if has_lakes else torch.zeros_like(B),
        lake_nsf, z, isf, z, 0.6, B, 0.01,
    )
    dh = (isf + z) - (nsf + zn)
    up1 = torch.where(isf > m.depression[:, None], isf, 0.0)
    up2 = torch.where(nsf > m.depression[:, None], nsf, 0.0)
    ymean = torch.where(dh > 0.0, up1.expand_as(up2), up2)
    ymean = minimum(ymean, MAXYSURF)
    dist = m.dist_nb
    s = dh / dist
    q_int = ph.manning_equation(ymean * B, m.avg_rough, ymean, s)
    q_int = torch.where((s > 0) & (isf <= 0.0), 0.0, q_int)
    q_int = torch.where((s < 0) & (nsf <= 0.0), 0.0, q_int)
    q_int = torch.where(ymean <= 0.0, 0.0, q_int)

    if close_boundary:
        q_bnd = torch.zeros_like(B)
    else:
        sb = isf / m.dist2edge * 0.5
        isf5 = ph.cbrt(isf * isf * isf * isf * isf)
        qb = torch.sqrt(maximum(sb, 0.0)) * isf5 * B / m.rough[:, None]
        q_bnd = torch.where((isf > m.depression[:, None]) & (sb > 0.0), qb, 0.0)
    q_surf = torch.where(has_lake, q_surf_lake,
                         torch.where(has_nabr, q_int, q_bnd))

    gw_col = gw[:, None]
    zb = m.z_bottom[:, None]
    if has_lakes:
        lake_bot = m.lake_bathy_y[lk, 0]
        dh_lk = (gw_col + zb) - (lake_stg[lk] + lake_bot)
        ymean_lk = ph.avg_y_gw(gw_col, lake_stg[lk])
        q_sub_lake = 0.5 * (cu.eff_kh[:, None] + effkh_nb) * (dh_lk / dist) \
            * ymean_lk * B
        q_sub_lake = torch.where(
            ((dh_lk > 0.0) & (gw_col <= 0.02))
            | ((dh_lk < 0.0) & (lake_stg[lk] <= 0.02)),
            0.0,
            q_sub_lake,
        )
    else:
        q_sub_lake = torch.zeros_like(B)

    dh_s = (gw_col + zb) - (gw_nb + zb_nb)
    ymean_s = ph.avg_y_gw(gw_col, gw_nb)
    kmean = 0.5 * (cu.eff_kh[:, None] + effkh_nb)
    q_sub_int = kmean * (dh_s / dist) * ymean_s * B
    q_sub_int = torch.where(
        ((dh_s > 0.0) & (gw_col <= 0.02)) | ((dh_s < 0.0) & (gw_nb <= 0.02)),
        0.0,
        q_sub_int,
    )
    if close_boundary:
        q_sub_bnd = torch.zeros_like(B)
    else:
        grad_b = gw_col / m.dist2edge * 0.5
        q_sub_bnd = torch.where(
            (gw_col > m.depression[:, None] * 10.0) & (grad_b > 0.0),
            cu.eff_kh[:, None] * grad_b,
            0.0,
        )
    q_sub = torch.where(has_lake, q_sub_lake,
                        torch.where(has_nabr, q_sub_int, q_sub_bnd))
    return (q_surf, q_sub, torch.where(has_lake, q_surf, 0.0),
            torch.where(has_lake, q_sub, 0.0))


def rhs_full(m, fs: ForcingSlice, t, y, close_boundary: bool = True):
    """Full RHS with diagnostics.

    ``m`` is the device mesh (``device.to_torch``), ``fs`` the forcing slice.
    Returns (dy, diag dict)."""
    dy, diag, _ = _rhs(m, fs, y, close_boundary)
    return dy, diag


def _rhs(m, fs: ForcingSlice, y, close_boundary: bool):
    """``rhs_full``'s body: (dy, diag, intermediates)."""
    ne, nr = m.num_ele, m.num_riv
    nl = m.num_lake if m.num_lake > 0 else 0
    lists = m.lists
    sf, us, gw_raw, riv, lake_stg = split_y(y, ne, nr, nl)

    # --- f_update: BC overrides (MD_update.cpp:102-189) ---
    gw = torch.where(m.i_bc > 0, fs.ele_ybc, gw_raw)
    riv_stage = torch.where(m.riv_bc > 0, fs.riv_ybc, riv)

    # river geometry (River.cpp:49-62)
    r_topw = maximum(riv_stage * m.riv_bank_slope * 2.0 + m.riv_bottom_width,
                     0.0)
    r_csa = maximum(
        riv_stage * (m.riv_bottom_width + riv_stage * m.riv_bank_slope), 0.0
    )
    # 2*sqrt(y^2 + (y s)^2) == 2|y| sqrt(1+s^2): identical value, JVP-safe
    r_per = maximum(
        2.0 * ph.absolute(riv_stage) * torch.sqrt(1.0 + m.riv_bank_slope**2)
        + m.riv_bottom_width,
        0.0,
    )

    # --- pointwise cell update ---
    cu = update_element(m, sf, us, gw)
    if nl > 0:
        cu = lake_cell_update(m, cu)
    es, eu, eg, tu, tg, e_ic_out, ibeta = et_flux(m, fs, sf, us, gw, cu.satn)
    qi, qex = flux_infiltration(m, cu, sf, us, gw, fs.net_prcp)
    q_infil = qi * fs.fu_surf
    q_exfil = qex * fs.fu_surf
    q_rech = flux_recharge(m, cu, us, gw) * fs.fu_sub

    if nl > 0:
        is_lake_cell = m.i_lake > 0
        # lake cells: vertical terms zeroed, evap = potential open water
        q_infil = torch.where(is_lake_cell, 0.0, q_infil)
        q_exfil = torch.where(is_lake_cell, 0.0, q_exfil)
        q_rech = torch.where(is_lake_cell, 0.0, q_rech)
        es = torch.where(is_lake_cell, 0.0, es)
        eu = torch.where(is_lake_cell, 0.0, eu)
        eg = torch.where(is_lake_cell, 0.0, eg)
        tu = torch.where(is_lake_cell, 0.0, tu)
        tg = torch.where(is_lake_cell, 0.0, tg)
        e_ic_out = torch.where(is_lake_cell, 0.0, e_ic_out)

    # --- edge stencil ---
    q_esurf, q_esub0, q_lake_surf_e, q_lake_sub_e = _edge_fluxes_exact(
        m, cu, sf, gw, lake_stg, close_boundary
    )
    q_esub = q_esub0 * fs.fu_sub[:, None]
    if nl > 0:
        # lake cells have no lateral fluxes (fun_Ele_lakeHorizon)
        lc = is_lake_cell[:, None]
        q_esurf = torch.where(lc, 0.0, q_esurf)
        q_esub = torch.where(lc, 0.0, q_esub)
        q_lake_surf_e = torch.where(lc, 0.0, q_lake_surf_e)
        q_lake_sub_e = torch.where(lc, 0.0, q_lake_sub_e)

    # --- segment stencil (fun_Seg_surface / fun_Seg_sub) ---
    se, sr = m.seg_ele, m.seg_riv
    seg_isf_raw = sf[se] - q_infil[se] + q_exfil[se]
    seg_isf = maximum(seg_isf_raw, 0.0)
    zs_e = m.z_surf[se]
    q_seg_surf = ph.weir_flow_jtoi(
        zs_e, seg_isf,
        zs_e - m.riv_depth[sr], riv_stage[sr],
        zs_e, m.seg_cwr, m.seg_length, m.depression[se],
    )
    q_seg_sub = ph.flux_r2e_gw(
        riv_stage[sr], zs_e - m.riv_depth[sr],
        gw[se], m.z_bottom[se],
        cu.eff_kh[se], m.riv_ksat_h[sr],
        m.seg_length, m.riv_bed_thick[sr],
    ) * fs.fu_sub[se]

    # --- river chain stencil (Flux_RiverDown, MD_RiverFlux.cpp:5-63) ---
    has_down = m.riv_down >= 0
    dn = torch.where(has_down, m.riv_down, 0)
    s_mean = 0.5 * (m.riv_bed_slope + m.riv_bed_slope[dn])
    s_down = (
        (riv_stage - m.riv_depth) - (riv_stage[dn] - m.riv_depth[dn])
    ) / m.riv_dist2down + s_mean
    r_hyd = torch.where(r_per <= ZERO, 0.0,
                        r_csa / torch.where(r_per <= ZERO, 1.0, r_per))
    q_down_int = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_down)

    # outlets: codes -1/-2/-3 zero-depth-gradient; -4.. lake / critical depth
    s_out = m.riv_bed_slope + riv_stage * 2.0 / m.riv_length
    q_out_zdg = ph.manning_equation(r_csa, m.riv_avg_rough, r_hyd, s_out)
    q_out_crit = r_csa * torch.sqrt(GRAV * maximum(riv_stage, 1e-30)) * 60.0
    to_lake = m.riv_to_lake >= 0
    q_riv_down = torch.where(
        to_lake,
        q_out_zdg,  # lake-bound: same zero-depth-gradient Manning form
        torch.where(
            has_down,
            q_down_int,
            torch.where(m.riv_outlet_code == -4, q_out_crit, q_out_zdg),
        ),
    )

    # --- reductions (PassValue, MD_f.cpp:217-257) ---
    q_riv_surf = gather_sum(q_seg_surf, lists.seg_to_riv)
    q_riv_sub = gather_sum(q_seg_sub, lists.seg_to_riv)
    q_e2r_surf = gather_sum(-q_seg_surf, lists.seg_to_ele)
    q_e2r_sub = gather_sum(-q_seg_sub, lists.seg_to_ele)
    q_riv_up = gather_sum(-q_riv_down, lists.riv_to_down)

    # --- assembly (f_applyDY, MD_f.cpp:52-215) ---
    q_surf_tot = q_e2r_surf + q_esurf.sum(dim=1)
    q_sub_tot = q_e2r_sub + q_esub.sum(dim=1)
    area = m.area

    dsf = fs.net_prcp - q_infil + q_exfil - q_surf_tot / area - es
    dus = q_infil - q_rech - eu - tu
    dgw = q_rech - q_exfil - q_sub_tot / area - eg - tg

    # BC / SS terms
    dgw = torch.where(m.i_bc > 0, 0.0, dgw)
    dgw = dgw + torch.where(m.i_bc < 0, fs.ele_qbc / area, 0.0)
    dsf = dsf + torch.where(m.i_ss > 0, fs.ele_qss / area, 0.0)
    dgw = dgw + torch.where(m.i_ss < 0, fs.ele_qss / area, 0.0)

    dus = dus / m.sy
    dgw = dgw / m.sy

    if nl > 0:
        dsf = torch.where(is_lake_cell, 0.0, dsf)
        dus = torch.where(is_lake_cell, 0.0, dus)
        dgw = torch.where(is_lake_cell, 0.0, dgw)

    # river
    d_area_raw = (
        -q_riv_up - q_riv_surf - q_riv_sub - q_riv_down + fs.riv_qbc
    ) / m.riv_length
    d_area = torch.maximum(d_area_raw, -r_csa)
    driv = ph.fun_da_to_dy(d_area, r_topw, m.riv_bank_slope)
    driv = torch.where(m.riv_bc > 0, 0.0, driv)

    # lake
    if nl > 0:
        lk_cell = torch.where(is_lake_cell, m.i_lake - 1, 0)
        inv_nele = 1.0 / maximum(m.lake_num_ele.to(y.dtype), 1.0)
        q_lake_evap = gather_sum(
            torch.where(is_lake_cell, fs.pot_evap * inv_nele[lk_cell], 0.0),
            lists.cell_to_lake,
        )
        q_lake_prcp = gather_sum(
            torch.where(is_lake_cell, fs.prcp * inv_nele[lk_cell], 0.0),
            lists.cell_to_lake,
        )
        # clamp (f_loop, MD_f.cpp:44-47): min first, then max — not clip
        q_lake_evap_raw = q_lake_evap
        q_lake_evap = maximum(
            torch.minimum(q_lake_evap, q_lake_prcp + lake_stg), 0.0
        )
        q_lake_surf = gather_sum(q_lake_surf_e.reshape(-1),
                                 lists.edge_to_lake)
        q_lake_sub = gather_sum(q_lake_sub_e.reshape(-1), lists.edge_to_lake)
        q_lake_rivin = gather_sum(q_riv_down, lists.riv_to_lake)
        # lake stage -> top area via bathymetry interpolation
        lake_area = _lake_toparea(m, lake_stg)
        dlake = q_lake_prcp - q_lake_evap + (
            q_lake_rivin + q_lake_sub + q_lake_surf
        ) / lake_area
    else:
        dlake = y.new_zeros(0)
        q_lake_evap = q_lake_prcp = q_lake_surf = q_lake_sub = dlake
        q_lake_rivin = q_lake_evap_raw = dlake
        lake_area = dlake

    dy = torch.cat([dsf, dus, dgw, driv, dlake])
    diag = dict(
        q_infil=q_infil, q_exfil=q_exfil, q_rech=q_rech,
        q_esurf=q_esurf, q_esub=q_esub,
        q_surf_tot=q_surf_tot, q_sub_tot=q_sub_tot,
        q_seg_surf=q_seg_surf, q_seg_sub=q_seg_sub,
        q_riv_surf=q_riv_surf, q_riv_sub=q_riv_sub,
        q_riv_down=q_riv_down, q_riv_up=q_riv_up,
        q_e2r_surf=q_e2r_surf, q_e2r_sub=q_e2r_sub,
        es=es, eu=eu, eg=eg, tu=tu, tg=tg, e_ic=e_ic_out, ibeta=ibeta,
        eff_kh=cu.eff_kh, satn=cu.satn, theta=cu.theta,
        q_lake_evap=q_lake_evap, q_lake_prcp=q_lake_prcp,
        q_lake_surf=q_lake_surf, q_lake_sub=q_lake_sub,
        q_lake_rivin=q_lake_rivin, lake_area=lake_area,
    )
    saved = dict(
        sf=sf, us=us, gw=gw, riv_stage=riv_stage, lake_stg=lake_stg, cu=cu,
        ibeta=ibeta, r_topw=r_topw, r_csa=r_csa, r_per=r_per, r_hyd=r_hyd,
        s_down=s_down, s_out=s_out, seg_isf=seg_isf,
        seg_isf_raw=seg_isf_raw, d_area_raw=d_area_raw,
        d_area=d_area, q_lake_evap_raw=q_lake_evap_raw,
        q_lake_prcp=q_lake_prcp, q_lake_rivin=q_lake_rivin,
        q_lake_surf=q_lake_surf, q_lake_sub=q_lake_sub, lake_area=lake_area,
    )
    return dy, diag, saved


def _lake_toparea(m, lake_stg):
    """Piecewise-linear stage->area lookup (Lake.cpp:toparea:59-78).

    The reference looks up at absolute elevation ``yStage + zmin``."""
    yq = lake_stg + m.lake_zmin  # [Nl]
    yi = m.lake_bathy_y  # [Nl, K]
    ai = m.lake_bathy_a
    k = yi.shape[1]
    # replicate the sequential scan: ta starts at ai[0]; for i in 1..K-1:
    # if y < yi[i]: ta = (ai[i]-ta)/(yi[i]-y)*(y-yi[i-1]) + ta; break
    # else ta = ai[i]
    ta = ai[:, 0]
    done = yq <= yi[:, 0]
    for i in range(1, k):
        below = yq < yi[:, i]
        interp = (ai[:, i] - ta) / torch.where(
            yi[:, i] == yq, 1.0, yi[:, i] - yq
        ) * (yq - yi[:, i - 1]) + ta
        new_ta = torch.where(below, interp, ai[:, i])
        ta = torch.where(done, ta, new_ta)
        done = done | below
    return ta


def rhs(m, fs: ForcingSlice, t, y, close_boundary: bool = True):
    dy, _ = rhs_full(m, fs, t, y, close_boundary)
    return dy


