"""The fused right-hand side dY/dt = f(t, Y) on tensors.

The counterpart of ``shud_tpu/core/rhs.py``, reproducing the reference RHS
dataflow (``src/ModelData/MD_f.cpp``, ``MD_ElementFlux.cpp``,
``MD_RiverFlux.cpp``, ``MD_update.cpp``, ``MD_ET.cpp:343-404``): pointwise
cell update -> 3-edge neighbour stencil -> bipartite segment stencil ->
river-chain stencil -> reductions -> pointwise assembly.

Every reduction is a fixed-width gather list summed in a fixed order
(``device.gather_sum``), so the RHS is deterministic on the GPU as well.
The edge stencil runs the CUDA edge-flux kernels when the mesh was built
with ``edge_kernel`` and the state is float32 on CUDA (``edge_fluxes``);
there, on a lake-free mesh, the rest of the RHS runs as two more kernels
around them (``_rhs_kernels``, ``csrc/edge_rhs.cu``), bitwise its plain
version ``_rhs_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shud_tpu_torch import trace
from shud_tpu_torch.config import EPSILON, GRAV, MAXYSURF, ZERO
from shud_tpu_torch.core import edge as edge_mod
from shud_tpu_torch.core import physics as ph
from shud_tpu_torch.core.device import gather_sum
from shud_tpu_torch.core.physics import maximum, minimum
from shud_tpu_torch.core.state import ForcingSlice, split_y


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


def _on_kernels(m, x, *more) -> bool:
    """The edge stencil runs the CUDA kernels: the mesh was built for them,
    the state *x* is float32 on CUDA, and no ``torch.func`` transform is
    active (``edge.kernels_may_run``: inside one the plain versions carry
    the derivative; a call autograd would record on *x* or *more* raises)."""
    return (m.edge_kernel and x.dtype == torch.float32 and x.is_cuda
            and edge_mod.kernels_may_run(x, *more))


def edge_fluxes(m, cu: CellUpdate, sf, gw, lake_stg, close_boundary: bool,
                exact_parity: bool = False, coeffs: "list | None" = None):
    """3-edge lateral surface + subsurface fluxes
    (``fun_Ele_surface``/``fun_Ele_sub``, MD_ElementFlux.cpp:35-156).

    Returns (QeleSurf[Ne,3], QeleSub[Ne,3], QLakeSurf_contrib[Ne,3],
    QLakeSub_contrib[Ne,3]).  Lake contributions are per-edge values to be
    summed into per-lake totals (no fu_sub factor, matching the reference
    asymmetry at MD_ElementFlux.cpp:122 vs :153).

    The interior and open-boundary branches come from ``core/edge.py``: the
    CUDA kernels when ``m.edge_kernel`` is set and the state is float32 on
    CUDA, else their plain versions, in the local-datum form (head
    differences from f64-precomputed edge dz).  The lake-bank branch (few
    edges) is computed here and merged by mask, preserving the reference's
    branch priority (lake > neighbour > boundary).  ``exact_parity`` keeps
    the reference's absolute-head operation order (f64 bit-parity).

    Given a list as *coeffs* (``linearize``), the interior and boundary
    fluxes come from the coefficient kernel (its plain version off the
    kernel path), whose six coefficient arrays are appended to the list."""
    if exact_parity:
        return _edge_fluxes_exact(m, cu, sf, gw, lake_stg, close_boundary)
    et = m.edge_tables
    kernel = _on_kernels(m, sf, gw, cu.eff_kh)
    if coeffs is not None:
        fn = edge_mod.edge_coeff if kernel else edge_mod.edge_coeff_plain
        q_surf_k, q_sub_k, *cs = fn(sf, gw, cu.eff_kh, et, close_boundary)
        coeffs.extend(cs)
    else:
        fn = edge_mod.edge_flux if kernel else edge_mod.edge_flux_plain
        q_surf_k, q_sub_k = fn(sf, gw, cu.eff_kh, et, close_boundary)
    if lake_stg.shape[0] == 0:
        z3 = torch.zeros_like(q_surf_k)
        return q_surf_k, q_sub_k, z3, z3
    has_lake, lk = m.has_lake, m.lk
    isf = maximum(sf, 0.0)[:, None]
    B = m.edge
    lake_nb = lake_stg[lk]
    lake_nsf = maximum(lake_nb, 0.0)
    q_surf_lake = ph.weir_flow_jtoi_local(
        lake_nsf + m.edge_lake_dzl, isf, lake_nsf, 0.6, B, 0.01,
    )
    gw_col = gw[:, None]
    dh_lk = (gw_col - lake_nb) + m.edge_lake_dzb
    ymean_lk = ph.avg_y_gw(gw_col, lake_nb)
    grad_lk = dh_lk / m.dist_nb
    kmean_lk = 0.5 * (cu.eff_kh[:, None] + cu.eff_kh[m.nb])
    q_sub_lake = kmean_lk * grad_lk * ymean_lk * B
    q_sub_lake = torch.where(
        ((dh_lk > 0.0) & (gw_col <= 0.02)) | ((dh_lk < 0.0) & (lake_nb <= 0.02)),
        0.0,
        q_sub_lake,
    )
    q_surf = torch.where(has_lake, q_surf_lake, q_surf_k)
    q_sub = torch.where(has_lake, q_sub_lake, q_sub_k)
    return (q_surf, q_sub, torch.where(has_lake, q_surf, 0.0),
            torch.where(has_lake, q_sub, 0.0))


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


def rhs_full(m, fs: ForcingSlice, t, y, close_boundary: bool = True,
             exact_parity: bool = False):
    """Full RHS with diagnostics.

    ``m`` is the device mesh (``device.to_torch``), ``fs`` the forcing slice.
    Returns (dy, diag dict)."""
    dy, diag, _ = _rhs(m, fs, y, close_boundary, exact_parity)
    return dy, diag


def _rhs(m, fs: ForcingSlice, y, close_boundary: bool, exact_parity: bool,
         coeffs: "list | None" = None):
    """``rhs_full``'s body: (dy, diag, the intermediates ``linearize``
    reads).  *coeffs* as in ``edge_fluxes``.  On a lake-free mesh on the
    edge kernels' route the RHS kernels compute it (``_rhs_kernels``),
    elsewhere its plain version (``_rhs_plain``); the counter
    ``shud.edge.rhs_kernels`` says which the last call outside a
    ``torch.func`` transform took."""
    kernels = _rhs_on_kernels(m, fs, y, exact_parity)
    if edge_mod.kernels_may_run():
        trace.count("shud.edge.rhs_kernels", int(kernels))
    if kernels:
        return _rhs_kernels(m, fs, y, close_boundary, coeffs)
    return _rhs_plain(m, fs, y, close_boundary, exact_parity, coeffs)


def _rhs_on_kernels(m, fs: ForcingSlice, y, exact_parity: bool) -> bool:
    """``_rhs`` runs the RHS kernels: on the edge kernels' route
    (``_on_kernels``, which also decides for transforms and autograd) in
    the local-datum form, on a lake-free mesh.  A lake mesh keeps the
    plain RHS."""
    return (not (exact_parity or m.num_lake > 0)
            and _on_kernels(m, y, *fs))


def _rhs_plain(m, fs: ForcingSlice, y, close_boundary: bool,
               exact_parity: bool, coeffs: "list | None" = None):
    """``_rhs`` in PyTorch: the plain version of ``_rhs_kernels``, and the
    route for lakes, the CPU, float64, the absolute-head oracle and
    ``torch.func`` transforms."""
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
    q_esurf, q_esub0, q_lake_surf_e, q_lake_sub_e = edge_fluxes(
        m, cu, sf, gw, lake_stg, close_boundary, exact_parity, coeffs
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
    low_prec = (y.dtype == torch.float32) or not exact_parity
    if low_prec:
        # local-datum form: subtract z_surf (weir) / z_bottom (bed Darcy) —
        # algebraically identical, f32-safe against km-scale elevations
        zero_e = torch.zeros_like(seg_isf)
        q_seg_surf = ph.weir_flow_jtoi(
            zero_e, seg_isf,
            -m.riv_depth[sr], riv_stage[sr],
            zero_e, m.seg_cwr, m.seg_length, m.depression[se],
        )
        q_seg_sub = ph.flux_r2e_gw(
            riv_stage[sr], m.aq_depth[se] - m.riv_depth[sr],
            gw[se], zero_e,
            cu.eff_kh[se], m.riv_ksat_h[sr],
            m.seg_length, m.riv_bed_thick[sr],
        ) * fs.fu_sub[se]
    else:
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


# the RHS kernels' inputs, in csrc/edge_rhs.cu's CellField and AsmField
# order, and their output rows.  The cell kernel reads the state's sf, us
# and gw (before the head BC), the forcing and the mesh; the assembly the
# cell kernel's rows (its gw after the head BC), the edge kernel's fluxes
# and the reaches' stages (``riv``, before the stage BC).
_RHS_CELL_FIELDS = (
    "sf", "us", "gw", "ele_ybc", "pot_evap", "lai", "e_ic", "pot_tran",
    "net_prcp", "fu_surf", "fu_sub", "aq_depth", "mac_d", "mac_ksat_h",
    "geo_v_area_f", "ksat_h", "inf_ksat_v", "h_area_f", "mac_ksat_v",
    "theta_s", "theta_r", "beta", "veg_frac", "imp_af", "wetland_level",
    "rootreach_level", "inf_d", "ksat_v", "theta_fc")
_RHS_CELL_OUT = ("gw", "eff_kh", "deficit", "satn", "sat_kr", "theta",
                 "kmax", "es", "eu", "eg", "tu", "tg", "e_ic", "ibeta",
                 "q_infil", "q_exfil", "q_rech")
_RHS_ASSEMBLE_FIELDS = (
    ("sf", "net_prcp", "fu_sub", "ele_qbc", "ele_qss", "area", "sy",
     "aq_depth", "depression", "gw", "eff_kh", "es", "eu", "eg", "tu", "tg",
     "q_infil", "q_exfil", "q_rech"),  # [ne]
    ("q_surf", "q_sub"),  # [ne, 3]
    ("seg_cwr", "seg_length"),  # [ns]
    ("riv", "riv_ybc", "riv_qbc", "riv_depth", "riv_ksat_h", "riv_bed_thick",
     "riv_bank_slope", "riv_bottom_width", "riv_bed_slope", "riv_dist2down",
     "riv_avg_rough", "riv_length"))  # [nr]
_RHS_ASSEMBLE_FLAGS = (
    ("i_bc", "i_ss"), ("seg_ele", "seg_riv"),
    ("riv_bc", "riv_down", "riv_to_lake", "riv_outlet_code"),
    ("seg_to_ele", "seg_to_riv", "riv_to_down"))  # the lists [n, k]
_RHS_CELL_SUMS = ("q_surf_tot", "q_sub_tot", "q_e2r_surf", "q_e2r_sub")
# the assembly's gather sums, as _rhs_plain takes them: (list, the row it
# sums, negated), in csrc/edge_rhs.cu's Given order
_RHS_GIVEN = (("seg_to_ele", "q_seg_surf", True),
              ("seg_to_ele", "q_seg_sub", True),
              ("seg_to_riv", "q_seg_surf", False),
              ("seg_to_riv", "q_seg_sub", False),
              ("riv_to_down", "q_riv_down", True))
_RHS_SEG_OUT = ("seg_isf_raw", "seg_isf", "q_seg_surf", "q_seg_sub")
_RHS_RIV_OUT = ("riv_stage", "r_topw", "r_csa", "r_per", "r_hyd", "s_down",
                "s_out", "q_riv_down", "q_riv_surf", "q_riv_sub", "q_riv_up",
                "d_area_raw", "d_area")


def _rhs_cell_inputs(m, fs: ForcingSlice, y):
    """``(floats, flags, src)``: the cell kernel's inputs as ``(name,
    tensor)`` in ``_RHS_CELL_FIELDS`` order and ``i_bc``, and the state's
    and the forcing's fields by name."""
    ne, nr = m.num_ele, m.num_riv
    sf, us, gw, riv, _ = split_y(y, ne, nr, 0)
    src = dict(fs._asdict(), sf=sf, us=us, gw=gw, riv=riv)
    return ([(k, src[k] if k in src else getattr(m, k))
             for k in _RHS_CELL_FIELDS], [("i_bc", m.i_bc)], src)


def _rhs_assemble_inputs(m, src: dict):
    """``(floats, flags)``: the assembly's inputs as ``(name, tensor,
    shape)`` in ``_RHS_ASSEMBLE_FIELDS`` and ``_RHS_ASSEMBLE_FLAGS`` order;
    *src* the state's, the forcing's, the cell kernel's and the edge
    kernel's fields by name (the mesh's otherwise, its gather lists
    last)."""
    ne, ns, nr = m.num_ele, m.num_seg, m.num_riv

    def get(k):
        return src[k] if k in src else getattr(m, k)

    floats = [(k, get(k), shape)
              for group, shape in zip(_RHS_ASSEMBLE_FIELDS,
                                      (ne, (ne, 3), ns, nr))
              for k in group]
    cells, segs, rivs, lists = _RHS_ASSEMBLE_FLAGS
    flags = ([(k, get(k), ne) for k in cells]
             + [(k, get(k), ns) for k in segs]
             + [(k, get(k), nr) for k in rivs]
             + [(k, t, tuple(t.shape))
                for k, t in ((k, getattr(m.lists, k)) for k in lists)])
    return floats, flags


def _rhs_assemble(floats, flags, ne: int, ns: int, nr: int):
    """``edge.rhs_assemble`` on ``_rhs_assemble_inputs``'s *floats* and
    *flags*.  A gather list whose sum's order the kernel does not keep
    (``edge.sum_in_order``) torch sums, as ``_rhs_plain`` does, between a
    first launch that writes the rows those sums read and the assembly
    proper; the counter ``shud.edge.rhs_torch_sums`` gives how many."""
    lists = {k: t for k, t, _ in flags[-3:]}
    wide = {k for k, t in lists.items() if not edge_mod.sum_in_order(t)}
    trace.count("shud.edge.rhs_torch_sums", len(wide))
    given = None
    if wide:
        pre = _rhs_rows(edge_mod.rhs_assemble(floats, flags, ne, ns, nr,
                                              pre=True)[2], ne, ns, nr)
        given = [gather_sum(-pre[row] if neg else pre[row], lists[k])
                 if k in wide else None for k, row, neg in _RHS_GIVEN]
    return edge_mod.rhs_assemble(floats, flags, ne, ns, nr, given)


def _rhs_rows(rows, ne: int, ns: int, nr: int) -> dict:
    """The assembly's rows by name (``_RHS_CELL_SUMS``, ``_RHS_SEG_OUT``,
    ``_RHS_RIV_OUT``)."""
    return dict(zip(_RHS_CELL_SUMS + _RHS_SEG_OUT + _RHS_RIV_OUT,
                    (*rows[:4 * ne].view(4, ne),
                     *rows[4 * ne:4 * ne + 4 * ns].view(4, ns),
                     *rows[4 * ne + 4 * ns:].view(13, nr))))


def _rhs_kernels(m, fs: ForcingSlice, y, close_boundary: bool,
                 coeffs: "list | None" = None):
    """``_rhs`` on a lake-free mesh as three launches on one stream:
    ``edge.rhs_cell``, the edge kernel (``edge_coeff`` given *coeffs*,
    else ``edge_flux``) and ``edge.rhs_assemble`` (``csrc/edge_rhs.cu``),
    each output bitwise ``_rhs_plain``'s; a gather list whose sum's order
    the assembly does not keep adds a launch and torch's sum of it
    (``_rhs_assemble``; none on the benchmark's meshes).  Float32 CUDA
    tensors only; anything else raises."""
    ne, ns, nr = m.num_ele, m.num_seg, m.num_riv
    cell, flags, src = _rhs_cell_inputs(m, fs, y)
    out = dict(zip(_RHS_CELL_OUT, edge_mod.rhs_cell(cell, flags)))
    sf, gw, et = src["sf"], out["gw"], m.edge_tables
    if coeffs is not None:
        q_surf, q_sub, *cs = edge_mod.edge_coeff(sf, gw, out["eff_kh"], et,
                                                 close_boundary)
        coeffs.extend(cs)
    else:
        q_surf, q_sub = edge_mod.edge_flux(sf, gw, out["eff_kh"], et,
                                           close_boundary)
    src.update(out, q_surf=q_surf, q_sub=q_sub)
    dy, q_esub, rows = _rhs_assemble(*_rhs_assemble_inputs(m, src), ne, ns,
                                     nr)
    out.update(_rhs_rows(rows, ne, ns, nr))
    cu = CellUpdate(*(out[k] for k in CellUpdate._fields))
    # no lake: the lake terms empty, as _rhs_plain's
    lakes = ("q_lake_prcp", "q_lake_surf", "q_lake_sub", "q_lake_rivin",
             "lake_area")
    empty = y.new_zeros(0)
    diag = {k: out[k] for k in (
        "q_infil", "q_exfil", "q_rech", "q_surf_tot", "q_sub_tot",
        "q_seg_surf", "q_seg_sub", "q_riv_surf", "q_riv_sub", "q_riv_down",
        "q_riv_up", "q_e2r_surf", "q_e2r_sub", "es", "eu", "eg", "tu", "tg",
        "e_ic", "ibeta", "eff_kh", "satn", "theta")}
    diag.update(dict.fromkeys(lakes + ("q_lake_evap",), empty),
                q_esurf=q_surf, q_esub=q_esub)
    saved = {k: out[k] for k in (
        "gw", "riv_stage", "ibeta", "r_topw", "r_csa", "r_per", "r_hyd",
        "s_down", "s_out", "seg_isf", "seg_isf_raw", "d_area_raw",
        "d_area")}
    saved.update(dict.fromkeys(lakes + ("q_lake_evap_raw",), empty), sf=sf,
                 us=src["us"], lake_stg=y[3 * ne + nr:], cu=cu)
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


def rhs(m, fs: ForcingSlice, t, y, close_boundary: bool = True,
        exact_parity: bool = False):
    dy, _ = rhs_full(m, fs, t, y, close_boundary, exact_parity)
    return dy


def linearize(m, fs: ForcingSlice, t, y, close_boundary: bool = True,
              exact_parity: bool = False):
    """``jax.linearize`` of ``rhs`` at *y*: ``(rhs(y), v -> J(y)·v)``.

    The solver's hook (``solve_to(..., linearize=)``), called once per
    Newton iteration as ``shud_tpu/solver/bdf.py:174`` calls
    ``jax.linearize``.  The primal runs once: the edge fluxes come from the
    coefficient kernel (``edge.edge_coeff``, its plain version off the
    kernel path), as JAX's ``custom_jvp`` puts ``_edge_kernel_coeff`` in
    the primal pass, so ``dy`` is ``rhs``'s.  Every other chain-rule factor
    and branch mask of the RHS is kept as a plain tensor (``_tangent``),
    and the returned J·v is tensor arithmetic on them: one ``edge_apply``
    (the apply kernel on the kernel path), fixed-width gathers and
    elementwise products, no ``torch.func``, autograd or dual tensors.
    The tangent follows ``jax.jvp``'s conventions (0.5 at a ``maximum``
    tie, ``where`` selects, +1 for ``|x|`` at 0, no tangent across a
    switch such as ``gw + us > aq_depth``).

    ``exact_parity`` (the absolute-head oracle route) is refused: its J·v
    is ``torch.func.jvp`` of ``rhs``."""
    if exact_parity:
        raise ValueError("linearize follows the local-datum RHS; take "
                         "torch.func.jvp of rhs for exact_parity=True")
    coeffs = []
    dy, _, saved = _rhs(m, fs, y, close_boundary, False, coeffs)
    return dy, _tangent(m, fs, saved, coeffs)


def _cell_update_lin(m, sf, us, gw):
    """Tangent factors of ``update_element`` (+ the lake override):
    d(eff_kh)/d gw, d(deficit)/d gw, and d/d(us, gw) of satn, sat_kr and
    theta."""
    aq, ts, tr = m.aq_depth, m.theta_s, m.theta_r
    # eff_kh: d part / d gw = (d part_num - part [gw != 0]) / g
    below = (m.mac_d <= ZERO) | (gw < aq - m.mac_d)
    g = torch.where(gw == 0.0, 1.0, gw)
    k_mac, af, k_mx = m.mac_ksat_h, m.geo_v_area_f, m.ksat_h
    part = (k_mac * (gw - (aq - m.mac_d)) * af + k_mx * (
        aq - m.mac_d + (gw - (aq - m.mac_d)) * (1.0 - af))) / g
    dpn = k_mac * af + k_mx * (1.0 - af)
    kh_gw = torch.where(below | (gw > aq), 0.0,
                        torch.where(gw == 0.0, dpn, dpn - part) / g)
    # deficit, theta, satn
    def_raw = aq - gw
    sat = def_raw <= 0.0
    def_gw = -ph.d_max(def_raw, 0.0)
    dd = torch.where(sat, 1.0, maximum(def_raw, 0.0))
    th_us = torch.where(sat, 0.0, ts / dd)
    th_gw = torch.where(sat, 0.0, -(us / dd) / dd * def_gw * ts)
    theta = torch.where(sat, ts, us / dd * ts)
    satn = torch.where(sat, 1.0, (theta - tr) / (ts - tr))
    sn_us, sn_gw = th_us / (ts - tr), th_gw / (ts - tr)
    # the clip and van Genuchten branch, then the hi/lo overrides
    edge = (satn > 0.99) | (satn <= ZERO)
    fclip = (ph.d_min(maximum(satn, 1e-12), 1.0 - 1e-12)
             * ph.d_max(satn, 1e-12))
    kr_s = ph.sat_k_fun_lin(ph.clip(satn, 1e-12, 1.0 - 1e-12), m.beta) * fclip
    out = dict(kh_gw=kh_gw, def_gw=def_gw,
               sn_us=sn_us, sn_gw=sn_gw, kr_us=kr_s * sn_us,
               kr_gw=kr_s * sn_gw, th_us=th_us, th_gw=th_gw)
    for k in ("sn_us", "sn_gw", "kr_us", "kr_gw", "th_us", "th_gw"):
        out[k] = torch.where(edge, 0.0, out[k])
    if m.num_lake > 0:
        is_lake = m.i_lake > 0
        out = {k: torch.where(is_lake, 0.0, v) for k, v in out.items()}
    return out


def _vertical_lin(m, fs, sf, us, gw, cu, ibeta, c):
    """Tangent factors of the cell's vertical fluxes: for each of q_infil,
    q_exfil, q_rech, es, eu, eg, tu, tg a dict of d/d sf, d/d us, d/d gw
    (lake cells 0).  *c* are ``_cell_update_lin``'s factors."""
    zero = torch.zeros_like(sf)
    ts, tr = m.theta_s, m.theta_r
    va, vb, pj = m.veg_frac, 1.0 - m.veg_frac, 1.0 - m.imp_af

    # et_flux: ibeta through the clipped soil-moisture stress
    fc = ts * 0.75
    bs_raw = (cu.satn * (ts - tr) - tr) / (fc - tr)
    bs_f = (ph.d_min(maximum(bs_raw, 0.0), 1.0) * ph.d_max(bs_raw, 0.0)
            * (ts - tr) / (fc - tr))
    ib_f = (0.5 * torch.sin(3.1415926 * ph.clip(bs_raw, 0.0, 1.0))
            * 3.1415926 * bs_f)
    ib_us, ib_gw = ib_f * c["sn_us"], ib_f * c["sn_gw"]
    pe = fs.pot_evap
    a_sf = maximum(sf, 0.0)
    es_sf = ph.d_min(a_sf, pe) * ph.d_max(sf, 0.0) * vb
    es_v = torch.minimum(a_sf, pe) * vb
    rem = pe - es_v
    some_left = es_v < pe
    gw_high = gw > m.wetland_level
    a_gw, a_us = maximum(gw, 0.0), maximum(us, 0.0)
    m_gw, m_us = ph.d_max(gw, 0.0), ph.d_max(us, 0.0)
    f = pj * vb
    on = some_left & gw_high
    eg = {"sf": torch.where(on, ph.d_min(rem, a_gw) * -es_sf * f, 0.0),
          "us": zero,
          "gw": torch.where(on, ph.d_min(a_gw, rem) * m_gw * f, 0.0)}
    on = some_left & ~gw_high
    b = ibeta * rem
    w_a, w_b = ph.d_min(a_us, b), ph.d_min(b, a_us)
    eu = {"sf": torch.where(on, w_b * ibeta * -es_sf * f, 0.0),
          "us": torch.where(on, (w_a * m_us + w_b * ib_us * rem) * f, 0.0),
          "gw": torch.where(on, w_b * ib_gw * rem * f, 0.0)}
    live = (fs.lai > ZERO) & ~(fs.e_ic >= fs.pot_tran)
    deep = gw > m.rootreach_level
    room = fs.pot_tran - fs.e_ic
    f = pj * va
    on = live & deep
    tg = {"sf": zero, "us": zero,
          "gw": torch.where(on, ph.d_min(a_gw, room) * m_gw * f, 0.0)}
    on = live & ~deep
    b = ibeta * room
    w_a, w_b = ph.d_min(a_us, b), ph.d_min(b, a_us)
    tu = {"sf": zero,
          "us": torch.where(on, (w_a * m_us + w_b * ib_us * room) * f, 0.0),
          "gw": torch.where(on, w_b * ib_gw * room * f, 0.0)}
    es = {"sf": es_sf, "us": zero, "gw": zero}

    # flux_infiltration (no tangent across the gw + us > aq_depth switch)
    aq, inf_d, ksv_i = m.aq_depth, m.inf_d, m.inf_ksat_v
    av = sf + fs.net_prcp
    gas = (gw + us > aq) | (cu.deficit < us)
    qex_f = torch.where(gas, ph.d_abs(gw + us - aq) / aq * cu.kmax, 0.0)
    grad = 1.0 + av / inf_d
    heavy, medium = av > cu.kmax, av > ksv_i
    a1, a2 = ksv_i * (1.0 - m.h_area_f), m.h_area_f * m.mac_ksat_v
    kr_a1 = cu.sat_kr * ksv_i * (1.0 - m.h_area_f)
    effk = torch.where(heavy, a1 + a2 * cu.satn,
                       torch.where(medium, kr_a1 + a2 * cu.satn, kr_a1))

    def effk_lin(x):
        sn, kr = c[f"sn_{x}"], c[f"kr_{x}"]
        return torch.where(heavy, a2 * sn,
                           torch.where(medium, kr * a1 + a2 * sn, kr * a1))

    x = grad * effk
    top = maximum(x, 0.0)
    w_av, w_x = ph.d_min(av, top), ph.d_min(top, av) * ph.d_max(x, 0.0)
    on = (av > 0.0) & (cu.deficit > inf_d) & ~gas
    fu = fs.fu_surf
    qi = {"sf": torch.where(on, w_av + w_x * effk / inf_d, 0.0) * fu,
          "us": torch.where(on, w_x * grad * effk_lin("us"), 0.0) * fu,
          "gw": torch.where(on, w_x * grad * effk_lin("gw"), 0.0) * fu}
    qx = {"sf": zero, "us": qex_f * fu, "gw": qex_f * fu}

    # flux_recharge: the harmonic mean through d num and d denom
    ksv, tfc = m.ksat_v, m.theta_fc
    z = (cu.theta - tr) / (tfc - tr)
    cond = (cu.theta > tr) & (us > EPSILON)
    grad_r = torch.where(cond, maximum(z, 0.0), 0.0)
    ku = ksv_i * cu.sat_kr
    dsum = cu.deficit + gw
    denom = cu.deficit * ksv + gw * ku
    flat = denom == 0.0
    dsafe = torch.where(flat, 1.0, denom)
    ke0 = ku * ksv * dsum / dsafe
    ke = torch.where(flat, 0.0, ke0)
    off = ((ksv_i <= 0.0) | (ksv <= 0.0)
           | ((gw > aq - inf_d) & (us < cu.deficit)))
    qr = {"sf": zero}
    for x, dgw in (("us", 0.0), ("gw", 1.0)):
        ddef = c["def_gw"] if x == "gw" else zero
        dku = ksv_i * c[f"kr_{x}"]
        dden = ddef * ksv + dgw * ku + gw * dku
        dnum = dku * ksv * dsum + ku * ksv * (ddef + dgw)
        dke = torch.where(flat, 0.0, (dnum - ke0 * dden) / dsafe)
        dgrad = torch.where(cond, ph.d_max(z, 0.0) * c[f"th_{x}"]
                            / (tfc - tr), 0.0)
        qr[x] = torch.where(off, 0.0, dgrad * ke + grad_r * dke) * fs.fu_sub

    out = dict(qi=qi, qx=qx, qr=qr, es=es, eu=eu, eg=eg, tu=tu, tg=tg)
    if m.num_lake > 0:
        is_lake = m.i_lake > 0
        out = {k: {x: torch.where(is_lake, 0.0, v) for x, v in d.items()}
               for k, d in out.items()}
    return out


def _lake_toparea_lin(m, lake_stg):
    """d ``_lake_toparea`` / d lake_stg, the scan's tangent."""
    yq = lake_stg + m.lake_zmin
    yi, ai = m.lake_bathy_y, m.lake_bathy_a
    ta = ai[:, 0]
    dta = torch.zeros_like(ta)
    done = yq <= yi[:, 0]
    for i in range(1, yi.shape[1]):
        below = yq < yi[:, i]
        same = yi[:, i] == yq
        den = torch.where(same, 1.0, yi[:, i] - yq)
        dden = torch.where(same, 0.0, -1.0)
        ratio = (ai[:, i] - ta) / den
        dratio = (-dta - ratio * dden) / den
        interp = ratio * (yq - yi[:, i - 1]) + ta
        dinterp = dratio * (yq - yi[:, i - 1]) + ratio + dta
        ta = torch.where(done, ta, torch.where(below, interp, ai[:, i]))
        dta = torch.where(done, dta, torch.where(below, dinterp, 0.0))
        done = done | below
    return dta


def _lake_bank_lin(m, sf, gw, lake_stg, eff_kh, kh_gw):
    """Tangent factors of ``edge_fluxes``' lake-bank edges [Ne,3]: the
    surface weir's d/d sf and d/d lake stage, the Darcy flux's d/d gw (own
    cell, eff_kh through *kh_gw* included), d/d of the neighbour's eff_kh,
    and d/d lake stage: ``(ls_sf, ls_lk, lb_gw, half_k, lb_lk)``.
    *eff_kh* covers the rows ``m.nb`` points at, the cells' own first (a
    sharded rank appends its ghost rows)."""
    lk, nb = m.lk, m.nb
    isf = maximum(sf, 0.0)[:, None]
    lake_nb = lake_stg[lk]
    lake_nsf = maximum(lake_nb, 0.0)
    c_y0, c_yj = ph.weir_flow_jtoi_local_lin(
        lake_nsf + m.edge_lake_dzl, isf, lake_nsf, 0.6, m.edge, 0.01)
    ls_sf = c_yj * ph.d_max(sf, 0.0)[:, None]
    ls_lk = c_y0 * ph.d_max(lake_nb, 0.0)
    gw_col = gw[:, None]
    dh = (gw_col - lake_nb) + m.edge_lake_dzb
    ym = ph.avg_y_gw(gw_col, lake_nb)
    grad = dh / m.dist_nb
    km = 0.5 * (eff_kh[:sf.shape[0], None] + eff_kh[nb])
    live = ~(((dh > 0.0) & (gw_col <= 0.02))
             | ((dh < 0.0) & (lake_nb <= 0.02)))
    B = m.edge
    half_k = torch.where(live, 0.5 * grad * ym * B, 0.0)
    lb_gw = torch.where(live, (km / m.dist_nb * ym + km * grad * 0.5
                               * ph.d_max(gw, 0.0)[:, None]) * B, 0.0) \
        + half_k * kh_gw[:, None]
    lb_lk = torch.where(live, (-km / m.dist_nb * ym + km * grad * 0.5
                               * ph.d_max(lake_nb, 0.0)) * B, 0.0)
    return ls_sf, ls_lk, lb_gw, half_k, lb_lk


def _reach_lin(m, rs, r_csa, r_per, r_hyd, s_down, s_out):
    """Tangent factors of each reach's downstream discharge at the stage
    *rs* (Manning down the chain, the outlets' zero-depth-gradient and
    critical-depth laws, to-lake reaches): ``(csa_rs, p_self, p_dn)`` with
    d csa / d rs and ``t_down = p_self·t_rs + p_dn·t_rs[down]``."""
    bs, bw = m.riv_bank_slope, m.riv_bottom_width
    csa_rs = ph.d_max(rs * (bw + rs * bs), 0.0) * (bw + 2.0 * rs * bs)
    root = torch.sqrt(1.0 + bs**2)
    per_rs = (ph.d_max(2.0 * ph.absolute(rs) * root + bw, 0.0)
              * 2.0 * ph.d_abs(rs) * root)
    small = r_per <= ZERO
    psafe = torch.where(small, 1.0, r_per)
    hyd_rs = torch.where(small, 0.0, (csa_rs - r_hyd * per_rs) / psafe)
    rough = m.riv_avg_rough
    has_down = m.riv_down >= 0
    ma, mr, ms = ph.manning_equation_lin(r_csa, rough, r_hyd, s_down)
    int_dn = -ms / m.riv_dist2down
    int_self = ma * csa_rs + mr * hyd_rs - int_dn
    za, zr, zs = ph.manning_equation_lin(r_csa, rough, r_hyd, s_out)
    zdg = za * csa_rs + zr * hyd_rs + zs * 2.0 / m.riv_length
    sq = torch.sqrt(GRAV * maximum(rs, 1e-30))
    crit = (csa_rs * sq + r_csa * (GRAV * ph.d_max(rs, 1e-30)) / (2.0 * sq)) \
        * 60.0
    to_lake = m.riv_to_lake >= 0
    p_self = torch.where(to_lake, zdg, torch.where(
        has_down, int_self,
        torch.where(m.riv_outlet_code == -4, crit, zdg)))
    p_dn = torch.where(~to_lake & has_down, int_dn, 0.0)
    return csa_rs, p_self, p_dn


def _lake_lin(m, lake_stg, ev_raw, prcp, inflow, area):
    """d(lake budget)/d(lake stage) apart from the inflows' own tangents:
    the evaporation clamp (min, then max) and the division by the
    bathymetry's top area (*inflow* the summed inflows, *area* the area)."""
    y_cap = prcp + lake_stg
    evap_lk = (ph.d_max(torch.minimum(ev_raw, y_cap), 0.0)
               * ph.d_min(y_cap, ev_raw))
    return -evap_lk - inflow / (area * area) * _lake_toparea_lin(m, lake_stg)


# the J·v closure's factors, by name: the 3x3 local Jacobian of (dsf, dus,
# dgw) (``lj``), the lateral sums' divisions, d eff_kh / d gw, the BC masks,
# the segment and reach factors and the downstream index
_LJ = ("ssf", "sus", "sgw", "usf", "uus", "ugw", "gsf", "gus", "ggw")
_FACTORS = _LJ + ("a_surf", "a_sub", "kh_gw", "keep_gw", "keep_rs", "w_j",
                  "b_sf", "b_us", "b_gw", "sb_rs", "sb_gw", "p_self", "p_dn",
                  "dn", "dr_area", "dr_rs")


def _tangent_factors(m, fs: ForcingSlice, s: dict) -> dict:
    """The J·v closure's factors (``_FACTORS``) from the primal's
    intermediates *s*: the plain version of the kernels of
    ``csrc/edge_tangent.cu`` (``_tangent_factors_kernel``), taken on the
    CPU, in float64 and off the edge kernels.  Lake-bank edges and lakes
    are ``_tangent``'s."""
    nl = m.num_lake if m.num_lake > 0 else 0
    sf, us, gw, rs, cu = s["sf"], s["us"], s["gw"], s["riv_stage"], s["cu"]
    dtype = sf.dtype
    keep_gw = (m.i_bc <= 0).to(dtype)  # a head BC fixes gw
    keep_rs = (m.riv_bc <= 0).to(dtype)

    # --- cells: the 3x3 local Jacobian of (dsf, dus, dgw) ---
    c = _cell_update_lin(m, sf, us, gw)
    v = _vertical_lin(m, fs, sf, us, gw, cu, s["ibeta"], c)
    qi, qx, qr = v["qi"], v["qx"], v["qr"]
    keep_cell = torch.ones_like(sf)
    if nl > 0:
        keep_cell = (~(m.i_lake > 0)).to(dtype)
    inv_sy = keep_cell / m.sy
    bc_sy = keep_gw * inv_sy
    out = {}
    for x in ("sf", "us", "gw"):
        out["s" + x] = (-qi[x] + qx[x] - v["es"][x]) * keep_cell
        out["u" + x] = (qi[x] - qr[x] - v["eu"][x] - v["tu"][x]) * inv_sy
        out["g" + x] = (qr[x] - qx[x] - v["eg"][x] - v["tg"][x]) * bc_sy
    a_surf = -keep_cell / m.area
    a_sub = -bc_sy / m.area
    kh_gw = c["kh_gw"]

    # --- segments: d q_seg_surf, d q_seg_sub on the gathered tangents ---
    se, sr = m.seg_ele, m.seg_riv
    zero_e = torch.zeros_like(s["seg_isf"])
    w_i, w_j = ph.weir_flow_jtoi_lin(
        zero_e, s["seg_isf"], -m.riv_depth[sr], rs[sr], zero_e, m.seg_cwr,
        m.seg_length, m.depression[se])
    w_i = w_i * ph.d_max(s["seg_isf_raw"], 0.0)
    # seg_isf = sf - q_infil + q_exfil at the segment's cell
    b_sf = w_i * (1.0 - qi["sf"] + qx["sf"])[se]
    b_us = w_i * (-qi["us"] + qx["us"])[se]
    b_gw = w_i * (-qi["gw"] + qx["gw"])[se]
    r_yr, r_ye, r_k = ph.flux_r2e_gw_lin(
        rs[sr], m.aq_depth[se] - m.riv_depth[sr], gw[se], zero_e,
        cu.eff_kh[se], m.riv_ksat_h[sr], m.seg_length, m.riv_bed_thick[sr])
    fu_seg = fs.fu_sub[se]
    sb_rs = r_yr * fu_seg
    sb_gw = (r_ye + r_k * kh_gw[se]) * fu_seg

    # --- reaches: geometry, Manning down the chain, outlets ---
    bs = m.riv_bank_slope
    topw_rs = ph.d_max(rs * bs * 2.0 + m.riv_bottom_width, 0.0) * (bs * 2.0)
    csa_rs, p_self, p_dn = _reach_lin(m, rs, s["r_csa"], s["r_per"],
                                      s["r_hyd"], s["s_down"], s["s_out"])
    dn = torch.where(m.riv_down >= 0, m.riv_down, 0)
    # d_area = maximum(d_area_raw, -r_csa), then the dA -> dy quadratic
    da_raw, floor = s["d_area_raw"], -s["r_csa"]
    f_da, f_w = ph.fun_da_to_dy_lin(s["d_area"], s["r_topw"], bs)
    dr_area = keep_rs * f_da * ph.d_max(da_raw, floor) / m.riv_length
    dr_rs = keep_rs * (f_w * topw_rs - f_da * ph.d_max(floor, da_raw) * csa_rs)
    out.update(a_surf=a_surf, a_sub=a_sub, kh_gw=kh_gw, keep_gw=keep_gw,
               keep_rs=keep_rs, w_j=w_j, b_sf=b_sf, b_us=b_us, b_gw=b_gw,
               sb_rs=sb_rs, sb_gw=sb_gw, p_self=p_self, p_dn=p_dn, dn=dn,
               dr_area=dr_area, dr_rs=dr_rs)
    return out


# the kernels' inputs, in csrc/edge_tangent.cu's CellField and ReachField
# order (the primal's intermediates, the forcing, the mesh), and their
# output rows
_TANGENT_CELL_FIELDS = (
    "sf", "us", "gw", "deficit", "satn", "sat_kr", "theta", "kmax", "ibeta",
    "pot_evap", "lai", "e_ic", "pot_tran", "net_prcp", "fu_surf", "fu_sub",
    "aq_depth", "theta_s", "theta_r", "mac_d", "mac_ksat_h", "geo_v_area_f",
    "ksat_h", "beta", "veg_frac", "imp_af", "wetland_level",
    "rootreach_level", "inf_d", "inf_ksat_v", "h_area_f", "mac_ksat_v",
    "ksat_v", "theta_fc", "sy", "area")
_TANGENT_CELL_OUT = _LJ + ("a_surf", "a_sub", "kh_gw", "keep_gw", "sum_sf",
                           "sum_us", "sum_gw")
_TANGENT_REACH_FIELDS = (
    ("seg_isf", "seg_isf_raw", "seg_cwr", "seg_length"),  # [ns]
    ("depression", "aq_depth", "gw", "eff_kh", "fu_sub", "kh_gw", "sum_sf",
     "sum_us", "sum_gw"),  # [ne], read at a segment's cell
    ("riv_stage", "riv_depth", "riv_ksat_h", "riv_bed_thick",
     "riv_bank_slope", "riv_bottom_width", "r_csa", "r_per", "r_hyd",
     "s_down", "s_out", "d_area_raw", "d_area", "r_topw", "riv_avg_rough",
     "riv_dist2down", "riv_length"))  # [nr]
_TANGENT_SEG_OUT = ("w_j", "b_sf", "b_us", "b_gw", "sb_rs", "sb_gw")
_TANGENT_RIV_OUT = ("p_self", "p_dn", "dr_area", "dr_rs", "keep_rs")


def _tangent_cell_inputs(m, fs: ForcingSlice, s: dict):
    """``(floats, flags, get)``: the cell kernel's inputs as ``(name,
    tensor)`` in ``_TANGENT_CELL_FIELDS`` order and ``i_bc``, ``i_lake``,
    and *get*, which finds any input by name in the primal's
    intermediates *s*, the forcing or the mesh."""
    src = dict(fs._asdict())
    src.update(s["cu"]._asdict())
    src.update({k: s[k] for k in ("sf", "us", "gw", "ibeta", "riv_stage",
                                  "seg_isf", "seg_isf_raw", "r_csa", "r_per",
                                  "r_hyd", "s_down", "s_out", "d_area_raw",
                                  "d_area", "r_topw")})

    def get(k):
        return src[k] if k in src else getattr(m, k)

    return ([(k, get(k)) for k in _TANGENT_CELL_FIELDS],
            [(k, getattr(m, k)) for k in ("i_bc", "i_lake")], get)


def _tangent_reach_inputs(m, get, cell_out: dict):
    """``(floats, flags)``: the reach kernel's inputs as ``(name, tensor,
    length)`` in ``_TANGENT_REACH_FIELDS`` order, then the segments' and
    reaches' index and code arrays; *cell_out* the cell kernel's rows by
    name (``_TANGENT_CELL_OUT``), *get* as ``_tangent_cell_inputs``'."""
    ne, nr, ns = m.num_ele, m.num_riv, m.num_seg
    seg, at_cell, riv = _TANGENT_REACH_FIELDS
    floats = ([(k, get(k), ns) for k in seg]
              + [(k, cell_out[k] if k in cell_out else get(k), ne)
                 for k in at_cell]
              + [(k, get(k), nr) for k in riv])
    flags = ([(k, getattr(m, k), ns) for k in ("seg_ele", "seg_riv")]
             + [(k, getattr(m, k), nr) for k in (
                 "riv_bc", "riv_down", "riv_to_lake", "riv_outlet_code")])
    return floats, flags


def _tangent_factors_kernel(m, fs: ForcingSlice, s: dict) -> dict:
    """``_tangent_factors`` as two launches, ``edge.tangent_cell`` then
    ``edge.tangent_reach`` (``csrc/edge_tangent.cu``), each factor bitwise
    its plain version's.  Float32 CUDA tensors only; anything else
    raises."""
    nr, ns = m.num_riv, m.num_seg
    cell, flags, get = _tangent_cell_inputs(m, fs, s)
    out = dict(zip(_TANGENT_CELL_OUT,
                   edge_mod.tangent_cell(cell, flags, m.num_lake > 0)))
    buf, out["dn"] = edge_mod.tangent_reach(
        *_tangent_reach_inputs(m, get, out), ns, nr)
    out.update(zip(_TANGENT_SEG_OUT, buf[:6 * ns].view(6, ns)))
    out.update(zip(_TANGENT_RIV_OUT, buf[6 * ns:].view(5, nr)))
    return {k: out[k] for k in _FACTORS}


def _tangent(m, fs: ForcingSlice, s: dict, coeffs: list):
    """The factors of ``linearize`` and the J·v closure over them: on the
    edge kernels' route (float32 on CUDA) from ``_tangent_factors_kernel``,
    elsewhere from ``_tangent_factors``."""
    ne, nr = m.num_ele, m.num_riv
    nl = m.num_lake if m.num_lake > 0 else 0
    sf, gw, cu = s["sf"], s["gw"], s["cu"]
    kernel = _on_kernels(m, sf)
    fac = (_tangent_factors_kernel if kernel else _tangent_factors)(m, fs, s)
    lj = {k: fac[k] for k in _LJ}
    a_surf, a_sub, kh_gw = fac["a_surf"], fac["a_sub"], fac["kh_gw"]
    keep_gw, keep_rs, dn = fac["keep_gw"], fac["keep_rs"], fac["dn"]
    w_j, b_sf, b_us, b_gw = fac["w_j"], fac["b_sf"], fac["b_us"], fac["b_gw"]
    sb_rs, sb_gw = fac["sb_rs"], fac["sb_gw"]
    p_self, p_dn = fac["p_self"], fac["p_dn"]
    dr_area, dr_rs = fac["dr_area"], fac["dr_rs"]
    se, sr = m.seg_ele, m.seg_riv

    if nl > 0:
        # lake-bank edges, merged by mask (no fu_sub on their lake sums)
        is_lake_cell = m.i_lake > 0
        has_lake, lk, nb = m.has_lake, m.lk, m.nb
        ls_sf, ls_lk, lb_gw, half_k, lb_lk = _lake_bank_lin(
            m, sf, gw, s["lake_stg"], cu.eff_kh, kh_gw)
        lb_gwn = half_k * kh_gw[nb]
        lake_edge = has_lake & ~is_lake_cell[:, None]
        # lakes: evaporation clamp, bathymetry, the bucket's division
        area = s["lake_area"]
        inv_area = 1.0 / area
        c_lk = _lake_lin(m, s["lake_stg"], s["q_lake_evap_raw"],
                         s["q_lake_prcp"],
                         s["q_lake_rivin"] + s["q_lake_sub"]
                         + s["q_lake_surf"], area)

    apply = edge_mod.edge_apply if kernel else edge_mod.edge_apply_plain
    et, gl, fu_sub = m.edge_tables, m.lists, fs.fu_sub

    def jvp(vec):
        tsf = vec[:ne]
        tus = vec[ne:2 * ne]
        tgw = vec[2 * ne:3 * ne] * keep_gw
        trs = vec[3 * ne:3 * ne + nr] * keep_rs
        tqs, tqb = apply(coeffs, tsf, tgw, kh_gw * tgw, et)
        if nl > 0:
            tlk = vec[3 * ne + nr:]
            tl = tlk[lk]
            tqs = torch.where(has_lake, ls_sf * tsf[:, None] + ls_lk * tl,
                              tqs)
            tqb = torch.where(has_lake, lb_gw * tgw[:, None]
                              + lb_gwn * tgw[nb] + lb_lk * tl, tqb)
        t_ss = (b_sf * tsf[se] + b_us * tus[se] + b_gw * tgw[se]
                + w_j * trs[sr])
        t_sb = sb_rs * trs[sr] + sb_gw * tgw[se]
        t_surf = tqs.sum(dim=1) - gather_sum(t_ss, gl.seg_to_ele)
        t_sub = fu_sub * tqb.sum(dim=1) - gather_sum(t_sb, gl.seg_to_ele)
        tdsf = lj["ssf"] * tsf + lj["sus"] * tus + lj["sgw"] * tgw \
            + a_surf * t_surf
        tdus = lj["usf"] * tsf + lj["uus"] * tus + lj["ugw"] * tgw
        tdgw = lj["gsf"] * tsf + lj["gus"] * tus + lj["ggw"] * tgw \
            + a_sub * t_sub
        t_down = p_self * trs + p_dn * trs[dn]
        t_area = (gather_sum(t_down, gl.riv_to_down)
                  - gather_sum(t_ss, gl.seg_to_riv)
                  - gather_sum(t_sb, gl.seg_to_riv) - t_down)
        tdriv = dr_area * t_area + dr_rs * trs
        parts = [tdsf, tdus, tdgw, tdriv]
        if nl > 0:
            t_in = (gather_sum(t_down, gl.riv_to_lake)
                    + gather_sum(torch.where(lake_edge, tqb, 0.0).reshape(-1),
                                 gl.edge_to_lake)
                    + gather_sum(torch.where(lake_edge, tqs, 0.0).reshape(-1),
                                 gl.edge_to_lake))
            parts.append(t_in * inv_area + c_lk * tlk)
        return torch.cat(parts)

    return jvp
