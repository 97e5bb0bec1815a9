# A frozen copy of shud_tpu_torch/core/mesh.py,
# its imports rewritten to this package; the sequential passes of
# native/ in Python.
"""Static mesh/parameter pipeline.

Builds every derived per-entity constant the RHS needs, as dense numpy
arrays, reproducing the reference's initialisation semantics exactly
(``src/ModelData/MD_initialize.cpp:168-245``, ``src/classes/Element.cpp``,
``src/classes/Node.cpp``, ``src/ModelData/Model_Data.cpp:238-266`` rmSinks).

Index conventions: all cross-entity index arrays here are **0-based**, with
``-1`` meaning "none".  Lake neighbour codes are kept as separate arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.config import HEIGHT_WIND_MEASURE, MINRIVSLOPE
from portbench.reference.project import Calib, ProjectInput


# ---------------------------------------------------------------------------
# small geometry helpers (reference: functions.cpp)
# ---------------------------------------------------------------------------
def _eudist(x1, y1, x2, y2):
    return np.hypot(x2 - x1, y2 - y1)


def _perp_foot(px, py, x1, y1, x2, y2):
    """Foot of the perpendicular from (px,py) onto the line (x1,y1)-(x2,y2)."""
    dx, dy = x2 - x1, y2 - y1
    denom = dx * dx + dy * dy
    t = ((px - x1) * dx + (py - y1) * dy) / denom
    return x1 + t * dx, y1 + t * dy


@dataclasses.dataclass
class MeshData:
    """All static per-entity arrays.  Plain numpy on host; converted to jnp
    device arrays by the runtime."""

    # sizes
    num_ele: int
    num_riv: int
    num_seg: int
    num_lake: int

    # --- per element geometry ---
    area: np.ndarray  # [Ne]
    x: np.ndarray
    y: np.ndarray
    z_surf: np.ndarray
    z_bottom: np.ndarray
    edge: np.ndarray  # [Ne,3]
    dist2edge: np.ndarray  # [Ne,3]
    dist2nabor: np.ndarray  # [Ne,3]
    avg_rough: np.ndarray  # [Ne,3]
    nabr: np.ndarray  # [Ne,3] 0-based, -1 none (incl. lake-coded)
    lakenabr: np.ndarray  # [Ne,3] 0-based lake index, -1 none
    nabr_to_me: np.ndarray  # [Ne,3] reciprocal edge slot (0..2), -1 none
    edge_dz_surf: np.ndarray  # [Ne,3] z_surf_i - z_surf_nb (f64-precomputed)
    edge_dz_bottom: np.ndarray  # [Ne,3] z_bottom_i - z_bottom_nb
    nx: np.ndarray
    ny: np.ndarray
    nz: np.ndarray
    slope_angle: np.ndarray
    aspect: np.ndarray

    # --- per element parameters (post-calibration, cell-resident) ---
    aq_depth: np.ndarray
    wetland_level: np.ndarray
    rootreach_level: np.ndarray
    macpore_level: np.ndarray
    fix_pressure: np.ndarray
    depression: np.ndarray
    wind_h: np.ndarray
    # soil
    inf_ksat_v: np.ndarray
    theta_s: np.ndarray
    theta_fc: np.ndarray
    theta_r: np.ndarray
    alpha: np.ndarray
    beta: np.ndarray
    h_area_f: np.ndarray
    mac_ksat_v: np.ndarray
    inf_d: np.ndarray
    # geol
    ksat_h: np.ndarray
    ksat_v: np.ndarray
    geo_theta_s: np.ndarray
    geo_theta_r: np.ndarray
    geo_v_area_f: np.ndarray
    mac_ksat_h: np.ndarray
    mac_d: np.ndarray
    sy: np.ndarray
    # landcover
    veg_frac: np.ndarray
    albedo: np.ndarray
    rough: np.ndarray
    rz_d: np.ndarray
    soil_dgrd: np.ndarray
    imp_af: np.ndarray
    # attribute indices (1-based as read; 0 = none)
    i_soil: np.ndarray
    i_geol: np.ndarray
    i_lc: np.ndarray
    i_forc: np.ndarray
    i_mf: np.ndarray
    i_bc: np.ndarray
    i_ss: np.ndarray
    i_lake: np.ndarray  # per-cell lake id, 1-based; 0 = not in a lake

    # --- per river (post-calibration) ---
    riv_down_raw: np.ndarray  # raw down code (1-based or negative outlet code)
    riv_down: np.ndarray  # 0-based downstream idx, -1 if outlet/lake
    riv_outlet_code: np.ndarray  # 0 if has downstream, else the raw code
    riv_to_lake: np.ndarray  # 0-based lake index or -1
    riv_bc: np.ndarray
    riv_length: np.ndarray
    riv_bed_slope: np.ndarray
    riv_depth: np.ndarray
    riv_bank_slope: np.ndarray
    riv_bottom_width: np.ndarray
    riv_sinuosity: np.ndarray
    riv_rough: np.ndarray  # [min m^-1/3]
    riv_cwr: np.ndarray
    riv_ksat_h: np.ndarray  # [m/min]
    riv_bed_thick: np.ndarray
    riv_avg_rough: np.ndarray
    riv_dist2down: np.ndarray

    # --- per segment ---
    seg_riv: np.ndarray  # 0-based river idx
    seg_ele: np.ndarray  # 0-based element idx
    seg_length: np.ndarray
    seg_cwr: np.ndarray
    seg_ksat_h: np.ndarray
    seg_eq_dist: np.ndarray

    # --- lakes ---
    lake_zmin: np.ndarray  # [Nl]
    lake_bathy_y: np.ndarray  # [Nl, K] stage grid (absolute elevation)
    lake_bathy_a: np.ndarray  # [Nl, K] top areas
    lake_num_ele: np.ndarray  # [Nl] number of lake cells
    # f64-precomputed per-edge lake datums for the reduced-precision path
    # (same trick as edge_dz_surf/edge_dz_bottom: km-scale absolute
    # elevations cancel once on the host, so f32 keeps mm-scale heads)
    edge_lake_dzl: np.ndarray = None  # [Ne,3] lake_zmin[lk] - z_surf_i
    edge_lake_dzb: np.ndarray = None  # [Ne,3] z_bottom_i - bathy_y[lk,0]

    watershed_area: float = 0.0
    # roll-gather tables (populated when the mesh's neighbour offsets
    # concentrate into few distinct values, e.g. structured meshes):
    # nbv[i,j] = roll(x, -offsets[k])[i] where k = roll_k_idx[i,j]
    roll_offsets: tuple = None  # (K,) python ints (STATIC), or None
    roll_k_idx: np.ndarray = None  # [Ne,3] int32 index into offsets
    # blocked tables for the fused Pallas edge kernel (core/pallas_edge.py);
    # built on demand by enable_pallas_edges(); None = use XLA gather/roll
    edge_blocks: object = None


def _rm_sinks(nabr, riv_id, aq_depth, z_surf, z_bottom) -> None:
    """In-place sequential sink removal (Model_Data.cpp:238-266)."""
    for i in range(len(z_surf)):
        zmin_nb = np.inf
        for j in range(3):
            nb = nabr[i, j]
            if nb >= 0:
                zmin_nb = min(zmin_nb, z_surf[nb])
        if np.isfinite(zmin_nb) and zmin_nb > z_surf[i] and riv_id[i] <= 0:
            z_surf[i] = zmin_nb
            z_bottom[i] = zmin_nb - aq_depth[i]


def _nabr_to_me(nabr: np.ndarray) -> np.ndarray:
    """For each cell edge, the neighbour's edge slot that points back
    (-1 where there is no neighbour)."""
    nb = np.where(nabr >= 0, nabr, 0)
    me = np.arange(nabr.shape[0])[:, None]
    out = np.full(nabr.shape, -1, dtype=np.int64)
    for k in (0, 1, 2):  # the last matching slot wins, as in the C++ loop
        out = np.where((nabr >= 0) & (nabr[nb, k] == me), k, out)
    return out


def build_mesh(inp: ProjectInput) -> MeshData:
    gc = inp.calib
    tri = inp.tri
    ne = tri.shape[0]

    node_x = inp.nodes[:, 1]
    node_y = inp.nodes[:, 2]
    node_aqd = inp.nodes[:, 3] + gc.aq_depth_add
    node_zmax = inp.nodes[:, 4]
    node_zmin = node_zmax - node_aqd  # Node::Init (Node.cpp:14-17)

    nidx = tri[:, 1:4].astype(np.int64) - 1  # [Ne,3] node ids, 0-based
    nabr1 = tri[:, 4:7].astype(np.int64)  # 1-based; 0 = boundary

    x123 = node_x[nidx]  # [Ne,3]
    y123 = node_y[nidx]
    zmin123 = node_zmin[nidx]
    zmax123 = node_zmax[nidx]

    x1, x2, x3 = x123.T
    y1, y2, y3 = y123.T

    area = 0.5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1))
    z_surf = zmax123.mean(axis=1)
    z_bottom = zmin123.mean(axis=1)
    cx = x123.mean(axis=1)
    cy = y123.mean(axis=1)

    edge = np.stack(
        [
            _eudist(x2, y2, x3, y3),
            _eudist(x3, y3, x1, y1),
            _eudist(x1, y1, x2, y2),
        ],
        axis=1,
    )

    # perpendicular distances centroid -> each edge (Element.cpp:applyGeometry)
    px1, py1 = _perp_foot(cx, cy, x2, y2, x3, y3)
    px2, py2 = _perp_foot(cx, cy, x3, y3, x1, y1)
    px3, py3 = _perp_foot(cx, cy, x1, y1, x2, y2)
    dist2edge = np.stack(
        [
            _eudist(px1, py1, cx, cy),
            _eudist(px2, py2, cx, cy),
            _eudist(px3, py3, cx, cy),
        ],
        axis=1,
    )

    # terrain normal from the three surface points (Element.cpp:150-232)
    v1 = np.stack([x2 - x1, y2 - y1, zmax123[:, 1] - zmax123[:, 0]], axis=1)
    v2 = np.stack([x3 - x1, y3 - y1, zmax123[:, 2] - zmax123[:, 0]], axis=1)
    nvec = np.cross(v1, v2)
    nlen = np.linalg.norm(nvec, axis=1)
    degenerate = nlen <= 1e-10
    with np.errstate(invalid="ignore", divide="ignore"):
        nunit = nvec / nlen[:, None]
    nunit[degenerate] = [0.0, 0.0, 1.0]
    flip = nunit[:, 2] < 0.0
    nunit[flip] *= -1.0
    nx_, ny_, nz_ = nunit.T
    nz_cl = np.clip(nz_, 0.0, 1.0)
    slope_angle = np.arctan2(np.hypot(nx_, ny_), nz_cl)
    # reference wraps with its truncated PI constant (Macros.hpp:46) — kept
    # for bit-parity of the aspect diagnostic
    ref_2pi = 2.0 * 3.1415926
    aspect = np.arctan2(nx_, ny_)
    aspect = np.where(aspect < 0.0, aspect + ref_2pi, aspect)
    aspect = np.where(aspect >= ref_2pi, aspect - ref_2pi, aspect)
    aspect = np.where(slope_angle < 1e-6, 0.0, aspect)

    # ---------------- parameter tables with calibration -------------------
    soil = _apply_soil_calib(inp.soil, gc)
    geol = _apply_geol_calib(inp.geol, gc)
    lc = _apply_lc_calib(inp.lc, gc)

    i_soil = inp.att[:, 1].astype(np.int64)
    i_geol = inp.att[:, 2].astype(np.int64)
    i_lc = inp.att[:, 3].astype(np.int64)
    i_forc = inp.att[:, 4].astype(np.int64)
    i_mf = inp.att[:, 5].astype(np.int64)
    i_bc = inp.att[:, 6].astype(np.int64)
    i_ss = inp.att[:, 7].astype(np.int64)
    i_lake = inp.att[:, 8].astype(np.int64)

    # cell-resident parameters (positional lookup by 1-based attribute index)
    def gather(table, col, idx1):
        return table[idx1 - 1, col]

    inf_ksat_v = gather(soil, 1, i_soil)
    theta_s = gather(soil, 2, i_soil)
    theta_r = gather(soil, 3, i_soil)
    inf_d = gather(soil, 4, i_soil)
    alpha = gather(soil, 5, i_soil)
    beta = gather(soil, 6, i_soil)
    h_area_f = gather(soil, 7, i_soil)
    mac_ksat_v = gather(soil, 8, i_soil)
    theta_fc = theta_s * 0.75  # FieldCapacityRatio (Element.cpp:copySoil)

    ksat_h = gather(geol, 1, i_geol)
    ksat_v = gather(geol, 2, i_geol)
    geo_theta_s = gather(geol, 3, i_geol)
    geo_theta_r = gather(geol, 4, i_geol)
    geo_v_area_f = gather(geol, 5, i_geol)
    mac_ksat_h = gather(geol, 6, i_geol)
    mac_d = gather(geol, 7, i_geol).copy()
    sy = gc.geol_thetas * geo_theta_s - gc.geol_thetar * geo_theta_r

    albedo = gather(lc, 1, i_lc)
    veg_frac = gather(lc, 2, i_lc).copy()
    rough = gather(lc, 3, i_lc)
    rz_d = gather(lc, 4, i_lc)
    soil_dgrd = gather(lc, 5, i_lc)
    imp_af = gather(lc, 6, i_lc)

    # land-cover modifiers (MD_initialize.cpp:184-186)
    inf_ksat_v = inf_ksat_v * (1.0 - soil_dgrd)
    mac_ksat_v = mac_ksat_v * (1.0 - soil_dgrd)
    veg_frac = veg_frac * (1.0 - imp_af)

    aq_depth = z_surf - z_bottom

    # segments / RivID before rmSinks (MD_initialize.cpp:188-191)
    seg_riv = inp.rivseg[:, 1].astype(np.int64) - 1
    seg_ele = inp.rivseg[:, 2].astype(np.int64) - 1
    seg_length = inp.rivseg[:, 3].copy()
    riv_id_of_ele = np.zeros(ne, dtype=np.int64)
    riv_id_of_ele[seg_ele] = seg_riv + 1

    # --- rmSinks (sequential in-place semantics, Model_Data.cpp:238-266) ---
    z_surf = np.ascontiguousarray(z_surf)
    z_bottom = np.ascontiguousarray(z_bottom)
    nabr0 = np.where(nabr1 > 0, nabr1 - 1, -1)  # 0-based; -1 none
    _rm_sinks(nabr0, riv_id_of_ele, aq_depth, z_surf, z_bottom)

    # final InitElement-derived levels (post-rmSinks)
    mac_d = np.minimum(mac_d, aq_depth)
    wetland_level = aq_depth - inf_d
    rootreach_level = aq_depth - rz_d
    macpore_level = aq_depth - mac_d
    fix_pressure = 101.325 * ((293.0 - 0.0065 * z_surf) / 293.0) ** 5.26

    # per-edge elevation differences for the reduced-precision path:
    # computing dh as (y_i - y_j) + dz with dz precomputed in f64 keeps
    # mm-scale head differences accurate in f32 even with km-scale z
    nb0 = np.where(nabr1 > 0, nabr1 - 1, 0)
    has0 = nabr1 > 0
    edge_dz_surf = np.where(has0, z_surf[:, None] - z_surf[nb0], 0.0)
    edge_dz_bottom = np.where(has0, z_bottom[:, None] - z_bottom[nb0], 0.0)

    # --- applyNabor (Element.cpp:238-270) ---
    nabr_to_me = _nabr_to_me(nabr0)
    dist2nabor = np.zeros((ne, 3))
    avg_rough = np.zeros((ne, 3))
    for j in range(3):
        nj = nabr1[:, j]
        has = nj > 0
        lake_side = nj < 0
        idx = np.where(has, nj - 1, 0)
        dist2nabor[:, j] = np.where(
            has,
            _eudist(cx, cy, cx[idx], cy[idx]),
            np.where(lake_side, dist2edge[:, j], 0.0),
        )
        avg_rough[:, j] = np.where(has, 0.5 * (rough + rough[idx]), rough)

    # ---------------- rivers ------------------------------------------------
    nr = inp.riv.shape[0]
    riv_down_raw = inp.riv[:, 1].astype(np.int64)
    riv_type = inp.riv[:, 2].astype(np.int64)
    riv_bed_slope = np.maximum(MINRIVSLOPE, inp.riv[:, 3])
    riv_length = inp.riv[:, 4].copy()
    riv_bc = inp.riv[:, 5].astype(np.int64)

    rt = inp.rivtype
    # river_para::InitValue + applyCalib (River.cpp:31-56)
    t_depth = rt[:, 1] + gc.riv_dpth_add
    t_bank = rt[:, 2] + gc.riv_bslope_add
    t_width = rt[:, 3] + gc.riv_wdth_add
    t_sinu = rt[:, 4] * gc.riv_sinu
    t_rough = rt[:, 5] / 60.0 * gc.riv_rough
    t_cwr = rt[:, 6] * gc.riv_cwr
    t_ksath = rt[:, 7] / 1440.0 * gc.riv_kh
    t_bedthick = rt[:, 8] * gc.riv_bedthick

    tix = riv_type - 1
    riv_depth = t_depth[tix]
    riv_bank_slope = t_bank[tix]
    riv_bottom_width = t_width[tix]
    riv_sinuosity = t_sinu[tix]
    riv_rough = t_rough[tix]
    riv_cwr = t_cwr[tix]
    riv_ksat_h = t_ksath[tix]
    riv_bed_thick = t_bedthick[tix]

    riv_down = np.where(riv_down_raw >= 1, riv_down_raw - 1, -1)
    riv_outlet_code = np.where(riv_down_raw >= 1, 0, riv_down_raw)
    # lake routing codes: down <= -4 => toLake = (-3 - down) - 1 (MD_Lake.cpp:47-53)
    riv_to_lake = np.where(riv_down_raw <= -4, (-3 - riv_down_raw) - 1, -1)

    down_ix = np.where(riv_down >= 0, riv_down, 0)
    riv_avg_rough = np.where(
        riv_down >= 0, 0.5 * (riv_rough + riv_rough[down_ix]), riv_rough
    )
    riv_dist2down = np.where(
        riv_down >= 0, 0.5 * (riv_length + riv_length[down_ix]), riv_length
    )

    # ---------------- segments ---------------------------------------------
    seg_cwr = t_cwr[riv_type[seg_riv] - 1]
    seg_ksat_h = t_ksath[riv_type[seg_riv] - 1]
    seg_eq_dist = area[seg_ele] / seg_length * 0.5

    # ---------------- lakes -------------------------------------------------
    lake_ids_in_order = []
    for v in i_lake:
        if v > 0 and v not in lake_ids_in_order:
            lake_ids_in_order.append(v)
    num_lake = len(lake_ids_in_order)

    lakenabr = np.full((ne, 3), -1, dtype=np.int64)
    lake_num_ele = np.zeros(max(num_lake, 1), dtype=np.int64)
    lake_zmin = np.zeros(max(num_lake, 1))
    lake_bathy_y = np.zeros((max(num_lake, 1), 1))
    lake_bathy_a = np.zeros((max(num_lake, 1), 1))
    if num_lake > 0:
        # lakenabr: non-lake cell next to a lake cell (MD_Lake.cpp:138-150)
        for i in range(ne):
            if i_lake[i] <= 0:
                for j in range(3):
                    inabr = nabr0[i, j]
                    if inabr >= 0 and i_lake[inabr] > 0:
                        lakenabr[i, j] = i_lake[inabr] - 1
        for li in range(num_lake):
            lake_num_ele[li] = int(np.sum(i_lake == li + 1))
        if inp.lake_bathy is not None:
            kmax = max(b.shape[0] for b in inp.lake_bathy)
            lake_bathy_y = np.zeros((num_lake, kmax))
            lake_bathy_a = np.zeros((num_lake, kmax))
            for li, b in enumerate(inp.lake_bathy):
                k = b.shape[0]
                lake_bathy_y[li, :k] = b[:, 1]
                lake_bathy_a[li, :k] = b[:, 2]
                # pad with the last value so interpolation saturates
                lake_bathy_y[li, k:] = b[-1, 1]
                lake_bathy_a[li, k:] = b[-1, 2]
                lake_zmin[li] = b[0, 1]

    # per-edge lake datums (f64 precompute for the reduced-precision path)
    lkq = np.where(lakenabr >= 0, lakenabr, 0)
    has_lk = lakenabr >= 0
    edge_lake_dzl = np.where(has_lk, lake_zmin[lkq] - z_surf[:, None], 0.0)
    edge_lake_dzb = np.where(
        has_lk, z_bottom[:, None] - lake_bathy_y[lkq, 0], 0.0)

    # roll-gather precompute: if the neighbour offsets (nb - i) take few
    # distinct values (structured meshes), gathers become K rolls + selects
    # — the dominant RHS cost on TPU at large Ne
    nabr0f = np.where(nabr1 > 0, nabr1 - 1, -1)
    offsets = np.where(nabr0f >= 0, nabr0f - np.arange(ne)[:, None], 0)
    uoff = np.unique(offsets[nabr0f >= 0])
    roll_offsets = None
    roll_k_idx = None
    if 0 < len(uoff) <= 16:
        roll_offsets = tuple(int(o) for o in uoff)
        roll_k_idx = np.searchsorted(uoff, offsets).astype(np.int64)
        roll_k_idx = np.where(nabr0f >= 0, roll_k_idx, 0)

    md = MeshData(
        num_ele=ne, num_riv=nr, num_seg=len(seg_riv), num_lake=num_lake,
        area=area, x=cx, y=cy, z_surf=z_surf, z_bottom=z_bottom, edge=edge,
        dist2edge=dist2edge, dist2nabor=dist2nabor, avg_rough=avg_rough,
        nabr=np.where(nabr1 > 0, nabr1 - 1, -1), lakenabr=lakenabr,
        nabr_to_me=nabr_to_me, edge_dz_surf=edge_dz_surf,
        edge_dz_bottom=edge_dz_bottom, nx=nx_, ny=ny_, nz=nz_,
        slope_angle=slope_angle, aspect=aspect,
        aq_depth=aq_depth, wetland_level=wetland_level,
        rootreach_level=rootreach_level, macpore_level=macpore_level,
        fix_pressure=fix_pressure,
        depression=np.full(ne, 0.0002),
        wind_h=np.full(ne, HEIGHT_WIND_MEASURE),
        inf_ksat_v=inf_ksat_v, theta_s=theta_s, theta_fc=theta_fc,
        theta_r=theta_r, alpha=alpha, beta=beta, h_area_f=h_area_f,
        mac_ksat_v=mac_ksat_v, inf_d=inf_d,
        ksat_h=ksat_h, ksat_v=ksat_v, geo_theta_s=geo_theta_s,
        geo_theta_r=geo_theta_r, geo_v_area_f=geo_v_area_f,
        mac_ksat_h=mac_ksat_h, mac_d=mac_d, sy=sy,
        veg_frac=veg_frac, albedo=albedo, rough=rough, rz_d=rz_d,
        soil_dgrd=soil_dgrd, imp_af=imp_af,
        i_soil=i_soil, i_geol=i_geol, i_lc=i_lc, i_forc=i_forc, i_mf=i_mf,
        i_bc=i_bc, i_ss=i_ss, i_lake=i_lake,
        riv_down_raw=riv_down_raw, riv_down=riv_down,
        riv_outlet_code=riv_outlet_code, riv_to_lake=riv_to_lake,
        riv_bc=riv_bc, riv_length=riv_length, riv_bed_slope=riv_bed_slope,
        riv_depth=riv_depth, riv_bank_slope=riv_bank_slope,
        riv_bottom_width=riv_bottom_width, riv_sinuosity=riv_sinuosity,
        riv_rough=riv_rough, riv_cwr=riv_cwr, riv_ksat_h=riv_ksat_h,
        riv_bed_thick=riv_bed_thick, riv_avg_rough=riv_avg_rough,
        riv_dist2down=riv_dist2down,
        seg_riv=seg_riv, seg_ele=seg_ele, seg_length=seg_length,
        seg_cwr=seg_cwr, seg_ksat_h=seg_ksat_h, seg_eq_dist=seg_eq_dist,
        lake_zmin=lake_zmin, lake_bathy_y=lake_bathy_y,
        lake_bathy_a=lake_bathy_a, lake_num_ele=lake_num_ele,
        edge_lake_dzl=edge_lake_dzl, edge_lake_dzb=edge_lake_dzb,
        watershed_area=float(area.sum()),
        roll_offsets=roll_offsets, roll_k_idx=roll_k_idx,
    )
    return md


def _apply_soil_calib(soil: np.ndarray, gc: Calib) -> np.ndarray:
    s = soil.copy()
    s[:, 1] = s[:, 1] / 1440.0 * gc.soil_kinf  # infKsatV [m/d] -> [m/min]
    s[:, 5] = s[:, 5] * gc.soil_alpha
    s[:, 6] = np.maximum(s[:, 6] * gc.soil_beta, 1.1)  # Beta floor 1.1
    s[:, 7] = s[:, 7] * gc.soil_machf
    s[:, 8] = s[:, 8] / 1440.0 * gc.soil_kmacsatv
    s[:, 4] = s[:, 4] * gc.soil_dinf
    return s


def _apply_geol_calib(geol: np.ndarray, gc: Calib) -> np.ndarray:
    g = geol.copy()
    g[:, 1] = g[:, 1] / 1440.0 * gc.geol_ksath
    g[:, 2] = g[:, 2] / 1440.0 * gc.geol_ksatv
    g[:, 5] = g[:, 5] * gc.geol_macvf
    g[:, 6] = g[:, 6] / 1440.0 * gc.geol_kmacsath
    g[:, 7] = g[:, 7] * gc.geol_dmac
    return g


def _apply_lc_calib(lc: np.ndarray, gc: Calib) -> np.ndarray:
    c = lc.copy()
    c[:, 1] = c[:, 1] * gc.lc_albedo
    c[:, 2] = c[:, 2] * gc.lc_vegfrac
    c[:, 3] = c[:, 3] / 60.0 * gc.lc_rough  # [s m^-1/3] -> [min m^-1/3]
    c[:, 4] = c[:, 4] * gc.lc_droot
    c[:, 5] = c[:, 5] * gc.lc_soildgd
    c[:, 6] = c[:, 6] * gc.lc_impaf
    return c
