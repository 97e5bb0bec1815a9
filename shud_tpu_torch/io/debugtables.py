# Copied verbatim from shud_tpu/io/debugtables.py; only the package imports differ.
"""Derived-constant dumps: ``Debug_Table_{Element,River,Lake}.csv``.

Parity with ``Model_Data::debugData`` (Model_Data.cpp:268-301): one
tab-separated row per entity listing every derived per-entity constant
(geometry + post-calibration parameters).  The reference calls these tables
"gold for cross-implementation geometry comparison" (SURVEY.md §4.4) — our
golden mesh tests diff the same quantities in memory; this exporter makes
them available on disk for external tooling and side-by-side diffs against
a reference build.

Column names follow the reference's nested printHeader() chains
(Element.cpp:451-470, River.cpp:91-130) where a direct counterpart exists;
indices are 1-based like the reference.
"""

from __future__ import annotations

import os

import numpy as np


def _write(path: str, header: list[str], cols: list[np.ndarray]):
    n = len(cols[0])
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        for i in range(n):
            f.write("\t".join(
                str(int(c[i])) if np.issubdtype(np.asarray(c).dtype, np.integer)
                else f"{c[i]:g}" for c in cols) + "\n")


def write_debug_tables(md, inp, outdir: str) -> list[str]:
    """Write Debug_Table_*.csv for the mesh into *outdir*; returns paths."""
    os.makedirs(outdir, exist_ok=True)
    written = []

    ne = md.num_ele
    idx = np.arange(1, ne + 1)
    tri_nodes = inp.tri[:, 1:4].astype(np.int64)
    header = ["index", "iSoil", "iGeol", "iLC", "iForc", "iMF", "iBC",
              "iSS", "iLake",
              "node0", "node1", "node2", "nabr0", "nabr1", "nabr2",
              "edge0", "edge1", "edge2", "area", "x", "y", "zmin", "zmax",
              "dist2nabor0", "dist2nabor1", "dist2nabor2",
              "dist2edge0", "dist2edge1", "dist2edge2",
              "avgRough0", "avgRough1", "avgRough2",
              "slope", "aspect", "nx", "ny", "nz",
              "AqD", "WetlandLevel", "RootReachLevel", "MacporeLevel",
              "infKsatV", "ThetaS", "ThetaFC", "ThetaR", "Alpha", "Beta",
              "hAreaF", "macKsatV", "infD",
              "KsatH", "KsatV", "geo_ThetaS", "geo_ThetaR", "geo_vAreaF",
              "macKsatH", "macD", "Sy",
              "VegFrac", "Albedo", "Rough", "RzD", "SoilDgrd", "ImpAF"]
    nabr1 = np.where(np.asarray(md.nabr) >= 0, np.asarray(md.nabr) + 1, 0)
    cols = [idx, md.i_soil, md.i_geol, md.i_lc, md.i_forc, md.i_mf,
            md.i_bc, md.i_ss, md.i_lake,
            tri_nodes[:, 0], tri_nodes[:, 1], tri_nodes[:, 2],
            nabr1[:, 0], nabr1[:, 1], nabr1[:, 2],
            md.edge[:, 0], md.edge[:, 1], md.edge[:, 2],
            md.area, md.x, md.y, md.z_bottom, md.z_surf,
            md.dist2nabor[:, 0], md.dist2nabor[:, 1], md.dist2nabor[:, 2],
            md.dist2edge[:, 0], md.dist2edge[:, 1], md.dist2edge[:, 2],
            md.avg_rough[:, 0], md.avg_rough[:, 1], md.avg_rough[:, 2],
            md.slope_angle, md.aspect, md.nx, md.ny, md.nz,
            md.aq_depth, md.wetland_level, md.rootreach_level,
            md.macpore_level,
            md.inf_ksat_v, md.theta_s, md.theta_fc, md.theta_r, md.alpha,
            md.beta, md.h_area_f, md.mac_ksat_v, md.inf_d,
            md.ksat_h, md.ksat_v, md.geo_theta_s, md.geo_theta_r,
            md.geo_v_area_f, md.mac_ksat_h, md.mac_d, md.sy,
            md.veg_frac, md.albedo, md.rough, md.rz_d, md.soil_dgrd,
            md.imp_af]
    p = os.path.join(outdir, "Debug_Table_Element.csv")
    _write(p, header, [np.asarray(c) for c in cols])
    written.append(p)

    nr = md.num_riv
    if nr:
        ridx = np.arange(1, nr + 1)
        header = ["index", "down", "BC", "zbank_rel", "Length", "BedSlope",
                  "avgRough", "Depth", "BankSlope", "BottomWidth",
                  "Sinuosity", "Rough", "Cwr", "KsatH", "BedThick",
                  "Dist2Down"]
        cols = [ridx, np.asarray(md.riv_down_raw), md.riv_bc,
                md.riv_depth, md.riv_length, md.riv_bed_slope,
                md.riv_avg_rough, md.riv_depth, md.riv_bank_slope,
                md.riv_bottom_width, md.riv_sinuosity, md.riv_rough,
                md.riv_cwr, md.riv_ksat_h, md.riv_bed_thick,
                md.riv_dist2down]
        p = os.path.join(outdir, "Debug_Table_River.csv")
        _write(p, header, [np.asarray(c) for c in cols])
        written.append(p)

    nl = md.num_lake
    if nl:
        lidx = np.arange(1, nl + 1)
        header = ["index", "zmin", "NumEle", "BathyPoints"]
        npts = np.asarray([np.asarray(md.lake_bathy_y).shape[1]] * nl)
        cols = [lidx, md.lake_zmin, md.lake_num_ele, npts]
        p = os.path.join(outdir, "Debug_Table_Lake.csv")
        _write(p, header, [np.asarray(c) for c in cols])
        written.append(p)

    return written
