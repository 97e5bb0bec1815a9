# Copied verbatim from shud_tpu/utils/synthetic.py; only the package imports differ.
"""Synthetic watershed generator.

Produces a fully in-memory ``ProjectInput`` (structured triangulated hill
slope with a river chain along the valley) at any resolution — used for the
multi-chip dry-run, weak-scaling benchmarks (BASELINE.json's synthetic
10M-cell configuration) and self-contained tests with no file dependencies.
"""

from __future__ import annotations

import numpy as np

from shud_tpu_torch.io.project import Calib, Control, ForcingCSV, ProjectInput


def make_synthetic_project(
    nx: int = 16,
    ny: int = 8,
    spacing: float = 100.0,
    end_day: float = 2.0,
    seed: int = 0,
    with_lake: bool = False,
    storm_mm_day: float = 20.0,
) -> ProjectInput:
    """A (2*nx*ny)-cell watershed: grid of quads split into triangles,
    sloping toward a river chain along the bottom boundary.

    ``with_lake``: carve a lake (bathymetry + iLake cells + a lake-bound
    reach, MD_Lake.cpp:32-146 semantics) out of the bottom-left corner —
    the river chain then terminates in the lake (down = -4) instead of the
    -3 outlet, so every entity class of the lake driver branches
    (shud.cpp:171-357) exists in the synthetic watershed."""
    rng = np.random.default_rng(seed)
    # lake footprint (quads [0,lx) x [0,ly)); 0 = no lake
    lx = max(2, nx // 4) if with_lake else 0
    ly = max(2, ny // 4) if with_lake else 0
    nnx, nny = nx + 1, ny + 1
    xs = np.arange(nnx) * spacing
    ys = np.arange(nny) * spacing
    gx, gy = np.meshgrid(xs, ys, indexing="xy")  # [nny, nnx]
    # hillslope toward y=0 and gently toward x=0, plus smooth noise
    z = 200.0 + 0.02 * gy + 0.005 * gx
    z += 2.0 * np.sin(gx / (6.0 * spacing)) * np.cos(gy / (5.0 * spacing))
    aqd = np.full(gx.size, 10.0)

    def nid(ix, iy):
        return iy * nnx + ix + 1  # 1-based

    tris = []
    # cell ids: 2 per quad: lower (ix,iy,0), upper (ix,iy,1)
    def cid(ix, iy, u):
        return (iy * nx + ix) * 2 + u + 1

    for iy in range(ny):
        for ix in range(nx):
            # lower triangle: (ix,iy), (ix+1,iy), (ix+1,iy+1)
            n0, n1, n2 = nid(ix, iy), nid(ix + 1, iy), nid(ix + 1, iy + 1)
            # neighbours: edge0 (n1-n2): right quad upper tri or boundary;
            # edge1 (n2-n0): own upper; edge2 (n0-n1): below quad upper
            e0 = cid(ix + 1, iy, 1) if ix + 1 < nx else 0
            e1 = cid(ix, iy, 1)
            e2 = cid(ix, iy - 1, 1) if iy - 1 >= 0 else 0
            tris.append([cid(ix, iy, 0), n0, n1, n2, e0, e1, e2])
            # upper triangle: (ix,iy), (ix+1,iy+1), (ix,iy+1)
            m0, m1, m2 = nid(ix, iy), nid(ix + 1, iy + 1), nid(ix, iy + 1)
            f0 = cid(ix, iy + 1, 0) if iy + 1 < ny else 0
            f1 = cid(ix - 1, iy, 0) if ix - 1 >= 0 else 0
            f2 = cid(ix, iy, 0)
            tris.append([cid(ix, iy, 1), m0, m1, m2, f0, f1, f2])
    tri = np.asarray(tris, dtype=np.float64)
    tri = np.concatenate([tri, np.zeros((len(tri), 1))], axis=1)  # 8 cols

    nodes = np.stack(
        [
            np.arange(gx.size) + 1.0,
            gx.ravel(), gy.ravel(), aqd, z.ravel(),
        ],
        axis=1,
    )

    ne = 2 * nx * ny
    att = np.zeros((ne, 9))
    att[:, 0] = np.arange(ne) + 1
    att[:, 1:6] = 1  # soil/geol/lc/forc/mf = 1
    # iBC=0, iSS=0; iLake below
    lake_bathy = None
    if with_lake:
        for iy in range(ly):
            for ix in range(lx):
                att[cid(ix, iy, 0) - 1, 8] = 1
                att[cid(ix, iy, 1) - 1, 8] = 1
        # bathymetry: stage grid from 2 m below the lowest lake-cell
        # surface, areas growing to the full footprint (piecewise-linear
        # stage->area table, Lake.cpp:59-78)
        z_lake_min = float(z[: ly + 1, : lx + 1].min()) - 2.0
        full_area = lx * ly * spacing * spacing
        stages = z_lake_min + np.array([0.0, 1.0, 2.0, 3.5, 5.0])
        areas = full_area * np.array([0.2, 0.55, 0.9, 1.0, 1.05])
        lake_bathy = [np.stack(
            [np.arange(len(stages), dtype=float) + 1, stages, areas], axis=1
        )]

    # river chain along the bottom row (right of the lake), flowing toward
    # x=0; most-downstream reach: -3 outlet, or -4 = into lake 1
    nriv = nx - lx
    riv = np.zeros((nriv, 6))
    riv[:, 0] = np.arange(nriv) + 1
    for i in range(nriv):
        riv[i, 1] = i if i >= 1 else (-4 if with_lake else -3)
    riv[:, 2] = 1  # type
    riv[:, 3] = 0.005  # bed slope
    riv[:, 4] = spacing  # length
    riv[:, 5] = 0  # BC
    rivtype = np.array(
        [[1, 2.0, 1.0, 4.0, 1.0, 0.04, 0.6, 0.5, 0.2]]
    )  # depth, bankslope, width, sinu, rough(s), cwr, ksath(m/d), bedthick

    # segments: each bottom-row cell (right of the lake) pairs with the
    # reach under it
    segs = []
    for ix in range(lx, nx):
        segs.append([len(segs) + 1, ix - lx + 1, cid(ix, 0, 0), spacing])
    rivseg = np.asarray(segs, dtype=np.float64)

    soil = np.array([[1, 0.5, 0.45, 0.05, 0.1, 2.0, 1.3, 0.01, 10.0]])
    geol = np.array([[1, 1.0, 0.1, 0.41, 0.01, 0.01, 50.0, 1.0]])
    lc = np.array([[1, 0.2, 0.5, 0.1, 0.5, 0.0, 0.0]])

    # forcing: one station, daily records with a rain pulse
    ndays = int(end_day) + 3
    t_days = np.arange(ndays, dtype=np.float64)
    data = np.zeros((ndays, 5))
    data[:, 0] = np.where((t_days >= 0.5) & (t_days < 1.5),
                          storm_mm_day, 0.0)  # mm/d
    data[:, 1] = 15.0 + 5.0 * np.sin(t_days / 5.0)  # temp C
    data[:, 2] = 0.6  # rh
    data[:, 3] = 2.0  # wind
    data[:, 4] = 200.0  # sw W/m2
    forc = ForcingCSV(
        num_stations=1, start_yyyymmdd=20000101,
        lon=np.array([-120.0]), lat=np.array([40.0]),
        xyz=np.array([[0.0, 0.0, -9999.0]]), filenames=["synthetic"],
        t_min=[t_days * 1440.0], data=[data],
    )

    cs = Control()
    cs.day_start = 0.0
    cs.day_end = end_day
    cs.init_type = 2
    cs.max_step = 10.0
    cs.et_step = 60.0
    cs.abstol = 1e-4
    cs.reltol = 1e-4
    cs.terrain_radiation = 1

    from shud_tpu_torch.io.project import FilePaths

    return ProjectInput(
        paths=FilePaths(project="synthetic", inpath="/tmp", outpath="/tmp"),
        control=cs, calib=Calib(),
        tri=tri, nodes=nodes, att=att, riv=riv, rivtype=rivtype,
        rivseg=rivseg, soil=soil, geol=geol, lc=lc, forc=forc,
        lai_t=np.array([0.0]), lai=np.array([[2.0]]),
        mf_t=np.array([0.0]), mf=np.array([[0.0018]]),
        ic=None, lake_bathy=lake_bathy,
    )
