"""A basin around a lake, laid out as SHUD-up's ``qhh`` example
is: a grid of quads split into triangles, the lake carved out as a compact
group of cells, and trees of reaches on the land cells that end at the
shore as outlets (SHUD's ``down`` = -3: the river leaves the model there;
no reach is routed into the lake), so the lake takes its water through
its bank edges and its own precipitation.

The configuration gives the mesh (``nx``, ``ny``, ``spacing_m``,
``aquifer_depth_m``), the share of lake cells and of reaches a cell
(``lake_cell_share``, ``reach_share``), the outlets a bank edge
(``outlets_per_bank_edge``), and each lake (``lakes``: its share of the
lake cells, centre as a fraction of the grid, aspect, depth, surface
level and bathymetry).  Everything is vectorised: the lakes are the cells
nearest their centres, the drainage follows the fewest cell steps to a
lake (ties to the lowest neighbour), the outlets are the shore cells that
drain the most cells, the reaches the cells of largest drained area that
drain to them, each with two segments (its cell and the cell it flows
into, the part inside a lake left out).  The forcing is the hillslope's:
one station, the traffic's storm.
"""

from __future__ import annotations

import math
import sys

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import shortest_path
from scipy.spatial import cKDTree


def make(config: dict, traffic: dict) -> dict:
    """The basin of *config* under *traffic*, cells in the generator's own
    order."""
    nx, ny, s = config["nx"], config["ny"], float(config["spacing_m"])
    tri, nodes_xy = _triangles(nx, ny)
    ne = len(tri)
    nb = tri[:, 4:7].astype(np.int64) - 1
    cx, cy = _centroids(nx, ny)

    lake_of = _carve_lakes(config, cx, cy, nx, ny, ne)
    z = _node_elevations(config, nodes_xy, cx, cy, lake_of, s)
    corners = tri[:, 1:4].astype(np.int64) - 1
    for k, lk in enumerate(config["lakes"]):
        z[corners[lake_of == k]] = lk["level_m"]  # a lake's floor is flat
    z_cell = z[corners].mean(axis=1)
    down = _drainage(nb, lake_of, z_cell)
    riv, rivseg = _reaches(config, nb, down, lake_of, cx, cy, z_cell, s)

    att = np.zeros((ne, 9))
    att[:, 0] = np.arange(ne) + 1
    att[:, 1:6] = 1  # soil, geology, land cover, forcing, melt factor 1
    att[:, 8] = lake_of + 1  # 0: land, k: lake k
    aqd = np.full(len(z), float(config["aquifer_depth_m"]))
    nodes = np.stack([np.arange(len(z)) + 1.0, nodes_xy[:, 0] * s,
                      nodes_xy[:, 1] * s, aqd, z], axis=1)
    bathy = _bathymetry(config, lake_of, s)
    _report(ne, nb, lake_of, riv, rivseg)

    control = dict(config["control"])
    control.update(day_start=traffic["start_min"] / 1440.0,
                   day_end=traffic["end_min"] / 1440.0)
    return dict(
        tri=tri, nodes=nodes, att=att, riv=riv,
        rivtype=np.asarray(config["rivtype"], dtype=np.float64),
        rivseg=rivseg,
        soil=np.asarray(config["soil"], dtype=np.float64),
        geol=np.asarray(config["geol"], dtype=np.float64),
        lc=np.asarray(config["lc"], dtype=np.float64),
        forc=_forcing(traffic),
        lai_t=np.array([0.0]), lai=np.array([[config["lai"]]]),
        mf_t=np.array([0.0]), mf=np.array([[config["melt_factor"]]]),
        control=control, lake_bathy=bathy)


def _triangles(nx: int, ny: int):
    """The hillslope's triangulation: two cells a quad (lower, upper), rows
    ``[id, n1, n2, n3, nb1, nb2, nb3, 0]`` (1-based, 0: boundary), and
    the nodes' grid coordinates."""
    nnx = nx + 1
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    iy, ix = iy.ravel(), ix.ravel()

    def nid(x, y):
        return y * nnx + x + 1

    def cid(x, y, u):
        return (y * nx + x) * 2 + u + 1

    lower = np.stack([
        cid(ix, iy, 0), nid(ix, iy), nid(ix + 1, iy), nid(ix + 1, iy + 1),
        np.where(ix + 1 < nx, cid(ix + 1, iy, 1), 0), cid(ix, iy, 1),
        np.where(iy - 1 >= 0, cid(ix, iy - 1, 1), 0)], axis=1)
    upper = np.stack([
        cid(ix, iy, 1), nid(ix, iy), nid(ix + 1, iy + 1), nid(ix, iy + 1),
        np.where(iy + 1 < ny, cid(ix, iy + 1, 0), 0),
        np.where(ix - 1 >= 0, cid(ix - 1, iy, 0), 0), cid(ix, iy, 0)],
        axis=1)
    tri = np.stack([lower, upper], axis=1).reshape(-1, 7).astype(np.float64)
    tri = np.concatenate([tri, np.zeros((len(tri), 1))], axis=1)
    gy, gx = np.meshgrid(np.arange(ny + 1), np.arange(nnx), indexing="ij")
    return tri, np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)


def _centroids(nx: int, ny: int):
    """Each cell's centroid in grid units (lower: 2/3, 1/3 into its quad;
    upper: 1/3, 2/3)."""
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    x = np.stack([ix + 2.0 / 3.0, ix + 1.0 / 3.0], axis=-1).ravel()
    y = np.stack([iy + 1.0 / 3.0, iy + 2.0 / 3.0], axis=-1).ravel()
    return x, y


def _carve_lakes(config, cx, cy, nx, ny, ne) -> np.ndarray:
    """Each cell's lake (0-based; -1 on land): lake k takes the cells
    nearest its centre (in its aspect's metric) that no lake before it
    took, as many as its share of ``lake_cell_share`` of the cells."""
    n_lake = int(round(ne * config["lake_cell_share"]))
    lakes = config["lakes"]
    counts = [int(round(n_lake * lk["share"])) for lk in lakes[:-1]]
    counts.append(n_lake - sum(counts))
    lake_of = np.full(ne, -1, dtype=np.int64)
    for k, (lk, n) in enumerate(zip(lakes, counts)):
        a = math.sqrt(lk["aspect"])
        d = (((cx - lk["centre"][0] * nx) / a) ** 2
             + ((cy - lk["centre"][1] * ny) * a) ** 2)
        d[lake_of >= 0] = np.inf
        lake_of[np.argsort(d, kind="stable")[:n]] = k
    return lake_of


def _node_elevations(config, nodes_xy, cx, cy, lake_of, s) -> np.ndarray:
    """Node elevations [m]: the land rising from the nearest lake at
    ``grade`` above the lake's ``level_m`` (the lowest of the lakes'
    planes), with a smooth ripple of ``ripple_m`` that vanishes at the
    shore."""
    lakes = config["lakes"]
    grade, ripple = config["grade"], config["ripple_m"]
    x, y = nodes_xy[:, 0], nodes_xy[:, 1]
    z = np.full(len(x), np.inf)
    dist = np.full(len(x), np.inf)
    for k, lk in enumerate(lakes):
        pts = np.stack([cx[lake_of == k], cy[lake_of == k]], axis=1)
        d, _ = cKDTree(pts).query(nodes_xy)
        z = np.minimum(z, lk["level_m"] + grade * s * d)
        dist = np.minimum(dist, d)
    z += ripple * (1.0 - np.exp(-dist / 3.0)) * np.sin(x / 6.0) * np.cos(
        y / 5.0)
    return z


def _drainage(nb, lake_of, z_cell) -> np.ndarray:
    """Each land cell's downstream cell: the neighbour one step closer to
    a lake (in cell steps), the lowest of them; -1 for lake cells."""
    ne = len(nb)
    src = np.repeat(np.arange(ne), 3)
    dst = nb.ravel()
    keep = dst >= 0
    lakes = np.flatnonzero(lake_of >= 0)
    rows = np.concatenate([src[keep], np.full(len(lakes), ne)])
    cols = np.concatenate([dst[keep], lakes])
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(ne + 1, ne + 1))
    hops = shortest_path(g.tocsr(), directed=False, unweighted=True,
                         indices=ne)[:ne] - 1.0
    if not np.isfinite(hops).all():
        raise ValueError("a cell reaches no lake")
    hops = hops.astype(np.int64)
    nbs = np.where(nb >= 0, nb, 0)
    closer = (nb >= 0) & (hops[nbs] == hops[:, None] - 1)
    zc = np.where(closer, z_cell[nbs], np.inf)
    down = nbs[np.arange(ne), np.argmin(zc, axis=1)]
    return np.where(lake_of >= 0, -1, down)


def _reaches(config, nb, down, lake_of, cx, cy, z_cell, s):
    """The river network: ``outlets_per_bank_edge`` of the lakes' bank
    edges in outlets, the shore cells that drain the most cells, each a
    reach; then the rest of the ``reach_share`` of the cells, those that
    drain the most cells among those that drain to these outlets (a set
    closed downstream, since a cell drains strictly more than any cell
    upstream of it), one reach each,
    numbered in cell order.  Returns the ``riv`` rows ``[id, down, type,
    slope, length, bc]`` and the ``rivseg`` rows ``[id, reach, cell,
    length]``."""
    ne = len(down)
    land = lake_of < 0
    acc = land.astype(np.int64)
    hops = _hops_to_lake(down, lake_of)
    for h in range(int(hops.max()), 0, -1):
        c = np.flatnonzero(hops == h)  # the farthest first
        np.add.at(acc, down[c], acc[c])
    root = np.arange(ne)
    for h in range(2, int(hops.max()) + 1):
        c = np.flatnonzero(hops == h)  # the nearest first
        root[c] = root[down[c]]
    bank = int(np.sum((nb >= 0) & land[:, None]
                      & (lake_of[np.maximum(nb, 0)] >= 0)))
    n_out = int(round(bank * config["outlets_per_bank_edge"]))
    shore = np.flatnonzero(hops == 1)
    outlets = shore[np.argsort(-acc[shore], kind="stable")[:n_out]]
    n_riv = int(round(ne * config["reach_share"]))
    eligible = land & np.isin(root, outlets)
    if int(eligible.sum()) < n_riv:
        raise ValueError("the outlets drain fewer cells than reaches")
    eligible[outlets] = False  # each outlet a reach, however small
    ranked = np.argsort(-np.where(eligible, acc, -1), kind="stable")
    cells = np.sort(np.concatenate([outlets, ranked[:n_riv - n_out]]))
    riv_of = np.zeros(ne, dtype=np.int64)
    riv_of[cells] = np.arange(n_riv) + 1
    d = down[cells]
    at_shore = lake_of[d] >= 0
    if not (at_shore | (riv_of[d] > 0)).all():
        raise ValueError("a reach flows into a cell without a reach")
    length = np.hypot(cx[cells] - cx[d], cy[cells] - cy[d]) * s
    slope = np.maximum(z_cell[cells] - z_cell[d], 0.0) / length
    riv = np.zeros((n_riv, 6))
    riv[:, 0] = np.arange(n_riv) + 1
    riv[:, 1] = np.where(at_shore, -3, riv_of[d])
    riv[:, 2] = 1
    riv[:, 3] = slope
    riv[:, 4] = length
    # two segments a reach, half its length each: its own cell, and the
    # cell it flows into unless that cell is in a lake
    ids = np.arange(n_riv) + 1
    seg_riv = np.concatenate([ids, ids[~at_shore]])
    seg_cell = np.concatenate([cells, d[~at_shore]])
    seg_len = np.concatenate([length, length[~at_shore]]) * 0.5
    order = np.lexsort((seg_cell, seg_riv))
    rivseg = np.stack([np.arange(len(order)) + 1.0, seg_riv[order],
                       seg_cell[order] + 1.0, seg_len[order]], axis=1)
    return riv, rivseg.astype(np.float64)


def _hops_to_lake(down, lake_of) -> np.ndarray:
    """Cell steps from each cell to its lake along ``down`` (0 in a
    lake)."""
    hops = np.zeros(len(down), dtype=np.int64)
    live = np.flatnonzero(lake_of < 0)
    at = live.copy()
    while len(live):
        hops[live] += 1
        at = down[at]
        keep = lake_of[at] < 0
        live, at = live[keep], at[keep]
    return hops


def _bathymetry(config, lake_of, s) -> list:
    """Each lake's stage -> area table ``[row, stage, area]`` (absolute
    elevation; Lake.cpp:59-78): the stage from the lake's bottom (its
    level less its depth) at ``bathy_stage`` of the depth, the area at
    ``bathy_area`` of its cells' footprint."""
    out = []
    cell_area = 0.5 * s * s
    fs = np.asarray(config["bathy_stage"], dtype=np.float64)
    fa = np.asarray(config["bathy_area"], dtype=np.float64)
    for k, lk in enumerate(config["lakes"]):
        footprint = cell_area * float(np.sum(lake_of == k))
        bottom = lk["level_m"] - lk["depth_m"]
        out.append(np.stack([np.arange(len(fs)) + 1.0,
                             bottom + lk["depth_m"] * fs,
                             footprint * fa], axis=1))
    return out


def _forcing(traffic: dict) -> dict:
    """The hillslope's one station of daily records: rain at the
    traffic's rate from its storm minute on, for one day."""
    days = int(math.ceil(traffic["end_min"] / 1440.0)) + 3
    t_days = np.arange(days, dtype=np.float64)
    data = np.zeros((days, 5))
    data[1, 0] = traffic["storm_mm_day"]  # the record of day 1: the storm
    data[:, 1] = 15.0 + 5.0 * np.sin(t_days / 5.0)
    data[:, 2] = 0.6
    data[:, 3] = 2.0
    data[:, 4] = 200.0
    # shift the records so that day 1's starts at the storm's minute
    t_min = t_days * 1440.0 - (1440.0 - traffic["storm_start_min"])
    return dict(num_stations=1, start_yyyymmdd=20000101,
                lon=np.array([-120.0]), lat=np.array([40.0]),
                xyz=np.array([[0.0, 0.0, -9999.0]]),
                filenames=["synthetic"], t_min=[t_min], data=[data])


def _report(ne, nb, lake_of, riv, rivseg) -> None:
    """One line on stderr: the basin's sizes."""
    counts = np.bincount(lake_of[lake_of >= 0])
    bank = int(np.sum((nb >= 0) & (lake_of[:, None] < 0)
                      & (lake_of[np.maximum(nb, 0)] >= 0)))
    down = riv[:, 1].astype(np.int64)
    up = np.bincount(down[down > 0], minlength=len(riv) + 1)[1:]
    per_cell = np.bincount(rivseg[:, 2].astype(np.int64))
    print(f"lakebasin: {ne} cells, {len(counts)} lake(s) of "
          f"{'/'.join(str(int(c)) for c in counts)} cells "
          f"({int(counts.sum())}, {100.0 * counts.sum() / ne:.2f}%), "
          f"{bank} bank edges, {len(riv)} reaches ({len(riv) / ne:.4f} a "
          f"cell, {int(np.sum(down == -3))} outlets, "
          f"{int(np.sum(down <= -4))} into a lake, {int(np.sum(up == 2))} "
          f"with two upstream, {int(np.sum(up == 0))} heads), "
          f"{len(rivseg)} segments; widest lists: upstream "
          f"{int(up.max()) if len(up) else 0}, segments a cell "
          f"{int(per_cell.max())}", file=sys.stderr)
