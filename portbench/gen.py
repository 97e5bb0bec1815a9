"""The benchmark's input generator: a synthetic SHUD watershed and its
forcing, from a configuration, a traffic mix and a seed.

The watershed is the repository's synthetic hillslope (a grid of quads
split into triangles, sloping toward a river chain along the bottom
boundary), with the sizes and the soil, geology and land-cover rows of
the configuration.  The traffic sets the storm (its rain rate and the
minute it starts) and the replayed period.  The cells are numbered by a
shuffle (the configuration's ``cell_order_seed``, or *order*) and then
Reverse Cuthill-McKee.  Another order is the same watershed, but the
float32 solver's reductions then add in another order, which changes its
steps and work by up to 8%: a run's inputs are the configuration's order,
whatever its seed (``calibrate.py`` reads other orders).

The result is a plain dict of arrays and settings (``make_raw``);
``to_input`` turns it into the input dataclasses of a package, the
program's or the reference's, which have the same fields.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def make_raw(config: dict, traffic: dict, order: "int | None" = None) -> dict:
    """The watershed of *config* under *traffic*, cells in the order that
    *order* (by default the configuration's ``cell_order_seed``) gives."""
    raw = _hillslope(config["nx"], config["ny"], config["spacing_m"], config,
                     traffic)
    ne = raw["tri"].shape[0]
    if order is None:
        order = config["cell_order_seed"]
    perm = np.random.default_rng(order % 2**63).permutation(ne)
    raw = permute(raw, perm)
    return permute(raw, rcm_permutation(raw["tri"]))


def _hillslope(nx: int, ny: int, spacing: float, config: dict,
               traffic: dict) -> dict:
    """A (2*nx*ny)-cell watershed (the repository's
    ``make_synthetic_project``, no lake) with one forcing station of
    daily records: rain at the traffic's rate from its storm minute on,
    for one day."""
    nnx, nny = nx + 1, ny + 1
    xs = np.arange(nnx) * spacing
    ys = np.arange(nny) * spacing
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    z = 200.0 + 0.02 * gy + 0.005 * gx
    z += 2.0 * np.sin(gx / (6.0 * spacing)) * np.cos(gy / (5.0 * spacing))
    aqd = np.full(gx.size, float(config["aquifer_depth_m"]))

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
    nodes = np.stack([np.arange(gx.size) + 1.0, gx.ravel(), gy.ravel(), aqd,
                      z.ravel()], axis=1)

    ne = 2 * nx * ny
    att = np.zeros((ne, 9))
    att[:, 0] = np.arange(ne) + 1
    att[:, 1:6] = 1  # soil, geology, land cover, forcing, melt factor 1

    # the river chain along the bottom row, flowing toward x = 0 (-3: the
    # outlet); each bottom-row cell pairs with the reach under it
    riv = np.zeros((nx, 6))
    riv[:, 0] = np.arange(nx) + 1
    riv[:, 1] = np.arange(nx)
    riv[0, 1] = -3
    riv[:, 2] = 1
    riv[:, 3] = 0.005
    riv[:, 4] = spacing
    rivseg = np.stack([np.arange(nx) + 1.0, np.arange(nx) + 1.0,
                       cid(np.arange(nx), 0, 0).astype(np.float64),
                       np.full(nx, spacing)], axis=1)

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
        forc=dict(num_stations=1, start_yyyymmdd=20000101,
                  lon=np.array([-120.0]), lat=np.array([40.0]),
                  xyz=np.array([[0.0, 0.0, -9999.0]]),
                  filenames=["synthetic"], t_min=[t_min], data=[data]),
        lai_t=np.array([0.0]), lai=np.array([[config["lai"]]]),
        mf_t=np.array([0.0]), mf=np.array([[config["melt_factor"]]]),
        control=control)


def rcm_permutation(tri: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee order of the cell graph: ``perm[new] = old``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    nabr1 = tri[:, 4:7].astype(np.int64)
    ne = len(tri)
    src = np.repeat(np.arange(ne), 3)
    dst = (nabr1 - 1).reshape(-1)
    keep = dst >= 0
    a = coo_matrix((np.ones(int(keep.sum())), (src[keep], dst[keep])),
                   shape=(ne, ne)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True),
                      dtype=np.int64)


def permute(raw: dict, perm: np.ndarray) -> dict:
    """Renumber the cells by *perm* (``perm[new] = old``): triangle rows
    and neighbour ids, attribute rows, the segments' cell ids."""
    ne = raw["tri"].shape[0]
    inv = np.empty(ne, dtype=np.int64)
    inv[perm] = np.arange(ne)
    tri = raw["tri"][perm].copy()
    tri[:, 0] = np.arange(ne) + 1
    ids = tri[:, 4:7].astype(np.int64)
    tri[:, 4:7] = np.where(ids > 0, inv[np.maximum(ids - 1, 0)] + 1, ids)
    att = raw["att"][perm].copy()
    att[:, 0] = np.arange(ne) + 1
    rivseg = raw["rivseg"].copy()
    rivseg[:, 2] = inv[rivseg[:, 2].astype(np.int64) - 1] + 1
    return dict(raw, tri=tri, att=att, rivseg=rivseg)


def to_input(raw: dict, project, where: str):
    """*raw* as a ``ProjectInput`` of the module *project* (the program's
    ``io.project`` or the reference's copy); *where* is the directory its
    paths name (nothing is read or written there)."""
    cs = project.Control()
    for k, v in raw["control"].items():
        if not hasattr(cs, k):
            raise KeyError(f"the control has no setting {k!r}")
        setattr(cs, k, v)
    arrays = {f.name: _copy(raw[f.name]) for f in dataclasses.fields(
        project.ProjectInput) if f.name in raw and f.name not in (
            "control", "forc")}
    return project.ProjectInput(
        paths=project.FilePaths(project="synthetic", inpath=where,
                                outpath=where),
        control=cs, calib=project.Calib(),
        forc=project.ForcingCSV(**{k: _copy(v) for k, v in
                                   raw["forc"].items()}),
        ic=None, lake_bathy=None, **arrays)


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return [_copy(x) for x in v]
    return v
