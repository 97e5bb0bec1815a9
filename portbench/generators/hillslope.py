"""The repository's synthetic hillslope: a grid of quads split into
triangles, sloping toward a river chain along the bottom boundary, with
the sizes and the soil, geology and land-cover rows of the configuration
and one forcing station.  The traffic sets the storm (its rain rate and
the minute it starts) and the replayed period.  The default generator of
a configuration that names none (``gen.make_raw``)."""

from __future__ import annotations

import math

import numpy as np


def make(config: dict, traffic: dict) -> dict:
    """The watershed of *config* under *traffic*, cells in the generator's
    own order."""
    return _hillslope(config["nx"], config["ny"], config["spacing_m"], config,
                      traffic)


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
