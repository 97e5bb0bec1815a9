# Copied verbatim from shud_tpu/utils/refine.py; only the package imports differ.
"""Uniform 4:1 triangle-mesh refinement of a SHUD project.

The scaling configs in BASELINE.json call for a "synthetic 10M-cell refined
mesh" (SURVEY.md §7.2 step 6: "needs a mesh refiner in the preprocessor").
This module refines a real watershed ``ProjectInput`` in memory: every
triangle is split into four congruent children (edge-midpoint subdivision),
node elevations/aquifer depths are interpolated linearly, per-cell
attributes are inherited, and river reaches keep their 1:1 hillslope
exchange segments (re-anchored to the centre child of the parent cell, with
the exchange length preserved, so the total river--hillslope exchange area
is unchanged).

Unlike the fully synthetic generator (``utils/synthetic.py``) the refined
mesh keeps the real DEM topography, parameter heterogeneity, forcing and
river network of the source watershed — ``refine_project(ccw, 6)`` is a
4.7M-cell North Fork Cache Creek with genuine terrain.

Conventions (match ``io/project.py`` / reference ``MD_readin.cpp:192-236``):
``tri`` rows = [id, n0, n1, n2, nb0, nb1, nb2] (1-based; neighbour 0 =
boundary), edge j is opposite node j; ``nodes`` rows = [id, x, y, AqD,
zmax].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shud_tpu_torch.io.project import ProjectInput


def _refine_once(inp: ProjectInput) -> ProjectInput:
    tri = np.asarray(inp.tri, dtype=np.float64)
    nodes = np.asarray(inp.nodes, dtype=np.float64)
    ne = tri.shape[0]
    nn = nodes.shape[0]

    nidx = tri[:, 1:4].astype(np.int64) - 1  # [Ne,3] 0-based
    # edge j is opposite node j: (n1,n2), (n2,n0), (n0,n1)
    edges = np.stack(
        [nidx[:, [1, 2]], nidx[:, [2, 0]], nidx[:, [0, 1]]], axis=1
    ).reshape(-1, 2)
    es = np.sort(edges, axis=1)
    uniq, inv = np.unique(es, axis=0, return_inverse=True)

    # midpoint nodes: linear interpolation of x, y, AqD, zmax
    mid = np.empty((uniq.shape[0], 5))
    mid[:, 0] = nn + 1 + np.arange(uniq.shape[0])  # 1-based id
    mid[:, 1:5] = 0.5 * (nodes[uniq[:, 0], 1:5] + nodes[uniq[:, 1], 1:5])
    new_nodes = np.vstack([nodes, mid])
    new_nodes[:, 0] = np.arange(new_nodes.shape[0]) + 1

    m = (nn + inv).reshape(ne, 3)  # [Ne,3] 0-based midpoint of edge j
    m12, m20, m01 = m[:, 0], m[:, 1], m[:, 2]
    n0, n1, n2 = nidx[:, 0], nidx[:, 1], nidx[:, 2]

    # children per parent (same orientation as the parent):
    #   c0 corner n0, c1 corner n1, c2 corner n2, c3 centre
    ct = np.empty((ne, 4, 3), dtype=np.int64)
    ct[:, 0] = np.stack([n0, m01, m20], axis=1)
    ct[:, 1] = np.stack([n1, m12, m01], axis=1)
    ct[:, 2] = np.stack([n2, m20, m12], axis=1)
    ct[:, 3] = np.stack([m01, m12, m20], axis=1)
    ct = ct.reshape(4 * ne, 3)

    # rebuild neighbours from shared child edges (conforming by
    # construction; every internal edge appears exactly twice)
    ce = np.stack(
        [ct[:, [1, 2]], ct[:, [2, 0]], ct[:, [0, 1]]], axis=1
    ).reshape(-1, 2)
    cs = np.sort(ce, axis=1)
    order = np.lexsort((cs[:, 1], cs[:, 0]))
    s = cs[order]
    same = (s[1:] == s[:-1]).all(axis=1)
    if same.size >= 2 and np.any(same[1:] & same[:-1]):
        raise ValueError("non-conforming mesh: an edge is shared 3+ times")
    nabr_flat = np.zeros(cs.shape[0], dtype=np.int64)  # 1-based; 0=boundary
    pi = np.where(same)[0]
    a, b = order[pi], order[pi + 1]
    nabr_flat[a] = b // 3 + 1
    nabr_flat[b] = a // 3 + 1
    nabr = nabr_flat.reshape(4 * ne, 3)

    new_tri = np.empty((4 * ne, tri.shape[1]))
    new_tri[:, 0] = np.arange(4 * ne) + 1
    new_tri[:, 1:4] = ct + 1
    new_tri[:, 4:7] = nabr
    if tri.shape[1] > 7:  # trailing columns (zmax echo etc.): inherit
        new_tri[:, 7:] = np.repeat(tri[:, 7:], 4, axis=0)

    att = np.repeat(np.asarray(inp.att, dtype=np.float64), 4, axis=0)
    att[:, 0] = np.arange(att.shape[0]) + 1

    # river segments: parent cell -> its centre child (length preserved)
    rivseg = np.asarray(inp.rivseg, dtype=np.float64).copy()
    rivseg[:, 2] = (rivseg[:, 2].astype(np.int64) - 1) * 4 + 4

    ic = inp.ic
    if ic is not None:
        ic = dict(ic)
        ic["ele"] = np.repeat(np.asarray(ic["ele"]), 4, axis=0)

    return dataclasses.replace(
        inp, tri=new_tri, nodes=new_nodes, att=att, rivseg=rivseg, ic=ic
    )


def refine_project(inp: ProjectInput, levels: int = 1) -> ProjectInput:
    """Return a new ``ProjectInput`` with every triangle split 4**levels
    ways.  Rivers, parameter tables, forcing and control are shared with
    the source project (cells inherit their parent's attributes)."""
    if levels < 0:
        raise ValueError("levels must be >= 0")
    for _ in range(levels):
        inp = _refine_once(inp)
    return inp
