# Copied verbatim from shud_tpu/utils/reorder.py; only the package imports differ.
"""Cell-numbering locality tools.

The Pallas edge kernel (``shud_tpu.core.pallas_edge``) and, more generally,
any banded/blocked access pattern require the mesh's graph bandwidth
(max |neighbour_id - cell_id|) to be small.  SHUD input meshes carry whatever
numbering the mesh generator produced; these helpers renumber cells with
Reverse Cuthill–McKee (the classic bandwidth-minimising BFS ordering) at the
``ProjectInput`` level, so the whole downstream pipeline (build_mesh, golden
comparisons, outputs) sees a consistent renumbered watershed.

The reference has no analogue (its per-cell loops are index-order agnostic);
this is TPU-design territory: locality of the cell axis is what turns the
neighbour gather into sequential HBM traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def rcm_permutation(nabr: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the cell graph.

    *nabr* is the [Ne,3] 0-based adjacency (-1 = none).  Returns ``perm``
    with ``perm[new_id] = old_id``.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ne = nabr.shape[0]
    src = np.repeat(np.arange(ne), 3)
    dst = nabr.reshape(-1)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    a = coo_matrix((np.ones(len(src)), (src, dst)), shape=(ne, ne)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    return perm.astype(np.int64)


def permute_project(inp, perm: np.ndarray):
    """Renumber cells of a ``ProjectInput`` by *perm* (perm[new]=old).

    Remaps: mesh triangle rows + neighbour ids, attribute rows, river-segment
    element ids, and (if present) the element block of the initial condition.
    Node numbering, rivers, forcing and parameters are untouched.
    """
    ne = inp.tri.shape[0]
    assert perm.shape == (ne,)
    inv = np.empty(ne, dtype=np.int64)
    inv[perm] = np.arange(ne)  # inv[old] = new

    tri = inp.tri[perm].copy()
    tri[:, 0] = np.arange(ne) + 1
    for c in (4, 5, 6):  # neighbour columns, 1-based, <=0 = boundary code
        ids = tri[:, c].astype(np.int64)
        tri[:, c] = np.where(ids > 0, inv[np.maximum(ids - 1, 0)] + 1, ids)

    att = inp.att[perm].copy()
    att[:, 0] = np.arange(ne) + 1

    rivseg = inp.rivseg.copy()
    ids = rivseg[:, 2].astype(np.int64)
    rivseg[:, 2] = inv[ids - 1] + 1

    ic = inp.ic
    if ic is not None:
        ic = dict(ic)
        ic["ele"] = np.asarray(ic["ele"])[perm]

    return dataclasses.replace(inp, tri=tri, att=att, rivseg=rivseg, ic=ic)


def localize_project(inp):
    """Convenience: RCM-renumber a project for banded/blocked execution.

    Returns ``(renumbered_project, perm)`` where ``perm[new]=old`` (use it to
    map outputs back to the original numbering).
    """
    nabr1 = inp.tri[:, 4:7].astype(np.int64)
    nabr = np.where(nabr1 > 0, nabr1 - 1, -1)
    perm = rcm_permutation(nabr)
    return permute_project(inp, perm), perm
