"""The benchmark's input generator: a SHUD watershed and its forcing, from
a configuration, a traffic mix and a seed.

The watershed comes from the configuration's generator
(``generators/<name>.py``, named by its ``generator`` key; by default
``generators/hillslope.py``, the repository's synthetic hillslope), whose
``make(config, traffic)`` returns it as a plain dict of arrays and
settings.  The cells are then numbered by a shuffle (the configuration's
``cell_order_seed``, or *order*) and Reverse Cuthill-McKee, whatever the
generator.  Another order is the same watershed, but the float32
solver's reductions then add in another order, which changes its steps
and work by up to 8%: a run's inputs are the configuration's order,
whatever its seed (``calibrate.py`` reads other orders).

``to_input`` turns the result (``make_raw``) into the input dataclasses
of a package, the program's or the reference's, which have the same
fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_raw(config: dict, traffic: dict, order: "int | None" = None,
             generator=None) -> dict:
    """The watershed of *config* under *traffic*, cells in the order that
    *order* (by default the configuration's ``cell_order_seed``) gives.
    *generator*: the module whose ``make`` builds it (by default the one
    that *config* names in this directory, ``harness.hooks``)."""
    if generator is None:
        from portbench import harness

        generator = harness.hooks(harness.OWN, config).generator
    raw = generator.make(config, traffic)
    ne = raw["tri"].shape[0]
    if order is None:
        order = config["cell_order_seed"]
    perm = np.random.default_rng(order % 2**63).permutation(ne)
    raw = permute(raw, perm)
    return permute(raw, rcm_permutation(raw["tri"]))


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
    paths name (nothing is read or written there).  The initial
    conditions ``ic``, the lakes' ``lake_bathy`` and the boundary
    conditions ``bc`` are *raw*'s where it has them, else none."""
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
        **{"ic": None, "lake_bathy": None, **arrays})


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return [_copy(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v
