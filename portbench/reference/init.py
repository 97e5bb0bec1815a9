# A frozen copy of shud_tpu_torch/driver/init.py,
# its imports rewritten to this package; otherwise unchanged.
"""Initial conditions (``Model_Data::LoadIC``, MD_initialize.cpp:13-116).

INIT_MODE semantics: 0 = groundwater-relief (gw = aquifer depth), 1 = all
zero, 2 = 30-40% guesses, >=3 = read from ``.cfg.ic`` (the restart format
written by the framework, identical to the reference's).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.mesh import MeshData
from portbench.reference.project import ProjectInput


def initial_buckets(inp: ProjectInput, md: MeshData):
    """Returns (canopy interception yEleIS, snow yEleSnow)."""
    ne = md.num_ele
    mode = inp.control.init_type
    if mode >= 3 and inp.ic is not None:
        return inp.ic["ele"][:, 0].copy(), inp.ic["ele"][:, 1].copy()
    return np.zeros(ne), np.zeros(ne)


def initial_state(inp: ProjectInput, md: MeshData) -> np.ndarray:
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    mode = inp.control.init_type
    if mode >= 3 and inp.ic is not None:
        sf = inp.ic["ele"][:, 2]
        us = inp.ic["ele"][:, 3]
        gw = inp.ic["ele"][:, 4]
        riv = inp.ic["riv"]
        lake = inp.ic["lake"][:nl] if nl else np.zeros(0)
        if nl and len(lake) < nl:
            lake = np.full(nl, 2.0)
    elif mode == 0:
        sf = np.zeros(ne)
        us = np.zeros(ne)
        gw = md.aq_depth.copy()
        riv = np.zeros(nr)
        lake = np.zeros(nl)
    elif mode == 2:
        sf = np.zeros(ne)
        us = 0.3 * md.aq_depth
        gw = 0.4 * md.aq_depth
        riv = 0.2 * md.riv_depth
        if nl and md.lake_bathy_y.shape[1] > 1:
            lake = 0.3 * (md.lake_bathy_y[:nl, 1] - md.lake_bathy_y[:nl, 0])
        else:
            lake = np.zeros(nl)
    else:  # mode 1
        sf = np.zeros(ne)
        us = np.zeros(ne)
        gw = np.zeros(ne)
        riv = np.zeros(nr)
        lake = np.zeros(nl)
    return np.concatenate(
        [np.asarray(sf), np.asarray(us), np.asarray(gw), np.asarray(riv),
         np.asarray(lake)]
    )
