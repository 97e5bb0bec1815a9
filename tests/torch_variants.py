"""Shared inputs for the port-vs-reference tests (tests/test_torch_*.py).

Each variant is a synthetic watershed built the same way by both packages'
``make_synthetic_project``: plain, with a lake, with open boundaries, and
with a shuffled then RCM-localised cell numbering (no structured-mesh
shortcut applies to it).  Random states and forcing are made with numpy
from a seed and handed to both packages.
"""

import numpy as np

VARIANTS = ("plain", "lake", "open", "rcm")


def make_project(pkg: str, variant: str, nx: int = 12, ny: int = 8,
                 end_day: float = 2.0):
    """The *variant* project from package *pkg* ("jax" or "torch")."""
    if pkg == "jax":
        from shud_tpu.utils import reorder, synthetic
    else:
        from shud_tpu_torch.utils import reorder, synthetic
    inp = synthetic.make_synthetic_project(
        nx, ny, end_day=end_day, with_lake=(variant == "lake"))
    if variant == "open":
        inp.control.close_boundary = 0
    if variant == "rcm":
        ne = inp.tri.shape[0]
        perm = np.random.default_rng(7).permutation(ne)
        inp, _ = reorder.localize_project(reorder.permute_project(inp, perm))
    return inp


def meshes(variant: str, nx: int = 12, ny: int = 8):
    """(jax MeshData, torch MeshData, close_boundary) for *variant*."""
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu_torch.core.mesh import build_mesh as torch_build

    jinp = make_project("jax", variant, nx, ny)
    tinp = make_project("torch", variant, nx, ny)
    return (jax_build(jinp), torch_build(tinp),
            bool(jinp.control.close_boundary))


def random_inputs(md, seed: int = 0, dry_every: int = 0):
    """(forcing-slice dict, state) as float64 numpy arrays.  States stay off
    the tie points of the flux laws unless *dry_every* > 0, which sets every
    dry_every-th surface depth to exactly 0."""
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(seed)
    fs = dict(
        net_prcp=rng.uniform(0, 2e-5, ne), prcp=rng.uniform(0, 2e-5, ne),
        pot_evap=rng.uniform(0, 1e-6, ne), pot_tran=rng.uniform(0, 1e-6, ne),
        e_ic=rng.uniform(0, 1e-7, ne), lai=np.full(ne, 2.0),
        fu_surf=np.ones(ne), fu_sub=np.ones(ne), ele_ybc=np.zeros(ne),
        ele_qbc=np.zeros(ne), ele_qss=np.zeros(ne), riv_ybc=np.zeros(nr),
        riv_qbc=np.zeros(nr),
    )
    sf = rng.uniform(1e-4, 0.05, ne)
    if dry_every:
        sf[::dry_every] = 0.0
    y = np.concatenate([sf, rng.uniform(0.05, 1.0, ne),
                        rng.uniform(0.05, 8.0, ne), rng.uniform(0.05, 1.0, nr),
                        rng.uniform(0.5, 2.0, nl)])
    return fs, y


def scaled_err(a, b) -> float:
    """max |a - b| / max |a| (0 for empty arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    scale = float(np.abs(a).max()) or 1.0
    return float(np.abs(a - b).max()) / scale
