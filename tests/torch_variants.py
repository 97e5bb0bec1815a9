"""Shared inputs for the port-vs-reference tests (tests/test_torch_*.py).

Each variant is a synthetic watershed built the same way by both packages'
``make_synthetic_project``: plain, with a lake, with open boundaries, with
a shuffled then RCM-localised cell numbering (no structured-mesh shortcut
applies to it), and with a branched river network.  Random states and
forcing are made with numpy from a seed and handed to both packages.  The
module imports neither package at its top, so the GPU tests can use it
without JAX.
"""

import dataclasses

import numpy as np

VARIANTS = ("plain", "lake", "open", "rcm")


def branch_rivers(inp, nx: int):
    """Add a tributary reach joining the chain at reach 5, with three
    segments of its own, one of them on a cell that already has one: a
    confluence, a reach with several segments and a cell with two."""
    riv = np.asarray(inp.riv, np.float64)
    nr = riv.shape[0]
    trib = riv[4].copy()
    trib[0], trib[1] = nr + 1, 5
    inp.riv = np.vstack([riv, trib])
    seg = np.asarray(inp.rivseg, np.float64)
    ns = seg.shape[0]
    # two cells of the second row (upper triangles, 1-based ids) and the
    # bottom-row cell of reach 5
    cells = [2 * (nx + 4) + 2, 2 * (nx + 5) + 2, 2 * 4 + 1]
    extra = np.array([[ns + k + 1, nr + 1, c, 100.0]
                      for k, c in enumerate(cells)])
    inp.rivseg = np.vstack([seg, extra])
    return inp


def make_project(pkg: str, variant: str, nx: int = 12, ny: int = 8,
                 end_day: float = 2.0):
    """The *variant* project from package *pkg* ("jax" or "torch");
    "branched" is the plain one with ``branch_rivers``."""
    if pkg == "jax":
        from shud_tpu.utils import reorder, synthetic
    else:
        from shud_tpu_torch.utils import reorder, synthetic
    inp = synthetic.make_synthetic_project(
        nx, ny, end_day=end_day, with_lake=(variant == "lake"))
    if variant == "branched":
        inp = branch_rivers(inp, nx)
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


def with_bc(md):
    """Head and flux BCs, source terms and river BCs on a mesh
    (tests/test_pallas_mega.py:41-50)."""
    i_bc = np.asarray(md.i_bc).copy()
    i_ss = np.asarray(md.i_ss).copy()
    riv_bc = np.asarray(md.riv_bc).copy()
    i_bc[::31] = 1
    i_bc[5::37] = -1
    i_ss[3::29] = 1
    i_ss[7::41] = -1
    riv_bc[::13] = 1
    riv_bc[1::17] = -1
    return dataclasses.replace(md, i_bc=i_bc, i_ss=i_ss, riv_bc=riv_bc)


def mega_inputs(md, seed: int):
    """(forcing dict, state, tangent) as float32 numpy for the megakernel
    tests: non-unit fu_surf/fu_sub, BC values, and a state with exact ties
    (dry cells, empty unsaturated layers, water tables at the surface,
    empty reaches), as tests/test_pallas_mega.py makes them."""
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(seed)

    def rpos(scale, n=ne):
        return np.abs(rng.normal(0.0, scale, n))

    fs = dict(
        net_prcp=rpos(2e-5), prcp=rpos(2e-5), pot_evap=rpos(5e-6),
        pot_tran=rpos(5e-6), e_ic=rpos(2e-6), lai=rpos(2.0),
        fu_surf=rng.uniform(0.3, 1.0, ne), fu_sub=rng.uniform(0.3, 1.0, ne),
        ele_ybc=rpos(1.0), ele_qbc=rng.normal(0, 1e-3, ne),
        ele_qss=rng.normal(0, 1e-3, ne), riv_ybc=rpos(0.5, nr),
        riv_qbc=rpos(1e-2, nr))
    sf = np.abs(rng.normal(0.005, 0.01, ne))
    sf[::7] = 0.0
    us = np.abs(rng.normal(0.1, 0.1, ne))
    us[::11] = 0.0
    gw = np.abs(rng.normal(1.5, 1.0, ne))
    gw[::13] = np.asarray(md.aq_depth)[::13] + 0.01
    riv = np.abs(rng.normal(0.3, 0.2, nr))
    riv[::5] = 0.0
    lake = np.abs(rng.normal(5.0, 2.0, nl)) + 1.0
    y = np.concatenate([sf, us, gw, riv, lake]).astype(np.float32)
    fs = {k: v.astype(np.float32) for k, v in fs.items()}
    v = rng.normal(0.0, 1.0, y.shape[0]).astype(np.float32)
    return fs, y, v
