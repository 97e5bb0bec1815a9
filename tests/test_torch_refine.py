"""The port's mesh refiner (utils/refine.py) against the JAX package's.

``refine_project`` on a synthetic project with and without a lake, 1 and 2
levels: every array equal to JAX's.  The counts, conservation and
conforming-neighbour checks of tests/test_refine.py on the synthetic
input, and the port's f64 RHS on the refined mesh within 1e-12 (scaled)
of JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.utils.refine import refine_project as jax_refine  # noqa: E402
from shud_tpu_torch.core.mesh import build_mesh  # noqa: E402
from shud_tpu_torch.utils.refine import refine_project  # noqa: E402
from torch_variants import make_project, random_inputs, scaled_err  # noqa

VARIANTS = ("plain", "lake")


def _arrays(inp):
    """Every array of a ProjectInput, by field path."""
    out = {}
    for f in dataclasses.fields(inp):
        v = getattr(inp, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
        elif isinstance(v, dict):
            out.update({f"{f.name}/{k}": np.asarray(a) for k, a in v.items()})
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            out.update({f"{f.name}/{i}": a for i, a in enumerate(v)})
    for k in ("t_min", "data"):
        out.update({f"forc.{k}/{i}": a
                    for i, a in enumerate(getattr(inp.forc, k))})
    return out


@pytest.mark.parametrize("levels", (1, 2))
@pytest.mark.parametrize("variant", VARIANTS)
def test_refine_matches_jax(variant, levels):
    j = jax_refine(make_project("jax", variant, 6, 4), levels)
    t = refine_project(make_project("torch", variant, 6, 4), levels)
    aj, at = _arrays(j), _arrays(t)
    assert sorted(aj) == sorted(at) and "tri" in at and "att" in at
    for k in aj:
        assert aj[k].dtype == at[k].dtype, k
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    assert t.tri.shape[0] == 48 * 4 ** levels
    assert dataclasses.asdict(t.control) == dataclasses.asdict(j.control)
    with pytest.raises(ValueError):
        refine_project(make_project("torch", variant, 6, 4), -1)


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    inp = make_project("torch", request.param, 12, 8)
    md0 = build_mesh(inp)
    r1 = refine_project(make_project("torch", request.param, 12, 8), 1)
    return request.param, inp, md0, r1, build_mesh(r1)


def test_counts_and_conservation(pair):
    _, _, md0, _, md1 = pair
    ne = md0.num_ele
    assert md1.num_ele == 4 * ne
    assert md1.num_riv == md0.num_riv and md1.num_lake == md0.num_lake
    assert md1.seg_ele.shape == md0.seg_ele.shape
    # children tile the parent exactly
    np.testing.assert_allclose(md1.area.reshape(ne, 4).sum(axis=1), md0.area,
                               rtol=1e-12)
    # the area-weighted mean surface elevation is conserved by linear
    # midpoint interpolation (up to the sink removal of build_mesh)
    tot0 = float((md0.area * md0.z_surf).sum())
    tot1 = float((md1.area * md1.z_surf).sum())
    assert abs(tot1 - tot0) / abs(tot0) < 1e-4


def _open_edges(md):
    """Edges with neither a neighbour cell nor a lake across them."""
    return int((md.nabr < 0).sum() - (md.lakenabr >= 0).sum())


def test_neighbour_graph_conforming(pair):
    variant, inp, md0, _, md1 = pair
    nabr = md1.nabr
    for i in range(md1.num_ele):
        for j in nabr[i]:
            if j >= 0:
                assert i in nabr[j], (i, j)
    # each boundary edge of the parent splits into two
    assert _open_edges(md1) == 2 * _open_edges(md0) > 0
    if variant == "plain":
        nb0 = int((np.asarray(inp.tri)[:, 4:7] == 0).sum())
        assert _open_edges(md1) == 2 * nb0


def test_rhs_on_refined_matches_jax(pair):
    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.core.rhs import rhs as jax_rhs
    from shud_tpu.core.state import ForcingSlice as JFS
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import rhs
    from shud_tpu_torch.core.state import ForcingSlice as TFS

    variant, _, _, r1, md1 = pair
    mdj = jax_build(jax_refine(make_project("jax", variant, 12, 8), 1))
    fs, y = random_inputs(md1, seed=4, dry_every=5)
    cb = bool(r1.control.close_boundary)
    dj = np.asarray(jax_rhs(to_device(mdj, jnp.float64),
                            JFS(**{k: jnp.asarray(v) for k, v in fs.items()}),
                            0.0, jnp.asarray(y), cb))
    dt = rhs(to_torch(md1, torch.float64, "cpu"),
             TFS(**{k: torch.tensor(v) for k, v in fs.items()}), 0.0,
             torch.tensor(y), cb).numpy()
    assert np.isfinite(dt).all() and dt.shape == (3 * md1.num_ele
                                                  + md1.num_riv
                                                  + md1.num_lake,)
    assert scaled_err(dj, dt) <= 1e-12
