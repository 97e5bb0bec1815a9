"""The ``-g`` driver's hand linearizations (``driver/uncoupled.py``
``linearize_surf`` ... ``linearize_lake``), the solver's once-per-Newton-
iteration hook on the split path, against both packages' J·v.

Inputs come from a numpy seed, in f64, on the 12x8 meshes of
tests/torch_variants.py: plain, open boundary (``close_boundary=False``),
every BC class (``with_bc``: head and flux BCs, sources, river BCs, with
values), and the lake mesh with its stage at 0 ("lake") and above it
("lake_wet").  A share of cells sits exactly at the switches: sf = 0,
us = 0, gw = 0, gw = aq_depth, river stage 0.  For each sub-RHS:

* the hand primal is bitwise the port's sub-RHS;
* J·v on a random vector is within 1e-12 scaled of ``torch.func.jvp`` of
  the port's sub-RHS and of ``jax.jvp`` of the JAX package's
  (``shud_tpu/driver/uncoupled.py``) on the same input.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.core.device import to_device  # noqa: E402
from shud_tpu.core.state import ForcingSlice as JFS  # noqa: E402
from shud_tpu.driver import uncoupled as JU  # noqa: E402
from shud_tpu_torch.core.device import to_torch  # noqa: E402
from shud_tpu_torch.core.state import ForcingSlice as TFS  # noqa: E402
from shud_tpu_torch.driver import uncoupled as TU  # noqa: E402
from torch_variants import (  # noqa: E402
    meshes, random_inputs, scaled_err, with_bc)

BAR = 1e-12
VARIANTS = ("plain", "open", "bc", "lake", "lake_wet")
SUBS = ("surf", "unsat", "gw", "riv")
CASES = [(s, v) for v in VARIANTS for s in SUBS] + [
    ("lake", "lake"), ("lake", "lake_wet")]


@lru_cache(maxsize=None)
def _case(variant: str):
    """(jax mesh, torch mesh, close_boundary, forcing dict, state dict,
    frozen-input dict) for *variant*, with cells at the switches."""
    base = {"bc": "plain", "lake_wet": "lake"}.get(variant, variant)
    md_j, md_t, cb = meshes(base)
    if variant == "bc":
        md_j, md_t = with_bc(md_j), with_bc(md_t)
    fs, y = random_inputs(md_j, seed=11, dry_every=5)
    ne, nr, nl = md_j.num_ele, md_j.num_riv, md_j.num_lake
    rng = np.random.default_rng(12)
    fs["fu_surf"] = rng.uniform(0.3, 1.0, ne)
    fs["fu_sub"] = rng.uniform(0.3, 1.0, ne)
    if variant == "bc":
        fs.update(ele_ybc=rng.uniform(0.5, 3.0, ne),
                  ele_qbc=rng.normal(0.0, 1e-3, ne),
                  ele_qss=rng.normal(0.0, 1e-3, ne),
                  riv_ybc=rng.uniform(0.05, 1.0, nr),
                  riv_qbc=rng.uniform(0.0, 1e-2, nr))
    st = dict(sf=y[:ne].copy(), us=y[ne:2 * ne].copy(),
              gw=y[2 * ne:3 * ne].copy(), riv=y[3 * ne:3 * ne + nr].copy(),
              lake=y[3 * ne + nr:].copy())
    st["us"][1::7] = 0.0
    st["gw"][2::9] = 0.0
    st["gw"][4::11] = np.asarray(md_j.aq_depth)[4::11]
    st["riv"][::4] = 0.0
    if variant == "lake":
        st["lake"][:] = 0.0
    frozen = dict(
        q_rech0=rng.uniform(0.0, 1e-5, ne),
        q_exfil0=rng.uniform(0.0, 1e-5, ne),
        evapo0=rng.uniform(0.0, 1e-6, ne), trans0=rng.uniform(0.0, 1e-6, ne),
        q_riv_surf0=rng.normal(0.0, 1.0, nr),
        q_riv_sub0=rng.normal(0.0, 1.0, nr),
        q_lake_rivin0=rng.uniform(0.0, 50.0, nl))
    return md_j, md_t, cb, fs, st, frozen


NAMES = {"surf": "surf", "unsat": "unsat", "gw": "gw", "riv": "river",
         "lake": "lake"}


def _call(pkg, prefix, sub, m, fs, x, st, fr, cb):
    """*pkg*'s ``{prefix}_{sub}`` (``rhs_surf``, ``linearize_surf`` ...)
    at *x*, the other states frozen at *st* (clamped as
    advance_window_uncoupled clamps them), *fr* the frozen fluxes."""
    lake0 = st["lake"] if st["lake"].shape[0] else None
    args = {
        "surf": (st["us"], st["gw"], st["riv"], lake0, cb),
        "unsat": (st["sf"], st["gw"], cb),
        "gw": (st["sf"], st["us"], st["riv"], fr["q_rech0"], fr["q_exfil0"],
               fr["evapo0"], fr["trans0"], lake0, cb),
        "riv": (fr["q_riv_surf0"], fr["q_riv_sub0"]),
        "lake": (st["sf"], st["us"], st["gw"], fr["q_lake_rivin0"], cb),
    }[sub]
    return getattr(pkg, f"{prefix}_{NAMES[sub]}")(m, fs, 0.0, x, *args)


@pytest.mark.parametrize("sub,variant", CASES)
def test_split_linearization(sub, variant):
    md_j, md_t, cb, fs, st, fr = _case(variant)
    own = {"surf": "sf", "unsat": "us"}.get(sub, sub)
    v = np.random.default_rng(13).standard_normal(st[own].shape[0])
    clamp = {k: np.maximum(a, 0.0) for k, a in st.items()}

    dm = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(a) for k, a in fs.items()})
    st_t = {k: torch.tensor(a) for k, a in clamp.items()}
    fr_t = {k: torch.tensor(a) for k, a in fr.items()}
    x, vt = torch.tensor(st[own]), torch.tensor(v)
    dy, jvp = _call(TU, "linearize", sub, dm, fs_t, x, st_t, fr_t, cb)
    assert torch.equal(dy, _call(TU, "rhs", sub, dm, fs_t, x, st_t, fr_t,
                                 cb))
    got = jvp(vt)
    assert got.dtype == torch.float64 and bool(torch.isfinite(got).all())
    ref = torch.func.jvp(
        lambda xx: _call(TU, "rhs", sub, dm, fs_t, xx, st_t, fr_t, cb),
        (x,), (vt,))[1]
    assert scaled_err(ref.numpy(), got.numpy()) <= BAR
    assert float(got.abs().max()) > 0

    dm_j = to_device(md_j, jnp.float64)
    fs_j = JFS(**{k: jnp.asarray(a) for k, a in fs.items()})
    st_j = {k: jnp.asarray(a) for k, a in clamp.items()}
    fr_j = {k: jnp.asarray(a) for k, a in fr.items()}
    _, tj = jax.jvp(
        lambda xx: _call(JU, "rhs", sub, dm_j, fs_j, xx, st_j, fr_j, cb),
        (jnp.asarray(st[own]),), (jnp.asarray(v),))
    assert scaled_err(np.asarray(tj), got.numpy()) <= BAR
