"""The edge-flux stencil of the port (core/edge.py) against the JAX package.

The JAX side is its XLA path, ``rhs.edge_fluxes``, which
``tests/test_pallas_edge.py`` pins to the Pallas edge kernel; the Pallas
kernel itself runs on the CPU only in interpret mode, which the CI budget
marks slow.  The port's side is the plain PyTorch version of each CUDA
kernel, which is what the kernel wrappers run for CPU tensors.  Bars are
the Pallas kernel's against XLA: q_surf scaled atol 2e-6, q_sub 1e-6, and
tangents 1e-6 (f32 association order in the product-rule sums).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.core import rhs as JR  # noqa: E402
from shud_tpu.core.device import to_device  # noqa: E402
from shud_tpu_torch.core import edge as E  # noqa: E402
from shud_tpu_torch.core import rhs as TR  # noqa: E402
from shud_tpu_torch.core.device import to_torch  # noqa: E402
from torch_variants import meshes, scaled_err  # noqa: E402

CASES = [("rcm", True), ("rcm", False), ("plain", False)]


def _setup(variant, dtype=np.float32, dry_every=7):
    md_j, md_t, _ = meshes(variant, 16, 12)
    ne = md_j.num_ele
    rng = np.random.default_rng(1)
    sf = rng.uniform(0, 0.05, ne)
    if dry_every:
        sf[::dry_every] = 0.0  # exactly-dry cells exercise tie conventions
    gw = rng.uniform(0, 8.0, ne)
    us = rng.uniform(0, 1.0, ne)
    tan = [rng.standard_normal(ne) for _ in range(3)]
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    dm_j = to_device(md_j, jd)
    dm_t = to_torch(md_t, td, "cpu")
    cu_j = JR.update_element(dm_j, *(jnp.asarray(v, jd) for v in (sf, us, gw)))
    cu_t = TR.update_element(dm_t, *(torch.tensor(v, dtype=td)
                                     for v in (sf, us, gw)))
    return dict(dm_j=dm_j, dm_t=dm_t, cu_j=cu_j, cu_t=cu_t,
                j=[jnp.asarray(v, jd) for v in (sf, gw)],
                t=[torch.tensor(v, dtype=td) for v in (sf, gw)],
                tan_j=[jnp.asarray(v, jd) for v in tan],
                tan_t=[torch.tensor(v, dtype=td) for v in tan], jd=jd, td=td)


@pytest.mark.parametrize("variant,cb", CASES)
def test_plain_primal_matches_xla(variant, cb):
    s = _setup(variant)
    et = s["dm_t"].edge_tables
    qs_j, qb_j, _, _ = JR.edge_fluxes(s["dm_j"], s["cu_j"], *s["j"],
                                      jnp.zeros((0,), s["jd"]), cb)
    qs_t, qb_t = E.edge_flux_plain(*s["t"], s["cu_t"].eff_kh, et, cb)
    assert scaled_err(qs_j, qs_t.numpy()) <= 2e-6
    assert scaled_err(qb_j, qb_t.numpy()) <= 1e-6
    # the coefficient kernel's primal outputs are the same numbers
    outs = E.edge_coeff_plain(*s["t"], s["cu_t"].eff_kh, et, cb)
    assert torch.equal(outs[0], qs_t) and torch.equal(outs[1], qb_t)


@pytest.mark.parametrize("variant,cb", CASES)
def test_function_jvp_matches_jax(variant, cb):
    """The linearization's pieces, ``edge_coeff`` then ``edge_apply`` (the
    plain versions on the CPU), vs jax.jvp of the XLA path, dry-cell ties
    on."""
    s = _setup(variant)
    et = s["dm_t"].edge_tables
    dm_j, cu_j = s["dm_j"], s["cu_j"]
    lake0 = jnp.zeros((0,), s["jd"])

    def f_xla(sf_, gw_, kh_):
        qs, qb, _, _ = JR.edge_fluxes(dm_j, cu_j._replace(eff_kh=kh_), sf_,
                                      gw_, lake0, cb)
        return qs, qb

    (qs_a, qb_a), (tqs_a, tqb_a) = jax.jvp(
        f_xla, (*s["j"], cu_j.eff_kh), tuple(s["tan_j"]))

    qs_b, qb_b, *coeffs = E.edge_coeff(*s["t"], s["cu_t"].eff_kh, et, cb)
    tqs_b, tqb_b = E.edge_apply(coeffs, *s["tan_t"], et)
    assert scaled_err(qs_a, qs_b.numpy()) <= 2e-6
    assert scaled_err(qb_a, qb_b.numpy()) <= 1e-6
    assert scaled_err(tqs_a, tqs_b.numpy()) <= 1e-6
    assert scaled_err(tqb_a, tqb_b.numpy()) <= 1e-6


@pytest.mark.parametrize("cb", (True, False))
def test_coefficients_equal_autodiff_f64(cb):
    """In f64 the hand-derived coefficients reproduce torch's own forward
    autodiff of the plain primal to round-off (same tie conventions)."""
    s = _setup("rcm", np.float64)
    et = s["dm_t"].edge_tables
    args = (*s["t"], s["cu_t"].eff_kh)
    _, (tqs_a, tqb_a) = torch.func.jvp(
        lambda *a: E.edge_flux_plain(*a, et, cb), args, tuple(s["tan_t"]))
    coeffs = E.edge_coeff_plain(*args, et, cb)[2:]
    tqs_b, tqb_b = E.edge_apply_plain(coeffs, *s["tan_t"], et)
    assert scaled_err(tqs_a, tqs_b) <= 1e-12
    assert scaled_err(tqb_a, tqb_b) <= 1e-12


def test_cpu_wrappers_run_plain_versions(monkeypatch):
    """On CPU tensors the wrappers are the plain versions and launch
    nothing; reverse mode on the kernel route (stood in for on the CPU:
    ``rhs._on_kernels`` keeps only the rule of ``edge.kernels_may_run``)
    is refused."""
    s = _setup("plain")
    et = s["dm_t"].edge_tables
    kh = s["cu_t"].eff_kh
    E.reset_launch_counts()
    a = E.edge_flux(*s["t"], kh, et, False)
    b = E.edge_flux_plain(*s["t"], kh, et, False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = E.edge_coeff(*s["t"], kh, et, False)
    d = E.edge_coeff_plain(*s["t"], kh, et, False)
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    e = E.edge_apply(c[2:], *s["tan_t"], et)
    f = E.edge_apply_plain(d[2:], *s["tan_t"], et)
    assert all(torch.equal(x, y) for x, y in zip(e, f))
    assert E.launch_counts == {"edge_flux": 0, "edge_coeff": 0,
                               "edge_apply": 0, "tangent_cell": 0,
                               "tangent_reach": 0, "rhs_cell": 0,
                               "rhs_assemble": 0}
    monkeypatch.setattr(TR, "_on_kernels",
                        lambda m, *xs: E.kernels_may_run(*xs))
    sf = s["t"][0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="reverse mode"):
        TR.edge_fluxes(s["dm_t"], s["cu_t"], sf, s["t"][1],
                       torch.zeros(0), True)
    with pytest.raises(ValueError, match="float32 on a CUDA"):
        to_torch(meshes("plain", 4, 2)[1], torch.float32, "cpu",
                 edge_kernel=True)


@pytest.mark.parametrize("k, n, threads", [
    (1, 10, 1), (3, 131072, 2), (4, 300, 4), (31, 3, 16), (33, 300, 32),
    (63, 3, 32), (64, 3, 64), (70, 300, 32), (100, 4096, 32), (127, 1, 64),
    (127, 3, 64), (128, 4096, None), (600, 1, None)])
def test_sum_threads_follow_reduce_config(k, n, threads):
    """edge.sum_threads gives torch's CUDA reduce kernel's threads a row up
    to SUM_WIDTH_MAX elements, at most the 64 the RHS kernels' tree holds,
    and edge.sum_in_order admits a gather list exactly where it is that
    narrow (from 128 torch loads a row four elements at a time)."""
    if threads is not None:
        assert E.sum_threads(k, n) == threads
    assert max(E.sum_threads(k_, n_) for k_ in range(1, E.SUM_WIDTH_MAX + 1)
               for n_ in (1, 2, 3, 300)) == 64
    lst = torch.zeros((n, k), dtype=torch.long)
    assert E.sum_in_order(lst) == (threads is not None)
