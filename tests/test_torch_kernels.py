"""The CUDA edge-flux kernels against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc (the kernels are built from
shud_tpu_torch/csrc/edge_flux.cu at first use) and skip elsewhere; run
them on the card with ``python -m pytest tests/test_torch_kernels.py``.
They need no JAX.  Bars are chip_smoke.py's: q_surf scaled atol 2e-6,
q_sub 1e-6, coefficients and tangents 1e-6, full RHS dY 2e-6.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.rhs import update_element
    from shud_tpu_torch.utils.reorder import localize_project, permute_project
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(48, 44)
    ne = inp.tri.shape[0]
    inp, _ = localize_project(
        permute_project(inp, np.random.default_rng(7).permutation(ne)))
    md = build_mesh(inp)
    dev = torch.device("cuda")
    dm = to_torch(md, torch.float32, dev)
    rng = np.random.default_rng(1)
    sf = rng.uniform(0, 0.05, ne)
    sf[::7] = 0.0

    def t(a):
        return torch.as_tensor(a, device=dev).to(torch.float32)

    sf, gw, us = t(sf), t(rng.uniform(0, 8.0, ne)), t(rng.uniform(0, 1, ne))
    kh = update_element(dm, sf, us, gw).eff_kh.contiguous()
    tan = [t(rng.standard_normal(ne)) for _ in range(3)]
    return dict(md=md, dm=dm, sf=sf, gw=gw, kh=kh, tan=tan)


def _scaled(ref, got):
    ref, got = ref.double(), got.double()
    return float((ref - got).abs().max()) / (float(ref.abs().max()) or 1.0)


@pytest.mark.parametrize("cb", (True, False))
def test_edge_flux_kernel(setup, cb):
    from shud_tpu_torch.core import edge as E

    s = setup
    et = s["dm"].edge_tables
    n0 = E.launch_counts["edge_flux"]
    qk = E.edge_flux(s["sf"], s["gw"], s["kh"], et, cb)
    qp = E.edge_flux_plain(s["sf"], s["gw"], s["kh"], et, cb)
    torch.cuda.synchronize()
    assert E.launch_counts["edge_flux"] == n0 + 1
    assert _scaled(qp[0], qk[0]) <= 2e-6
    assert _scaled(qp[1], qk[1]) <= 1e-6


@pytest.mark.parametrize("cb", (True, False))
def test_edge_coeff_kernel(setup, cb):
    from shud_tpu_torch.core import edge as E

    s = setup
    et = s["dm"].edge_tables
    ck = E.edge_coeff(s["sf"], s["gw"], s["kh"], et, cb)
    cp = E.edge_coeff_plain(s["sf"], s["gw"], s["kh"], et, cb)
    torch.cuda.synchronize()
    assert _scaled(cp[0], ck[0]) <= 2e-6
    assert _scaled(cp[1], ck[1]) <= 1e-6
    for p, k in zip(cp[2:], ck[2:]):
        assert _scaled(p, k) <= 1e-6


@pytest.mark.parametrize("cb", (True, False))
def test_edge_apply_kernel(setup, cb):
    from shud_tpu_torch.core import edge as E

    s = setup
    et = s["dm"].edge_tables
    coeffs = E.edge_coeff_plain(s["sf"], s["gw"], s["kh"], et, cb)[2:]
    ak = E.edge_apply(coeffs, *s["tan"], et)
    ap = E.edge_apply_plain(coeffs, *s["tan"], et)
    torch.cuda.synchronize()
    assert _scaled(ap[0], ak[0]) <= 1e-6
    assert _scaled(ap[1], ak[1]) <= 1e-6


def test_rhs_and_jvp_with_kernels(setup):
    """Full f32 RHS and its J·v with the kernels vs the plain path."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import rhs
    from shud_tpu_torch.core.state import ForcingSlice

    md = setup["md"]
    dev = torch.device("cuda")
    ne, nr = md.num_ele, md.num_riv
    rng = np.random.default_rng(2)

    def t(a):
        return torch.as_tensor(a, device=dev).to(torch.float32)

    z = t(np.zeros(ne))
    fs = ForcingSlice(t(rng.uniform(0, 2e-5, ne)), t(rng.uniform(0, 2e-5, ne)),
                      t(rng.uniform(0, 1e-6, ne)), t(rng.uniform(0, 1e-6, ne)),
                      t(rng.uniform(0, 1e-7, ne)), z + 2.0, z + 1.0, z + 1.0,
                      z, z, z, t(np.zeros(nr)), t(np.zeros(nr)))
    y = t(np.concatenate([rng.uniform(0, 0.05, ne), rng.uniform(0, 1, ne),
                          rng.uniform(0, 8, ne), rng.uniform(0, 1, nr)]))
    v = t(rng.standard_normal(y.shape[0]))
    dm_k = to_torch(md, torch.float32, dev)
    dm_p = to_torch(md, torch.float32, dev, edge_kernel=False)
    assert dm_k.edge_kernel and not dm_p.edge_kernel
    out = {}
    for name, dm in (("k", dm_k), ("p", dm_p)):
        out[name] = torch.func.jvp(lambda yy: rhs(dm, fs, 0.0, yy), (y,), (v,))
    torch.cuda.synchronize()
    assert _scaled(out["p"][0], out["k"][0]) <= 2e-6
    assert _scaled(out["p"][1], out["k"][1]) <= 2e-6


def test_wrappers_refuse_bad_inputs(setup):
    from shud_tpu_torch.core import edge as E

    s = setup
    et = s["dm"].edge_tables
    with pytest.raises(ValueError, match="float32"):
        E.edge_flux(s["sf"].double(), s["gw"], s["kh"], et, True)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([s["sf"], s["sf"]], dim=1)[:, 0]
        E.edge_flux(strided, s["gw"], s["kh"], et, True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        E.edge_flux(s["sf"].cpu(), s["gw"], s["kh"], et, True)
