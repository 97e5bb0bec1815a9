"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
shud_tpu_torch/csrc/*.cu at first use) and skip elsewhere; run them on
the card with ``python -m pytest tests/test_torch_kernels.py
--noconftest``.  They need no JAX.  Bars are chip_smoke.py's.  Edge trio:
q_surf scaled 2e-6, q_sub 1e-6, coefficients and tangents 1e-6, full RHS
dY 2e-6.  Mega trio (plain, lake and branched meshes, both boundary
modes): dY and every diagnostic field scaled 2e-6, J·v 1e-5, each
output bitwise equal across two calls and to its plain version; each
mega kernel is one device launch per call and refuses a grid the card
cannot hold.  The sharded RHS (2 gloo ranks on the card, 32,768 cells):
dY through edge_flux bitwise its plain path's, the coefficient path's dY
and the hand J·v (edge_coeff, edge_apply) within 1e-6 scaled.
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


@pytest.fixture(scope="module", params=("plain", "lake", "branched"))
def mega_case(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.state import ForcingSlice
    from torch_variants import make_project, mega_inputs

    md = build_mesh(make_project("torch", request.param, 24, 16))
    dev = torch.device("cuda")
    tables = M.build_mega_tables(md).to(dev)
    fs, y, v = mega_inputs(md, seed=5)
    forcing = M.pack_forcing(tables, ForcingSlice(
        **{k: torch.as_tensor(a, device=dev) for k, a in fs.items()}))
    return dict(M=M, tables=tables, forcing=forcing,
                y=torch.as_tensor(y, device=dev),
                v=torch.as_tensor(v, device=dev))


def _fields(t, flat):
    """dY split into its state blocks (sf, us, gw, river, lake)."""
    ne, nr = t.ne, t.nr
    return {"sf": flat[:ne], "us": flat[ne:2 * ne], "gw": flat[2 * ne:3 * ne],
            "riv": flat[3 * ne:3 * ne + nr], "lake": flat[3 * ne + nr:]}


@pytest.mark.parametrize("cb", (True, False))
def test_mega_kernels(mega_case, cb):
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    n0 = dict(M.launch_counts)
    dy, jv, dg = (M.mega_rhs(t, f, y, cb), M.mega_jvp(t, f, y, v, cb),
                  M.mega_diag(t, f, y, cb))
    again = (M.mega_rhs(t, f, y, cb), M.mega_jvp(t, f, y, v, cb),
             M.mega_diag(t, f, y, cb))
    plain = (M.mega_rhs_plain(t, f, y, cb), M.mega_jvp_plain(t, f, y, v, cb),
             M.mega_diag_plain(t, f, y, cb))
    torch.cuda.synchronize()
    assert {k: M.launch_counts[k] - n0[k] for k in n0} == {
        "mega_rhs": 2, "mega_jvp": 2, "mega_diag": 2}
    for a, b in zip((dy, jv, dg), again):
        assert torch.equal(a, b)
    for name, (p, k) in (("dy", (plain[0], dy)), ("jv", (plain[1], jv))):
        bar = 2e-6 if name == "dy" else 1e-5
        for field, ref in _fields(t, p).items():
            if ref.numel():
                assert _scaled(ref, _fields(t, k)[field]) <= bar, (name, field)
    got = M.diag_dict(t, dg)
    for field, ref in M.diag_dict(t, plain[2]).items():
        assert _scaled(ref, got[field]) <= 2e-6, field


@pytest.mark.parametrize("cb", (True, False))
def test_mega_kernels_match_plain_bitwise(mega_case, cb):
    """Built without fused multiply-adds and calling the CUDA math
    functions the plain versions call, each mega kernel gives its plain
    version's result to the last bit, so the kernel path of a solve is the
    plain path's."""
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    assert torch.equal(M.mega_rhs(t, f, y, cb), M.mega_rhs_plain(t, f, y, cb))
    assert torch.equal(M.mega_jvp(t, f, y, v, cb),
                       M.mega_jvp_plain(t, f, y, v, cb))
    assert torch.equal(M.mega_diag(t, f, y, cb),
                       M.mega_diag_plain(t, f, y, cb))


def test_mega_rhs_jvp_through_the_kernels(mega_case):
    """torch.func.jvp of rhs_mega launches the RHS and tangent kernels."""
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    n0 = dict(M.launch_counts)
    dy, jv = torch.func.jvp(lambda yy: M.rhs_mega(t, f, yy, True), (y,), (v,))
    torch.cuda.synchronize()
    assert M.launch_counts["mega_rhs"] == n0["mega_rhs"] + 1
    assert M.launch_counts["mega_jvp"] == n0["mega_jvp"] + 1
    assert torch.equal(dy, M.mega_rhs(t, f, y, True))
    assert torch.equal(jv, M.mega_jvp(t, f, y, v, True))


def test_mega_wrappers_refuse_bad_inputs(mega_case):
    c = mega_case
    M, t, f, y = c["M"], c["tables"], c["forcing"], c["y"]
    with pytest.raises(ValueError, match="float32"):
        M.mega_rhs(t, f, y.double(), True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        M.mega_rhs(t, f, y.cpu(), True)
    # a forcing not made by pack_forcing is checked when first bound
    bad = M.MegaForcing(f.fcell.double(), f.friv, f.segfu, f.flake)
    with pytest.raises(ValueError, match="float32"):
        M.mega_jvp(t, bad, y, c["v"], True)


def test_linearize_mega_on_the_card(mega_case):
    """The solver's hook: one RHS launch, then one tangent launch per
    vector, bitwise what torch.func.jvp of rhs_mega gives."""
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    n0 = dict(M.launch_counts)
    fy, jvp = M.linearize_mega(t, f, y, True)
    jvs = [jvp(v), jvp(2.0 * v)]
    torch.cuda.synchronize()
    assert M.launch_counts["mega_rhs"] == n0["mega_rhs"] + 1
    assert M.launch_counts["mega_jvp"] == n0["mega_jvp"] + 2
    for w, jv in zip((v, 2.0 * v), jvs):
        dy, ref = torch.func.jvp(lambda yy: M.rhs_mega(t, f, yy, True),
                                 (y,), (w,))
        assert torch.equal(fy, dy) and torch.equal(jv, ref)


def _mega_call(c, name):
    """A function of the tables that makes one call of mega kernel
    *name* on the case's forcing, state (and tangent)."""
    M, f, y, v = c["M"], c["forcing"], c["y"], c["v"]
    return {"mega_rhs": lambda t: M.mega_rhs(t, f, y, True),
            "mega_jvp": lambda t: M.mega_jvp(t, f, y, v, True),
            "mega_diag": lambda t: M.mega_diag(t, f, y, True)}[name]


MEGA_KERNELS = ("mega_rhs", "mega_jvp", "mega_diag")


@pytest.mark.parametrize("name", MEGA_KERNELS)
def test_mega_one_device_launch_per_call(mega_case, name):
    """Each mega kernel call is one launch on the device, of the fused
    kernel, counted from torch.profiler's device rows as chip_smoke.py
    phase 5 counts them (rounded: the profiler may drop a record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call, t, reps = _mega_call(mega_case, name), mega_case["tables"], 10
    call(t)
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session on the card can come back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call(t)
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages()
                if getattr(r, "device_type", None) == DeviceType.CUDA
                and (getattr(r, "self_device_time_total", 0)
                     or getattr(r, "self_cuda_time_total", 0))]
        if rows:
            break
    assert rows, "the profiler recorded no device time"
    assert round(sum(r.count for r in rows) / reps) == 1
    assert all("fused" in r.key for r in rows), [r.key for r in rows]


@pytest.mark.parametrize("name", MEGA_KERNELS)
def test_mega_launch_refused_when_not_resident(mega_case, monkeypatch, name):
    """No fallback: a grid the card cannot hold resident is refused by
    launch_plan before the launch, and by the cooperative launch itself;
    a refused launch leaves the next one unharmed."""
    import ctypes
    import dataclasses

    M, t = mega_case["M"], mega_case["tables"]
    call = _mega_call(mega_case, name)
    ref = call(t)
    st = t._launch
    occ = M.occupancy(name)
    dims = list(st.dims[name, True])
    dims[11] = occ["blocks_per_sm"] * occ["sm_count"] + 1
    st.ptrs[22] = torch.empty_like(ref).data_ptr()
    err = st.fns[name](st.ptrs, (ctypes.c_int * 12)(*dims),
                       torch.cuda.current_stream().cuda_stream)
    assert err != 0
    assert torch.equal(call(t), ref)
    monkeypatch.setitem(M._OCCUPANCY, name, dict(occ, sm_count=1,
                                                 blocks_per_sm=1))
    with pytest.raises(ValueError, match="resident"):
        call(dataclasses.replace(t))


def test_sharded_rhs_with_kernels():
    """Two ranks on one card over gloo, at 32,768 cells: one sharded RHS
    and one hand J·v with the edge kernels against the same on their plain
    versions (``parallel/sharded.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.parallel import comm
    from shud_tpu_torch.parallel.partition import build_sharded_mesh
    from shud_tpu_torch.utils.synthetic import make_synthetic_project
    from torch_sharded_ranks import kernels_rank
    from torch_variants import random_inputs

    md = build_mesh(make_synthetic_project(128, 128))
    fs, y = random_inputs(md, seed=4, dry_every=7)
    v = np.random.default_rng(5).standard_normal(y.shape)
    sm = build_sharded_mesh(md, 2)
    ranks = comm.spawn(kernels_rank, 2, "gloo", ["cuda:0"] * 2,
                       args=(sm, fs, y, v), timeout=600)
    for r in ranks:
        k, p = r["kernel"], r["plain"]
        np.testing.assert_array_equal(k["dy"], p["dy"])
        for key in ("dy_lin", "jv"):
            ref, got = p[key].astype(np.float64), k[key].astype(np.float64)
            assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), key
        assert k["launches"] == {"edge_flux": 1, "edge_coeff": 1,
                                 "edge_apply": 1}
        assert p["launches"] == dict.fromkeys(k["launches"], 0)
