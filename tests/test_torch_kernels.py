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
and the hand J·v (edge_coeff, edge_apply) within 1e-6 scaled.  The
captured programs (WindowGraph, IntervalGraph, the -g driver's
SplitGraph) bitwise their eager loops.  The tangent factor kernels
(tangent_cell, tangent_reach) bitwise their plain version on every mesh
variant with BCs and tied states, rhs.linearize's dY and J·v bitwise
with either, one device launch of each a linearize call; their wrappers
refuse what they cannot take.  The interval graph's stamps
(``%globaltimer``): a pair around a sleep against CUDA events; only with
tracing on, the captured pieces unchanged.  The mega kernels' lake stage
clock (``mega.lake_stage_ns``) on a three-lake variant of the benchmark's
lake basin: only with tracing on, eager and captured, every output
bitwise the untimed one's.  Stage C (a block per lake) bitwise its plain
versions on lake basins whose widest bank-edge list lies inside one,
on the boundary of, and across two and three of its gather rounds, with
several lakes and more lakes than blocks.
"""

import numpy as np
import pytest
import torch
from torch_variants import STAGE_C_BASINS

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
    """Full f32 RHS with the kernels vs the plain path, and its J·v as the
    solver takes it with the kernels (rhs.linearize) vs torch.func.jvp of
    the plain RHS."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import linearize, rhs
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
    dy_p, jv_p = torch.func.jvp(lambda yy: rhs(dm_p, fs, 0.0, yy), (y,),
                                (v,))
    dy_k = rhs(dm_k, fs, 0.0, y)
    dy_h, jvp = linearize(dm_k, fs, 0.0, y)
    jv_k = jvp(v)
    torch.cuda.synchronize()
    assert _scaled(dy_p, dy_k) <= 2e-6
    assert _scaled(dy_p, dy_h) <= 2e-6
    assert _scaled(jv_p, jv_k) <= 2e-6


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


# the tangent factor kernels (csrc/edge_tangent.cu) on every mesh variant
TANGENT_VARIANTS = ("plain", "open", "rcm", "lake", "branched")


def _tangent_case(variant, seed):
    """A float32 linearization's primal on the card: the *variant* mesh
    (48 x 32) with BCs (``torch_variants.with_bc``), the forcing and the
    state of ``mega_inputs`` (exact ties: dry cells, empty unsaturated
    layers, water tables at the surface, empty reaches).  Returns (device
    mesh, forcing, state, tangent, close_boundary, the primal's saved
    intermediates)."""
    from shud_tpu_torch.core import rhs as R
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.state import ForcingSlice
    from torch_variants import make_project, mega_inputs, with_bc

    inp = make_project("torch", variant, 48, 32)
    md = with_bc(build_mesh(inp))
    dev = torch.device("cuda")
    dm = to_torch(md, torch.float32, dev)
    fs, y, v = mega_inputs(md, seed)
    fs = ForcingSlice(**{k: torch.as_tensor(a, device=dev)
                         for k, a in fs.items()})
    y, v = torch.as_tensor(y, device=dev), torch.as_tensor(v, device=dev)
    cb = bool(inp.control.close_boundary)
    _, _, saved = R._rhs(dm, fs, y, cb, False, [])
    return dm, fs, y, v, cb, saved


def _same_entries(a, b) -> bool:
    """Equal entry by entry (NaN where the other is NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(((a == b) | (a.isnan() & b.isnan())).all()))


def _parted(got: dict, ref: dict) -> dict:
    """The entries of *got* that part from *ref*: count and largest gap."""
    return {k: (int((got[k] != ref[k]).sum()),
                float((got[k].double() - ref[k].double()).abs().max()))
            for k in ref if not _same_entries(got[k], ref[k])}


@pytest.mark.parametrize("variant", TANGENT_VARIANTS)
def test_tangent_factors_match_plain_bitwise(variant):
    """Every factor of the two kernels is its plain version's
    (rhs._tangent_factors, PyTorch on the card) to the last bit, on states
    with exact ties, two seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import rhs as R

    for seed in (5, 6):
        dm, fs, _, _, _, saved = _tangent_case(variant, seed)
        got = R._tangent_factors_kernel(dm, fs, saved)
        ref = R._tangent_factors(dm, fs, saved)
        torch.cuda.synchronize()
        assert set(got) == set(ref) == set(R._FACTORS)
        assert not _parted(got, ref), (seed, _parted(got, ref))


@pytest.mark.parametrize("variant", TANGENT_VARIANTS)
def test_linearize_tangent_kernels_match_plain_bitwise(variant,
                                                       monkeypatch):
    """rhs.linearize with the factor kernels against the same with the
    factors' plain version: dY and J·v bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, v, cb, _ = _tangent_case(variant, 5)
    dy_k, jvp_k = R.linearize(dm, fs, 0.0, y, cb)
    jv_k = jvp_k(v)
    monkeypatch.setattr(R, "_tangent_factors_kernel", R._tangent_factors)
    dy_p, jvp_p = R.linearize(dm, fs, 0.0, y, cb)
    jv_p = jvp_p(v)
    torch.cuda.synchronize()
    assert torch.equal(dy_k, dy_p)
    assert _same_entries(jv_k, jv_p), _parted({"jv": jv_k}, {"jv": jv_p})
    assert bool(torch.isfinite(jv_k).all())


def test_tangent_kernels_one_launch_per_linearize():
    """One device launch of each factor kernel a linearize call, none a
    J·v (the device counters and the wrappers' counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, v, cb, _ = _tangent_case("lake", 5)
    torch.cuda.synchronize()
    E.reset_launch_counts()
    _, jvp = R.linearize(dm, fs, 0.0, y, cb)
    for _ in range(3):
        jvp(v)
    torch.cuda.synchronize()
    # a lake mesh keeps the plain RHS
    want = {"edge_flux": 0, "edge_coeff": 1, "edge_apply": 3,
            "tangent_cell": 1, "tangent_reach": 1, "rhs_cell": 0,
            "rhs_assemble": 0}
    assert E.device_launch_counts() == want
    assert E.launch_counts == want


def test_tangent_wrappers_refuse_bad_inputs():
    """A CUDA input the kernels cannot take raises (no fallback): another
    dtype, length, device or layout; nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R

    dm, fs, _, _, _, saved = _tangent_case("plain", 5)
    cell, flags, get = R._tangent_cell_inputs(dm, fs, saved)

    def swap(fields, name, t):
        return [(k, t if k == name else x) for k, x in fields]

    n0 = dict(E.launch_counts)
    with pytest.raises(ValueError, match="float32"):
        E.tangent_cell(swap(cell, "beta", dm.beta.double()), flags, False)
    with pytest.raises(ValueError, match="shape"):
        E.tangent_cell(swap(cell, "sy", dm.sy[:-1]), flags, False)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([dm.area, dm.area], dim=1)[:, 0]
        E.tangent_cell(swap(cell, "area", strided), flags, False)
    with pytest.raises(ValueError, match="on cpu"):
        E.tangent_cell(swap(cell, "area", dm.area.cpu()), flags, False)
    with pytest.raises(ValueError, match="int64"):
        E.tangent_cell(cell, swap(flags, "i_bc", dm.i_bc.int()), False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.tangent_cell([(k, t.cpu()) for k, t in cell],
                       [(k, t.cpu()) for k, t in flags], False)
    ns, nr = dm.num_seg, dm.num_riv
    floats = [("r_csa", get("r_csa"), nr + 1)]
    with pytest.raises(ValueError, match="shape"):
        E.tangent_reach(floats, [], ns, nr)
    assert E.launch_counts == n0


# the RHS kernels (csrc/edge_rhs.cu) on every lake-free mesh variant
RHS_VARIANTS = tuple(v for v in TANGENT_VARIANTS if v != "lake")


def _same_bits(a, b) -> bool:
    """Equal bit for bit (the sign of a zero and a NaN's payload too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _rhs_parted(got, ref) -> list:
    """The names whose tensors part from *ref*'s (dY, diag, saved: the
    cell update field by field)."""
    out = [] if _same_bits(got[0], ref[0]) else ["dy"]
    for g, r in zip(got[1:], ref[1:]):
        if set(g) != set(r):
            out.append(("keys", sorted(set(g) ^ set(r))))
            continue
        for k in r:
            if k == "cu":
                out += [f"cu.{f}" for f in r[k]._fields
                        if not _same_bits(getattr(g[k], f),
                                          getattr(r[k], f))]
            elif not _same_bits(g[k], r[k]):
                out.append(k)
    return out


def _assembly_case(n: int, k: int, seed: int):
    """Random inputs of the RHS assembly (``rhs._RHS_ASSEMBLE_FIELDS`` and
    ``_FLAGS``) with n cells, 2n + 1 segments and n reaches, each gather
    list [n, k] of random ids and pads: ``(floats, flags, ne, ns, nr)``."""
    from shud_tpu_torch.core import rhs as R

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    ne, ns, nr = n, 2 * n + 1, n
    dims = {"ne": ne, "ns": ns, "nr": nr}

    def f(shape):
        return torch.as_tensor(rng.uniform(0.1, 2.0, shape).astype(
            np.float32), device=dev)

    def i(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape), device=dev)

    floats = [(key, f(shape), shape)
              for group, shape in zip(R._RHS_ASSEMBLE_FIELDS,
                                      (ne, (ne, 3), ns, nr))
              for key in group]
    flags = [("i_bc", i(0, 1, ne), ne), ("i_ss", i(0, 1, ne), ne),
             ("seg_ele", i(0, ne, ns), ns), ("seg_riv", i(0, nr, ns), ns),
             ("riv_bc", i(0, 1, nr), nr), ("riv_down", i(-1, nr, nr), nr),
             ("riv_to_lake", i(-1, 0, nr), nr),
             ("riv_outlet_code", i(-4, 1, nr), nr)]
    for key, rows, pad in (("seg_to_ele", "ne", "ns"),
                           ("seg_to_riv", "nr", "ns"),
                           ("riv_to_down", "nr", "nr")):
        t = i(0, dims[pad] + 1, (dims[rows], k))
        flags.append((key, t, tuple(t.shape)))
    return floats, flags, ne, ns, nr


def test_row_sum_matches_torch_bitwise():
    """The assembly's fixed-width sums (the three gather lists) are
    torch's CUDA gather_sum bit for bit at every row width 1-128 and
    wider with few and many rows: in the kernel's own order up to
    edge.SUM_WIDTH_MAX (127) wide, over up to 64 threads a row, and
    through torch's own sums beyond (128-600 wide, where torch loads a row
    four at a time): one launch where every list is in order, two where
    one is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R
    from shud_tpu_torch.core.device import gather_sum

    routes = {True: 0, False: 0}
    for k in list(range(1, 129)) + [129, 130, 200, 600]:
        for n in (3, 300, 4096):
            floats, flags, ne, ns, nr = _assembly_case(n, k, 1000 * k + n)
            lists = {key: t for key, t, _ in flags[-3:]}
            in_order = E.sum_in_order(lists["seg_to_ele"])
            assert in_order == (k <= 127)
            assert not in_order or E.sum_threads(k, n) <= 64
            E.reset_launch_counts()
            _, _, rows = R._rhs_assemble(floats, flags, ne, ns, nr)
            torch.cuda.synchronize()
            got = R._rhs_rows(rows, ne, ns, nr)
            assert E.device_launch_counts()["rhs_assemble"] == (
                1 if in_order else 2), (k, n)
            assert all(bool(torch.isfinite(got[key]).all()) for key in
                       ("q_seg_surf", "q_seg_sub", "q_riv_down"))
            for key, row, neg in R._RHS_GIVEN:
                x = -got[row] if neg else got[row]
                want = gather_sum(x, lists[key])
                out = {("seg_to_ele", "q_seg_surf"): "q_e2r_surf",
                       ("seg_to_ele", "q_seg_sub"): "q_e2r_sub",
                       ("seg_to_riv", "q_seg_surf"): "q_riv_surf",
                       ("seg_to_riv", "q_seg_sub"): "q_riv_sub",
                       ("riv_to_down", "q_riv_down"): "q_riv_up"}[key, row]
                assert _same_bits(got[out], want), (k, n, out)
            routes[in_order] += 1
    assert routes == {True: 3 * 127, False: 3 * 5}


@pytest.mark.parametrize("variant", RHS_VARIANTS)
def test_rhs_kernels_match_plain_bitwise(variant):
    """dY, every diagnostic and every intermediate linearize saves of the
    kernel route (_rhs_kernels) are its plain version's (_rhs_plain,
    PyTorch on the card) bit for bit, with the edge fluxes of edge_flux
    and of edge_coeff (whose coefficients too), both boundary modes, on
    states with exact ties, two seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import rhs as R

    for seed in (5, 6):
        dm, fs, y, _, _, _ = _tangent_case(variant, seed)
        assert R._rhs_on_kernels(dm, fs, y, False)
        for cb in (True, False):
            for route in ("flux", "coeff"):
                c_k = None if route == "flux" else []
                c_p = None if route == "flux" else []
                got = R._rhs(dm, fs, y, cb, False, c_k)
                ref = R._rhs_plain(dm, fs, y, cb, False, c_p)
                torch.cuda.synchronize()
                parted = _rhs_parted(got, ref)
                assert not parted, (seed, cb, route, parted)
                if c_k is not None:
                    assert all(_same_bits(a, b) for a, b in zip(c_k, c_p))


@pytest.mark.parametrize("variant", RHS_VARIANTS)
def test_linearize_rhs_kernels_match_plain_bitwise(variant, monkeypatch):
    """rhs.linearize and rhs_full on the RHS kernels against the same on
    the plain RHS (the route before the kernels): dY, J·v and every
    diagnostic bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, v, cb, _ = _tangent_case(variant, 5)
    dy_k, jvp_k = R.linearize(dm, fs, 0.0, y, cb)
    jv_k = jvp_k(v)
    full_k = R.rhs_full(dm, fs, 0.0, y, cb)
    monkeypatch.setattr(R, "_rhs_on_kernels", lambda *a: False)
    dy_p, jvp_p = R.linearize(dm, fs, 0.0, y, cb)
    jv_p = jvp_p(v)
    full_p = R.rhs_full(dm, fs, 0.0, y, cb)
    torch.cuda.synchronize()
    assert _same_bits(dy_k, dy_p)
    assert _same_bits(jv_k, jv_p), _parted({"jv": jv_k}, {"jv": jv_p})
    assert bool(torch.isfinite(jv_k).all())
    assert not _rhs_parted((full_k[0], full_k[1]), (full_p[0], full_p[1]))


def test_rhs_kernels_one_launch_per_call():
    """One device launch of each RHS kernel a linearize or rhs_full call,
    none a J·v; captured in a CUDA graph, the device counters count each
    replay (the wrappers' only the capture), and a replay's dY is the
    eager call's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, v, cb, _ = _tangent_case("plain", 5)
    torch.cuda.synchronize()
    E.reset_launch_counts()
    dy, jvp = R.linearize(dm, fs, 0.0, y, cb)
    for _ in range(3):
        jvp(v)
    R.rhs_full(dm, fs, 0.0, y, cb)
    torch.cuda.synchronize()
    want = {"edge_flux": 1, "edge_coeff": 1, "edge_apply": 3,
            "tangent_cell": 1, "tangent_reach": 1, "rhs_cell": 2,
            "rhs_assemble": 2}
    assert E.device_launch_counts() == want
    assert E.launch_counts == want

    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        R.linearize(dm, fs, 0.0, y, cb)  # warm-up off the capture
        with torch.cuda.graph(graph, stream=stream):
            dy_g, _ = R.linearize(dm, fs, 0.0, y, cb)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    E.reset_launch_counts()
    for _ in range(4):
        graph.replay()
    torch.cuda.synchronize()
    n = E.device_launch_counts()
    assert (n["rhs_cell"], n["rhs_assemble"], n["edge_coeff"]) == (4, 4, 4)
    assert E.launch_counts["rhs_cell"] == E.launch_counts["rhs_assemble"] == 0
    assert _same_bits(dy_g, dy)


def test_rhs_kernels_wide_lists_match_plain_bitwise():
    """A mesh whose gather lists are wider than the order the assembly
    keeps (padded to 130 columns) stays on the RHS kernels: torch sums
    those lists between two launches of the assembly, and dY, diag and
    saved are the plain RHS's bit for bit, both edge routes and boundary
    modes; the counters give the route and the number of torch sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R
    from torch_variants import widen_lists

    dm, fs, y, _, _, _ = _tangent_case("branched", 5)
    for names in (("seg_to_ele",), ("seg_to_riv", "riv_to_down"),
                  ("seg_to_ele", "seg_to_riv", "riv_to_down")):
        wm = widen_lists(dm, names)
        E.reset_launch_counts()
        for cb in (True, False):
            for route in ("flux", "coeff"):
                c_k = None if route == "flux" else []
                c_p = None if route == "flux" else []
                got = R._rhs(wm, fs, y, cb, False, c_k)
                assert trace.counters()["shud.edge.rhs_kernels"] == 1
                assert (trace.counters()["shud.edge.rhs_torch_sums"]
                        == len(names))
                ref = R._rhs_plain(wm, fs, y, cb, False, c_p)
                torch.cuda.synchronize()
                parted = _rhs_parted(got, ref)
                assert not parted, (names, cb, route, parted)
                if c_k is not None:
                    assert all(_same_bits(a, b) for a, b in zip(c_k, c_p))
        n = E.device_launch_counts()
        assert (n["rhs_cell"], n["rhs_assemble"]) == (4, 8), names


def test_rhs_wrappers_refuse_bad_inputs():
    """A CUDA input the RHS kernels cannot take raises (no fallback): CPU
    tensors, float64, another length or shape; nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, _, cb, _ = _tangent_case("plain", 5)
    ne, ns, nr = dm.num_ele, dm.num_seg, dm.num_riv
    cell, flags, src = R._rhs_cell_inputs(dm, fs, y)
    _, diag, saved = R._rhs_plain(dm, fs, y, cb, False)
    src.update({k: diag[k] for k in diag}, gw=saved["gw"],
               q_surf=diag["q_esurf"], q_sub=diag["q_esub"])
    floats, aflags = R._rhs_assemble_inputs(dm, src)

    def swap(fields, name, t):
        return [(k, t if k == name else x, *rest)
                for k, x, *rest in fields]

    n0 = dict(E.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.rhs_cell([(k, t.cpu()) for k, t in cell],
                   [(k, t.cpu()) for k, t in flags])
    with pytest.raises(ValueError, match="float32"):
        E.rhs_cell(swap(cell, "beta", dm.beta.double()), flags)
    with pytest.raises(ValueError, match="shape"):
        E.rhs_cell(swap(cell, "theta_fc", dm.theta_fc[:-1]), flags)
    with pytest.raises(ValueError, match="int64"):
        E.rhs_cell(cell, swap(flags, "i_bc", dm.i_bc.int()))
    with pytest.raises(ValueError, match="float32"):
        E.rhs_assemble(swap(floats, "area", dm.area.double()), aflags,
                       ne, ns, nr)
    with pytest.raises(ValueError, match="shape"):
        E.rhs_assemble(swap(floats, "q_surf", diag["q_esurf"][:, :2]),
                       aflags, ne, ns, nr)
    with pytest.raises(ValueError, match="on cpu"):
        E.rhs_assemble(swap(floats, "riv_length", dm.riv_length.cpu()),
                       aflags, ne, ns, nr)
    # a list whose sum's order the kernel does not keep needs torch's sums,
    # both of a pair, each [ne] or [nr] float32
    wide = dm.lists.seg_to_ele.new_full((ne, 130), ns)
    wflags = [(k, wide if k == "seg_to_ele" else t, tuple(wide.shape)
               if k == "seg_to_ele" else n) for k, t, n in aflags]
    with pytest.raises(ValueError, match="give its sums"):
        E.rhs_assemble(floats, wflags, ne, ns, nr)
    half = [diag["q_e2r_surf"], None, None, None, None]
    with pytest.raises(ValueError, match="in part"):
        E.rhs_assemble(floats, wflags, ne, ns, nr, half)
    with pytest.raises(ValueError, match="shape"):
        E.rhs_assemble(floats, wflags, ne, ns, nr,
                       [diag["q_e2r_surf"][:-1], diag["q_e2r_sub"], None,
                        None, None])
    with pytest.raises(ValueError, match="float32"):
        E.rhs_assemble(floats, wflags, ne, ns, nr,
                       [diag["q_e2r_surf"].double(), diag["q_e2r_sub"],
                        None, None, None])
    # the kernels carry no reverse-mode derivative
    with pytest.raises(RuntimeError, match="reverse mode"):
        R.rhs(dm, fs, 0.0, y.clone().requires_grad_(True), cb)
    assert E.launch_counts == n0


def test_lake_mesh_keeps_plain_rhs(monkeypatch):
    """A mesh with a lake keeps the plain RHS on the card (no RHS kernel
    launch, the route refused), a lake-free one takes the kernels, and the
    counter shud.edge.rhs_kernels says which."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core import rhs as R

    dm, fs, y, _, cb, _ = _tangent_case("lake", 5)
    assert dm.num_lake > 0 and not R._rhs_on_kernels(dm, fs, y, False)
    E.reset_launch_counts()
    R.rhs_full(dm, fs, 0.0, y, cb)
    torch.cuda.synchronize()
    assert trace.counters()["shud.edge.rhs_kernels"] == 0
    n = E.device_launch_counts()
    assert (n["rhs_cell"], n["rhs_assemble"], n["edge_flux"]) == (0, 0, 1)
    _tangent_case("plain", 5)
    assert trace.counters()["shud.edge.rhs_kernels"] == 1


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
    """torch.func.jvp of rhs_mega is refused on the card too, naming
    linearize_mega, and launches no kernel."""
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    n0 = dict(M.launch_counts)
    with pytest.raises(RuntimeError, match="linearize_mega"):
        torch.func.jvp(lambda yy: M.rhs_mega(t, f, yy, True), (y,), (v,))
    assert M.launch_counts == n0


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
    vector, bitwise the kernels' plain versions."""
    c = mega_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    n0 = dict(M.launch_counts)
    fy, jvp = M.linearize_mega(t, f, y, True)
    jvs = [jvp(v), jvp(2.0 * v)]
    torch.cuda.synchronize()
    assert M.launch_counts["mega_rhs"] == n0["mega_rhs"] + 1
    assert M.launch_counts["mega_jvp"] == n0["mega_jvp"] + 2
    assert torch.equal(fy, M.mega_rhs_plain(t, f, y, True))
    for w, jv in zip((v, 2.0 * v), jvs):
        assert torch.equal(jv, M.mega_jvp_plain(t, f, y, w, True))


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
        # the sharded driver builds its own factors (ShardRHS._tangent)
        # and its own RHS (ShardRHS._rhs)
        assert k["launches"] == {"edge_flux": 1, "edge_coeff": 1,
                                 "edge_apply": 1, "tangent_cell": 0,
                                 "tangent_reach": 0, "rhs_cell": 0,
                                 "rhs_assemble": 0}
        assert p["launches"] == dict.fromkeys(k["launches"], 0)


@pytest.mark.parametrize("mega", (True, False))
def test_captured_window_matches_eager(mega):
    """The fused driver's intervals, each one launch of a captured CUDA
    graph (driver/fused.py IntervalGraph; WHILE and IF conditional nodes
    from csrc/graph.cu), bitwise the eager loop's after every interval,
    with equal counters; on both, the kernels' device counts equal the
    Newton iterations (krylov_m times for the tangent kernel), the
    captured run's two warm-up iterations included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    from shud_tpu_torch.core import edge
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.solver import bdf, graph
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    runs = {}
    for captured in (True, False):
        sim = FusedSimulation.create(
            "synthetic", inp=make_synthetic_project(24, 16, end_day=1.0),
            float_dtype=torch.float32, mega=mega, device="cuda",
            captured=captured)
        for k in (edge, M):
            k.reset_launch_counts()
        it0, w0 = bdf.newton_iters, graph.warmup_newton_iters
        ys = []
        for _ in range(3):
            sim.advance_interval(60.0)
            ys.append(sim.bdf.y.clone())
        torch.cuda.synchronize()
        counts = {**edge.device_launch_counts(), **M.device_launch_counts()}
        iters = bdf.newton_iters - it0 + graph.warmup_newton_iters - w0
        runs[captured] = (sim, ys, counts, iters)
    (a, ya, ca, ia), (b, yb, cb, ib) = runs[True], runs[False]
    assert a.interval is not None and a.interval.capture
    assert a.window is None and b.window is None and b.interval is None
    assert all(torch.equal(x, y) for x, y in zip(ya, yb))
    assert (a.bdf.nsteps, a.bdf.nfe, a.bdf.nfails, a.bdf.nnifails) == (
        b.bdf.nsteps, b.bdf.nfe, b.bdf.nfails, b.bdf.nnifails)
    assert ia == ib + 2 and ib > 0
    assert a.interval.stats["syncs"] == a.interval.stats["launches"] == 3
    first, tangent = (("mega_rhs", "mega_jvp") if mega
                      else ("edge_coeff", "edge_apply"))
    for n, it in ((ca, ia), (cb, ib)):
        assert n[first] == it and n[tangent] == a.cfg.krylov_m * it, n


def _same(a, b, what):
    """Two trees of tensors and host numbers equal, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    elif isinstance(a, (dict, tuple, list)):
        assert len(a) == len(b), what
        keys = list(a) if isinstance(a, dict) else range(len(a))
        if isinstance(a, dict):
            assert list(a) == list(b), what
        for k in keys:
            _same(a[k], b[k], f"{what}/{k}")
    else:
        assert a == b and type(a) is type(b), (what, a, b)


@pytest.mark.parametrize("mega", (True, False))
def test_interval_graph_matches_window_replay(mega):
    """The interval graph (one launch an interval) against the per-window
    replay (``captured="window"``) and the eager loop over three
    intervals, the last short: bitwise equal after every interval (state,
    buckets, means, stages, qdowns), the same steps, NFE and Newton
    iterations; one host sync an interval; the diagnostics kernel's device
    count the windows plus the interval graph's one warm-up window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    from shud_tpu_torch.core import edge
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.solver import bdf
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    sims = {c: FusedSimulation.create(
        "synthetic", inp=make_synthetic_project(24, 16, end_day=1.0),
        float_dtype=torch.float32, mega=mega, device="cuda", captured=c)
        for c in (True, "window", False)}
    for k in (edge, M):
        k.reset_launch_counts()
    for minutes in (60.0, 60.0, 30.0):
        outs, iters = {}, {}
        for c, sim in sims.items():
            it0, s0 = bdf.newton_iters, bdf.host_syncs
            outs[c] = sim.advance_interval(minutes)
            iters[c] = bdf.newton_iters - it0
            if c is True:
                assert bdf.host_syncs - s0 == 1
        for c in ("window", False):
            _same(outs[True], outs[c], f"outputs {c}")
            _same(tuple(sims[True].bdf), tuple(sims[c].bdf), f"bdf {c}")
            _same(tuple(sims[True].buckets), tuple(sims[c].buckets),
                  f"buckets {c}")
            assert iters[True] == iters[c] > 0
    g = sims[True].interval
    assert g.capture and g.stats["launches"] == 3 and g.stats["windows"] == 15
    assert sims["window"].window.capture and sims[False].window is None
    torch.cuda.synchronize()
    diag = "mega_diag" if mega else "edge_flux"
    counts = {**edge.device_launch_counts(), **M.device_launch_counts()}
    # the three forms' windows, and the interval graph's warm-up window
    assert counts[diag] == 3 * 15 + 1


def test_stamp_pair_times_a_sleep():
    """Two ``Stamp`` nodes around a sleep kernel in an assembled program
    (``%globaltimer`` on the device) read the sleep within 0.9-1.5 times
    CUDA events' time for the same sleep launched eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    from shud_tpu_torch.solver.graph import Program, Stamp

    dev = torch.device("cuda")
    cycles = 2 * 10**6  # ~1 ms at 1.98 GHz
    sums = torch.zeros(3, dtype=torch.int64, device=dev)
    prog = Program({"sleep": lambda: torch.cuda._sleep(cycles)},
                   (Stamp(0), "sleep", Stamp(1)), True, sums)
    prog.build(dev)
    for _ in range(3):
        sums.zero_()
        prog.launch(dev)
        torch.cuda.synchronize()
        stamped = sums[1].item() / 1e9
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        assert 0.9 <= stamped / (e0.elapsed_time(e1) / 1e3) <= 1.5
        assert sums[2].item() > 0  # the last reading, kept
    prog.close()


# mega-32k's interval graph before the stamps existed (the captured
# pieces' nodes by type, ``Program.node_counts``; an H100, torch 2.11)
MEGA_32K_NODES = {
    "init": {"kernel": 5, "copy": 1, "memset": 0, "other": 0},
    "head": {"kernel": 244, "copy": 33, "memset": 0, "other": 0},
    "begin": {"kernel": 47, "copy": 0, "memset": 0, "other": 0},
    "newton": {"kernel": 46, "copy": 0, "memset": 0, "other": 0},
    "end": {"kernel": 2, "copy": 0, "memset": 0, "other": 0},
    "tail": {"kernel": 40, "copy": 1, "memset": 0, "other": 0},
    "pack": {"kernel": 17, "copy": 2, "memset": 0, "other": 0}}


def test_interval_graph_stamps_only_when_traced():
    """mega-32k (the 128 x 128 synthetic watershed on the mega path):
    with tracing off the interval graph's pieces have the nodes they had
    before tracing existed and the program no stamp; with tracing on the
    same pieces and four stamps, whose head, solve and tail sums are
    positive and fit in the intervals' wall; off again, no stamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    import time

    from shud_tpu_torch import trace
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.solver.graph import Stamp, While
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    def stamps(nodes):
        return sum(1 if isinstance(n, Stamp) else
                   stamps(n.body) if isinstance(n, While) else 0
                   for n in nodes)

    sim = FusedSimulation.create(
        "synthetic", inp=make_synthetic_project(128, 128, end_day=1.0),
        float_dtype=torch.float32, device="cuda")
    assert sim.mega is not None
    trace.disable()
    sim.advance_interval(60.0)
    g = sim.interval
    assert g.program.node_counts() == MEGA_32K_NODES
    assert stamps(g.program.nodes) == 0 and g.phases() is None
    trace.enable()
    try:
        sim.advance_interval(60.0)
        g = sim.interval
        assert g.program.node_counts() == MEGA_32K_NODES
        assert stamps(g.program.nodes) == 4
        g.reset_phases()
        t0 = time.perf_counter()
        for _ in range(2):
            sim.advance_interval(60.0)
        wall = time.perf_counter() - t0
        ph = g.phases()
        assert all(v > 0 for v in ph.values())
        assert sum(ph.values()) / 1e9 <= wall
    finally:
        trace.disable()
    sim.advance_interval(60.0)
    assert stamps(sim.interval.program.nodes) == 0


def test_mega_lake_clock_only_when_traced():
    """Stage C's clock (``mega.lake_stage_ns``) on a basin of three
    lakes: with tracing off no clock is passed and it stays zero; with it
    on, each kernel's calls add to its own row only, every lake's entry
    grows, and each output is bitwise the one made without the clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.state import ForcingSlice
    from shud_tpu_torch.io import project
    from portbench import gen
    from torch_variants import THREE_LAKES, lake_basin, mega_inputs

    raw, _, _ = lake_basin(lakes=THREE_LAKES)
    md = build_mesh(gen.to_input(raw, project, "."))
    dev = torch.device("cuda")
    t = M.build_mega_tables(md).to(dev)
    fs, y, v = mega_inputs(md, seed=9)
    f = M.pack_forcing(t, ForcingSlice(
        **{k: torch.as_tensor(a, device=dev) for k, a in fs.items()}))
    y, v = torch.as_tensor(y, device=dev), torch.as_tensor(v, device=dev)
    calls = {"mega_rhs": lambda: M.mega_rhs(t, f, y, True),
             "mega_jvp": lambda: M.mega_jvp(t, f, y, v, True),
             "mega_diag": lambda: M.mega_diag(t, f, y, True)}
    reps = 50  # each call's stage C is a fraction of a microsecond here
    trace.disable()
    try:
        off = {k: [c() for _ in range(reps)] for k, c in calls.items()}
        assert t.nl == 3
        assert M.lake_stage_ns(t) == {k: [0] * 3 for k in calls}
        trace.enable()
        for name, call in calls.items():
            M.reset_lake_stage(t)
            on = [call() for _ in range(reps)]
            ns = M.lake_stage_ns(t)
            assert all(x > 0 for x in ns[name]), ns
            assert all(x == 0 for k in calls if k != name for x in ns[k])
            for a, b in zip(on, off[name]):
                assert torch.equal(a, b)
    finally:
        trace.disable()


def test_interval_graph_lake_clock_only_when_traced():
    """The benchmark's program on the three-lake basin: an interval graph
    built with tracing on carries stage C's clock in its mega kernels
    (each kernel's row grows over a replay), one built with it off does
    not, and the two replays' results are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import mega as M
    from portbench.program import Program
    from torch_variants import THREE_LAKES, lake_basin

    raw, cfg, traffic = lake_basin(lakes=THREE_LAKES)
    prog = Program(raw, cfg, dict(traffic, end_min=840.0), "cuda", "build")
    t = prog.sim.mega
    prog.snapshot()
    trace.disable()
    try:
        replays = {}
        for traced in (False, True, False):
            (trace.enable if traced else trace.disable)()
            prog.restore()
            prog.interval()  # builds the graph of this key
            prog.restore()
            M.reset_lake_stage(t)
            replays.setdefault(traced, []).append(
                [prog.interval() for _ in range(prog.n_intervals)])
            ns = M.lake_stage_ns(t)
            grew = [all(x > 0 for x in ns[k]) for k in ns]
            assert grew == [traced] * 3, (traced, ns)
    finally:
        trace.disable()
        prog.close()
    for a, b in zip(replays[True][0], replays[False][0]):
        for k in ("y", "q_riv_down"):
            assert np.array_equal(a[k], b[k]), k
    for a, b in zip(replays[False][0], replays[False][1]):
        assert np.array_equal(a["y"], b["y"])


@pytest.fixture(scope="module", params=tuple(STAGE_C_BASINS))
def stage_c_case(request):
    """A basin of ``torch_variants.STAGE_C_BASINS`` on the card: its mega
    tables, a packed forcing, a state and a tangent (``mega_inputs``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.state import ForcingSlice
    from shud_tpu_torch.io import project
    from portbench import gen
    from torch_variants import lake_basin, mega_inputs

    kwargs, nl, kel, _ = STAGE_C_BASINS[request.param]
    raw, _, _ = lake_basin(**kwargs)
    md = build_mesh(gen.to_input(raw, project, "."))
    dev = torch.device("cuda")
    t = M.build_mega_tables(md).to(dev)
    assert (t.nl, t.edge_to_lake.shape[1]) == (nl, kel)
    fs, y, v = mega_inputs(md, seed=9)
    f = M.pack_forcing(t, ForcingSlice(
        **{k: torch.as_tensor(a, device=dev) for k, a in fs.items()}))
    return dict(M=M, name=request.param, tables=t, forcing=f,
                y=torch.as_tensor(y, device=dev),
                v=torch.as_tensor(v, device=dev))


@pytest.mark.parametrize("cb", (True, False))
def test_mega_stage_c_matches_plain_bitwise(stage_c_case, cb):
    """Stage C a block per lake, its lists gathered 128 entries a round
    and summed in list order: the RHS, J·v and diagnostics bitwise their
    plain versions on lake basins whose widest bank-edge list lies inside
    one round, on a round's boundary and across two and three rounds
    (reaches flowing into the lake among them), with lakes of unequal
    widths in one launch, and with more lakes than the grid has blocks."""
    c = stage_c_case
    M, t, f, y, v = c["M"], c["tables"], c["forcing"], c["y"], c["v"]
    outs = (M.mega_rhs(t, f, y, cb), M.mega_jvp(t, f, y, v, cb),
            M.mega_diag(t, f, y, cb))
    plain = (M.mega_rhs_plain(t, f, y, cb), M.mega_jvp_plain(t, f, y, v, cb),
             M.mega_diag_plain(t, f, y, cb))
    torch.cuda.synchronize()
    grid = t._launch.dims["mega_rhs", cb][11]
    assert (grid < t.nl) == (c["name"] == "seven")  # the block stride runs
    for name, a, b in zip(("mega_rhs", "mega_jvp", "mega_diag"), outs, plain):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("with_lake", (False, True))
def test_split_graph_matches_eager_loop(with_lake):
    """The -g driver's window on the card: each window's sweep (five
    sub-solves on the hand linearizations, the window's values) one launch
    of a captured SplitGraph, bitwise the eager loop (``sweep_window``)
    over 3 storm windows in every sub-state, its scalars and the fetched
    values; one graph launch and one host read a window; no kernel of the
    six runs (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs)")
    from torch_variants import make_project

    from shud_tpu_torch.core import edge
    from shud_tpu_torch.core import mega as M
    from shud_tpu_torch.driver import uncoupled as U
    from shud_tpu_torch.driver.simulate import Simulation
    from shud_tpu_torch.solver import bdf

    inp = make_project("torch", "lake" if with_lake else "plain", 24, 16, 1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]  # the storm
    inp.control.day_start = 0.5
    sim = Simulation.create("synthetic", inp=inp, float_dtype=torch.float64,
                            device="cuda")
    ne, nr, nl = sim.md.num_ele, sim.md.num_riv, sim.md.num_lake
    y0 = sim.bdf.y.clone()
    y0[:ne] = torch.as_tensor(
        np.random.default_rng(0).uniform(0.0, 1e-3, ne), device="cuda")
    ua = ub = U.init_uncoupled(y0, ne, nr, sim.t, sim.cfg, nl=nl)
    g = U.SplitGraph(sim.dm, sim.cfg)
    for k in (edge, M):
        k.reset_launch_counts()
    t = sim.t
    for w in range(3):
        tout = t + 10.0
        fs, cf = sim.forcing_slice(tout)
        ua, ha = U.sweep_window(sim.dm, fs, cf, sim.buckets, ua, t, tout,
                                sim.cfg)
        s0 = bdf.host_syncs
        ub, hb = g.sweep(fs, cf, sim.buckets, ub, t, tout)
        assert bdf.host_syncs - s0 == 1
        t = tout
        for part in U.PARTS:
            a, b = getattr(ua, part), getattr(ub, part)
            assert (a is None) == (b is None), part
            if a is not None:
                _same(tuple(a), tuple(b), f"window {w} {part}")
        _same(ha, hb, f"window {w} values")
    assert (ub.lake is not None) == with_lake and ub.surf.nsteps > 3
    assert g.capture and g.stats["launches"] == g.stats["syncs"] == 3
    torch.cuda.synchronize()
    counts = {**edge.device_launch_counts(), **M.device_launch_counts()}
    assert not any(counts.values()), counts


def _solver_counts():
    from shud_tpu_torch.solver import kernels as K

    torch.cuda.synchronize()
    return K.device_launch_counts()


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("n", (32768, 131072, 98433, 3))
def test_solver_kernels_match_plain(n, dtype):
    """The solver's four kernels (csrc/bdf.cu) against their plain
    versions on the same inputs (tests/torch_variants.solver_kernel_cases:
    every branch of each, the last column at every m = 1..8, S2 and S3 on
    views one entry in), bitwise; each call one device launch of its
    kernel and of no other; a whole Newton update (m = 3) through them
    bitwise its plain route, with 10 axpy and 4 column launches.  S2 and
    S3 take 16 bytes of entries a thread (a tail where n is no multiple of
    it), one entry a thread on the views and below 16 bytes' worth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torch_variants import solver_kernel_cases

    from shud_tpu_torch.solver import kernels as K

    narrow_n = n < 16 // (torch.finfo(dtype).bits // 8)
    for case in solver_kernel_cases(n, dtype, "cuda", seed=n):
        name, label = case.name, case.label
        K.reset_launch_counts()
        before = _solver_counts()
        got = case.run(True)
        forms = {k: dict(v) for k, v in K.form_counts.items()}
        hosts = dict(K.launch_counts)
        after = _solver_counts()
        want = case.run(False)
        delta = {k: after[k] - before[k] for k in after}
        expect = ({"krylov_axpy": 10, "krylov_column": 4}
                  if name == "newton_update" else {name: 1})
        assert delta == {k: expect.get(k, 0) for k in delta}, (label, delta)
        assert hosts == delta, (label, hosts)
        narrow = narrow_n or "offset" in label
        for k, forms_k in forms.items():
            runs = expect.get(k, 0)
            assert forms_k == {"wide": 0 if narrow else runs,
                               "one": runs if narrow else 0}, (label, forms)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), (name, label, k)


def test_solver_kernels_refuse_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shud_tpu_torch.solver import kernels as K

    x = torch.zeros(64, device="cuda")
    k = torch.ones((), device="cuda")
    with pytest.raises(ValueError):
        K.krylov_axpy(K.MATVEC, k, x, torch.zeros(63, device="cuda"), x)
    with pytest.raises(ValueError):
        K.krylov_axpy(K.MATVEC, k, x, x.double(), x)
    with pytest.raises(ValueError):
        K.Scratch(x, K.MAX_KRYLOV + 1)
    with pytest.raises(ValueError):
        K.Scratch(x.half(), 3)


@pytest.mark.parametrize("mega", (True, False))
def test_solver_kernels_match_torch_pieces(mega):
    """The fused driver's intervals on the solver kernels (an interval
    graph) bitwise the eager loop on the solver's torch pieces
    (``solver_kernel=False``) after every interval, with equal steps, NFE
    and Newton iterations; the kernels' device counts: per step one
    bdf_begin and one step end, per Newton iteration one Newton tail,
    1 + m + m(m+1)/2 axpy and m + 1 column launches (the graph's warm-up:
    one step, two iterations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels)")
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.solver import bdf
    from shud_tpu_torch.solver import kernels as K
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    sims = {k: FusedSimulation.create(
        "synthetic", inp=make_synthetic_project(24, 16, end_day=1.0),
        float_dtype=torch.float32, mega=mega, device="cuda",
        captured=k, solver_kernel=k) for k in (True, False)}
    K.reset_launch_counts()
    iters = dict.fromkeys(sims, 0)
    for minutes in (60.0, 60.0, 30.0):
        outs = {}
        for k, sim in sims.items():
            it0 = bdf.newton_iters
            outs[k] = sim.advance_interval(minutes)
            iters[k] += bdf.newton_iters - it0
        _same(outs[True], outs[False], "outputs")
        _same(tuple(sims[True].bdf), tuple(sims[False].bdf), "bdf")
        assert iters[True] == iters[False] > 0
    counts = _solver_counts()
    m, steps, it = sims[True].cfg.krylov_m, sims[True].bdf.nsteps + 1, \
        iters[True] + 2
    assert counts == {"bdf_begin": steps, "krylov_axpy":
                      (1 + m + m * (m + 1) // 2) * it,
                      "krylov_column": (m + 1) * it,
                      "bdf_finish": it + steps}, counts


def test_split_graph_solver_kernels_match_torch_pieces():
    """The -g driver's window on the card with the solver kernels (a
    SplitGraph, five scratches) bitwise the eager loop on the torch
    pieces (``sweep_window(solver_kernel=False)``) over 3 storm windows on
    the lake mesh (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs)")
    from torch_variants import make_project

    from shud_tpu_torch.driver import uncoupled as U
    from shud_tpu_torch.driver.simulate import Simulation

    inp = make_project("torch", "lake", 24, 16, 1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]  # the storm
    inp.control.day_start = 0.5
    sim = Simulation.create("synthetic", inp=inp, float_dtype=torch.float64,
                            device="cuda")
    ne, nr, nl = sim.md.num_ele, sim.md.num_riv, sim.md.num_lake
    ua = ub = U.init_uncoupled(sim.bdf.y, ne, nr, sim.t, sim.cfg, nl=nl)
    g = U.SplitGraph(sim.dm, sim.cfg)
    t = sim.t
    for w in range(3):
        tout = t + 10.0
        fs, cf = sim.forcing_slice(tout)
        ua, ha = U.sweep_window(sim.dm, fs, cf, sim.buckets, ua, t, tout,
                                sim.cfg, solver_kernel=False)
        ub, hb = g.sweep(fs, cf, sim.buckets, ub, t, tout)
        t = tout
        for part in U.PARTS:
            _same(tuple(getattr(ua, part)), tuple(getattr(ub, part)),
                  f"window {w} {part}")
        _same(ha, hb, f"window {w} values")
    assert g.capture and all(
        sp.scratch is not None for sp in g.pieces.solvers.values())
