"""The port's RHS (core/rhs.py) against the JAX package's ``rhs_full``.

Same mesh, forcing slice and state (numpy, from a seed) through both.  f64:
dY and every diagnostic within scaled 1e-12 (the bar core/rhs.py met
against the C++ oracle); f32: scaled 2e-5.  Tangents: torch.func.jvp vs
jax.jvp in f64 within scaled 1e-10 on states off the flux laws' ties.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.core import rhs as JR  # noqa: E402
from shud_tpu.core.device import to_device  # noqa: E402
from shud_tpu.core.state import ForcingSlice as JFS  # noqa: E402
from shud_tpu_torch.core import rhs as TR  # noqa: E402
from shud_tpu_torch.core.device import to_torch  # noqa: E402
from shud_tpu_torch.core.state import ForcingSlice as TFS  # noqa: E402
from torch_variants import (VARIANTS, meshes, random_inputs,  # noqa: E402
                            scaled_err, widen_lists)

DTYPES = {"f64": (jnp.float64, torch.float64, 1e-12),
          "f32": (jnp.float32, torch.float32, 2e-5)}


def _both(variant, prec, exact_parity=False):
    jd, td, _ = DTYPES[prec]
    md_j, md_t, cb = meshes(variant)
    fs, y = random_inputs(md_j)
    out_j = JR.rhs_full(to_device(md_j, jd),
                        JFS(**{k: jnp.asarray(v, jd) for k, v in fs.items()}),
                        0.0, jnp.asarray(y, jd), close_boundary=cb,
                        exact_parity=exact_parity)
    out_t = TR.rhs_full(to_torch(md_t, td, "cpu"),
                        TFS(**{k: torch.tensor(v, dtype=td)
                               for k, v in fs.items()}),
                        0.0, torch.tensor(y, dtype=td), close_boundary=cb,
                        exact_parity=exact_parity)
    return out_j, out_t


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_rhs_full_matches(variant, prec):
    bar = DTYPES[prec][2]
    (dy_j, dg_j), (dy_t, dg_t) = _both(variant, prec)
    assert dy_t.dtype == DTYPES[prec][1]
    assert scaled_err(dy_j, dy_t.numpy()) <= bar
    assert set(dg_j) == set(dg_t)
    for k in dg_j:
        assert tuple(dg_j[k].shape) == tuple(dg_t[k].shape), k
        assert scaled_err(dg_j[k], dg_t[k].numpy()) <= bar, k


@pytest.mark.parametrize("variant", ("plain", "lake"))
def test_rhs_exact_parity_matches(variant):
    (dy_j, dg_j), (dy_t, dg_t) = _both(variant, "f64", exact_parity=True)
    assert scaled_err(dy_j, dy_t.numpy()) <= 1e-12
    for k in dg_j:
        assert scaled_err(dg_j[k], dg_t[k].numpy()) <= 1e-12, k


@pytest.mark.parametrize("variant", VARIANTS)
def test_rhs_jvp_matches_f64(variant):
    md_j, md_t, cb = meshes(variant)
    fs, y = random_inputs(md_j, seed=3)
    v = np.random.default_rng(4).standard_normal(y.shape[0])
    dm_j = to_device(md_j, jnp.float64)
    fs_j = JFS(**{k: jnp.asarray(a) for k, a in fs.items()})
    dm_t = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(a) for k, a in fs.items()})
    _, tj = jax.jvp(lambda yy: JR.rhs(dm_j, fs_j, 0.0, yy, cb),
                    (jnp.asarray(y),), (jnp.asarray(v),))
    _, tt = torch.func.jvp(lambda yy: TR.rhs(dm_t, fs_t, 0.0, yy, cb),
                           (torch.tensor(y),), (torch.tensor(v),))
    assert scaled_err(tj, tt.numpy()) <= 1e-10


@pytest.mark.parametrize("et_mode", (0, 1, 2))
def test_forcing_chain_matches_f64(et_mode):
    """TSR factor -> cell forcing/PET -> snow/interception bucket, one
    forcing interval, for each PET formula, against the JAX functions."""
    from shud_tpu.core import landsurface as JL
    from shud_tpu.core import solar as JS
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.driver.forcing import build_forcing as jax_forcing
    from shud_tpu_torch.core import landsurface as TL
    from shud_tpu_torch.core import solar as TS
    from shud_tpu_torch.core.mesh import build_mesh as torch_build
    from shud_tpu_torch.driver.forcing import build_forcing as torch_forcing
    from torch_variants import make_project

    out = {}
    for pkg in ("jax", "torch"):
        inp = make_project(pkg, "lake")
        inp.control.et_mode = et_mode
        if pkg == "jax":
            md = jax_build(inp)
            fr = jax_forcing(inp, md)
            m = to_device(md, jnp.float64)
            arr, sol, land = jnp.asarray, JS, JL
        else:
            md = torch_build(inp)
            fr = torch_forcing(inp, md)
            m = to_torch(md, torch.float64, "cpu")
            arr, sol, land = torch.as_tensor, TS, TL
        k = 1  # the storm day
        fac = sol.tsr_factor(m.nx, m.ny, m.nz, *(arr(a[k]) for a in (
            fr.tsr_sx, fr.tsr_sy, fr.tsr_sz, fr.tsr_wdt, fr.tsr_den)),
            fr.rad_factor_cap, fr.rad_cosz_min)
        cf = land.cell_forcing(m, arr(fr.fvals[k]), arr(fr.station_z),
                               arr(fr.lai_vals[0]), arr(fr.mf_vals[0]), fac,
                               fr.cal, et_mode=et_mode)
        ne = md.num_ele
        rng = np.random.default_rng(6)
        bk = land.BucketState(ic_stg=arr(rng.uniform(0, 1e-4, ne)),
                              snow=arr(rng.uniform(0, 1e-2, ne)))
        bo = land.et_bucket_step(m, cf, bk, 10.0, fr.cal.c_ismax)
        out[pkg] = dict(cf._asdict(), ic=bo.state.ic_stg, snow=bo.state.snow,
                        net_prcp=bo.net_prcp, e_ic=bo.e_ic, sn_frac=bo.sn_frac)
    for key, a in out["jax"].items():
        assert scaled_err(a, out["torch"][key].numpy()) <= 1e-12, key


LIN_VARIANTS = ("plain", "open", "lake", "bc", "branched", "ties")


def _lin_case(variant, seed=8):
    """(jax mesh, torch mesh, close_boundary, forcing dict, state, tangent)
    for a linearize variant: non-unit frozen fractions everywhere, BC flags
    and values on "bc" (tests/torch_variants.with_bc), and on "ties" the
    lake mesh in the state of ``mega_inputs``: dry cells, empty
    unsaturated layers, water tables at the surface, empty reaches."""
    from torch_variants import mega_inputs, with_bc

    base = {"bc": "plain", "ties": "lake"}.get(variant, variant)
    md_j, md_t, cb = meshes(base)
    if variant == "bc":
        md_j, md_t = with_bc(md_j), with_bc(md_t)
    fs, y = random_inputs(md_j, seed=seed)
    if variant == "ties":
        y = mega_inputs(md_j, seed)[1].astype(np.float64)
    rng = np.random.default_rng(seed + 1)
    ne, nr = md_j.num_ele, md_j.num_riv
    fs["fu_surf"] = rng.uniform(0.3, 1.0, ne)
    fs["fu_sub"] = rng.uniform(0.3, 1.0, ne)
    if variant == "bc":
        fs.update(ele_ybc=rng.uniform(0.5, 3.0, ne),
                  ele_qbc=rng.normal(0.0, 1e-3, ne),
                  ele_qss=rng.normal(0.0, 1e-3, ne),
                  riv_ybc=rng.uniform(0.05, 1.0, nr),
                  riv_qbc=rng.uniform(0.0, 1e-2, nr))
    v = rng.standard_normal(y.shape[0])
    return md_j, md_t, cb, fs, y, v


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("variant", LIN_VARIANTS)
def test_linearize_matches_jvp(variant, prec):
    """rhs.linearize, the solver's once-per-Newton-iteration hook: its dY
    is rhs's bitwise, and its J·v equals torch.func.jvp of rhs (scaled
    1e-12 in f64, 2e-6 in f32) and, in f64, jax.jvp of the JAX package's
    rhs (scaled 1e-12), with no torch.func in the J·v."""
    md_j, md_t, cb, fs, y, v = _lin_case(variant)
    td = DTYPES[prec][1]
    dm = to_torch(md_t, td, "cpu")
    fs_t = TFS(**{k: torch.tensor(a, dtype=td) for k, a in fs.items()})
    yt, vt = torch.tensor(y, dtype=td), torch.tensor(v, dtype=td)
    dy, jvp = TR.linearize(dm, fs_t, 0.0, yt, cb)
    assert torch.equal(dy, TR.rhs(dm, fs_t, 0.0, yt, cb))
    ref = torch.func.jvp(lambda yy: TR.rhs(dm, fs_t, 0.0, yy, cb), (yt,),
                         (vt,))[1]
    got = jvp(vt)
    assert got.dtype == td and bool(torch.isfinite(got).all())
    assert scaled_err(ref.numpy(), got.numpy()) <= (
        1e-12 if prec == "f64" else 2e-6)
    if prec == "f64":
        dm_j = to_device(md_j, jnp.float64)
        fs_j = JFS(**{k: jnp.asarray(a) for k, a in fs.items()})
        _, tj = jax.jvp(lambda yy: JR.rhs(dm_j, fs_j, 0.0, yy, cb),
                        (jnp.asarray(y),), (jnp.asarray(v),))
        assert scaled_err(tj, got.numpy()) <= 1e-12


def test_linearize_refuses_exact_parity():
    md_j, md_t, cb, fs, y, _ = _lin_case("plain")
    dm = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(a) for k, a in fs.items()})
    with pytest.raises(ValueError, match="exact_parity"):
        TR.linearize(dm, fs_t, 0.0, torch.tensor(y), cb, exact_parity=True)


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("variant", ("bc", "ties", "branched"))
def test_tangent_takes_plain_route_off_the_card(variant, prec, monkeypatch):
    """On the CPU, in float32 and float64, ``_tangent`` builds its factors
    with the plain version (``_tangent_factors``): the kernel route is not
    reached and no kernel is counted.  The route's inputs
    (``_tangent_kernel_inputs``) are what the kernels' wrappers take:
    each 1-D, contiguous, of its length and dtype, on one device."""
    from shud_tpu_torch.core import edge as E

    md_j, md_t, cb, fs, y, v = _lin_case(variant)
    td = DTYPES[prec][1]
    dm = to_torch(md_t, td, "cpu")
    fs_t = TFS(**{k: torch.tensor(a, dtype=td) for k, a in fs.items()})
    yt, vt = torch.tensor(y, dtype=td), torch.tensor(v, dtype=td)

    def refuse(*args):
        raise AssertionError("the kernel route on the CPU")

    monkeypatch.setattr(TR, "_tangent_factors_kernel", refuse)
    E.reset_launch_counts()
    _, jvp = TR.linearize(dm, fs_t, 0.0, yt, cb)
    got = jvp(vt)
    assert set(E.launch_counts.values()) == {0}
    ref = torch.func.jvp(lambda yy: TR.rhs(dm, fs_t, 0.0, yy, cb), (yt,),
                         (vt,))[1]
    assert scaled_err(ref.numpy(), got.numpy()) <= (
        1e-12 if prec == "f64" else 2e-6)

    _, _, saved = TR._rhs(dm, fs_t, yt, cb, False, [])
    cell, flags, get = TR._tangent_cell_inputs(dm, fs_t, saved)
    ne = dm.num_ele
    assert [k for k, _ in cell] == list(TR._TANGENT_CELL_FIELDS)
    E._check_fields([(k, t, ne) for k, t in cell], td, yt.device)
    E._check_fields([(k, t, ne) for k, t in flags], torch.int64, yt.device)
    rows = dict.fromkeys(TR._TANGENT_CELL_OUT, torch.zeros(ne, dtype=td))
    floats, reach_flags = TR._tangent_reach_inputs(dm, get, rows)
    assert [k for k, *_ in floats] == [
        k for group in TR._TANGENT_REACH_FIELDS for k in group]
    E._check_fields(floats, td, yt.device)
    E._check_fields(reach_flags, torch.int64, yt.device)
    assert set(TR._tangent_factors(dm, fs_t, saved)) == set(TR._FACTORS)


def _vertical_fluxes(m, fs, sf, us, gw):
    """The cell's vertical fluxes as ``_rhs`` computes them (lake cells
    0), and its cell update: what ``_vertical_lin`` and
    ``_cell_update_lin`` differentiate."""
    cu = TR.update_element(m, sf, us, gw)
    if m.num_lake > 0:
        cu = TR.lake_cell_update(m, cu)
    es, eu, eg, tu, tg, _, _ = TR.et_flux(m, fs, sf, us, gw, cu.satn)
    qi, qex = TR.flux_infiltration(m, cu, sf, us, gw, fs.net_prcp)
    out = dict(qi=qi * fs.fu_surf, qx=qex * fs.fu_surf,
               qr=TR.flux_recharge(m, cu, us, gw) * fs.fu_sub,
               es=es, eu=eu, eg=eg, tu=tu, tg=tg)
    if m.num_lake > 0:
        out = {k: torch.where(m.i_lake > 0, 0.0, a) for k, a in out.items()}
    return out, cu


@pytest.mark.parametrize("variant", ("plain", "lake"))
def test_split_driver_cell_factors_unchanged(variant):
    """``_cell_update_lin`` and ``_vertical_lin``, which the -g driver
    (``driver/uncoupled.py``) calls itself in float64, keep their
    signatures and give each partial derivative of the cell update and of
    the vertical fluxes: torch.func.jvp along each of sf, us, gw, scaled
    1e-12 (cell-local, so a unit tangent gives every cell's partial)."""
    import inspect

    assert list(inspect.signature(TR._cell_update_lin).parameters) == [
        "m", "sf", "us", "gw"]
    assert list(inspect.signature(TR._vertical_lin).parameters) == [
        "m", "fs", "sf", "us", "gw", "cu", "ibeta", "c"]
    md_j, md_t, cb, fs, y, _ = _lin_case(variant)
    dm = to_torch(md_t, torch.float64, "cpu")
    fs_t = TFS(**{k: torch.tensor(a) for k, a in fs.items()})
    ne = dm.num_ele
    yt = torch.tensor(y)
    sf, us, gw = yt[:ne], yt[ne:2 * ne], yt[2 * ne:3 * ne]
    cu = TR.update_element(dm, sf, us, gw)
    if dm.num_lake > 0:
        cu = TR.lake_cell_update(dm, cu)
    ibeta = TR.et_flux(dm, fs_t, sf, us, gw, cu.satn)[-1]
    c = TR._cell_update_lin(dm, sf, us, gw)
    vl = TR._vertical_lin(dm, fs_t, sf, us, gw, cu, ibeta, c)
    one, zero = torch.ones_like(sf), torch.zeros_like(sf)
    cell_keys = {"eff_kh": "kh", "deficit": "def", "satn": "sn",
                 "sat_kr": "kr", "theta": "th"}
    for x, t in (("sf", (one, zero, zero)), ("us", (zero, one, zero)),
                 ("gw", (zero, zero, one))):
        (fl, cut), (tfl, tcu) = torch.func.jvp(
            lambda a, b, g: _vertical_fluxes(dm, fs_t, a, b, g),
            (sf, us, gw), t)
        for k, d in tfl.items():
            assert scaled_err(d.numpy(), vl[k][x].numpy()) <= 1e-12, (k, x)
        for field, key in cell_keys.items():
            name = f"{key}_{x}"
            if name in c:
                assert scaled_err(getattr(tcu, field).numpy(),
                                  c[name].numpy()) <= 1e-12, name
            else:
                assert not bool(getattr(tcu, field).abs().max()), name


def _rhs_outputs():
    """Every row the RHS kernels write, by name, and the edge kernel's
    q_esurf beside the assembly's q_esub."""
    return (set(TR._RHS_CELL_OUT) | set(TR._RHS_CELL_SUMS)
            | set(TR._RHS_SEG_OUT) | set(TR._RHS_RIV_OUT)
            | {"q_esurf", "q_esub"})


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("variant", ("bc", "branched", "ties"))
def test_rhs_takes_plain_route_off_the_card(variant, prec, monkeypatch):
    """On the CPU, in float32 and float64, ``_rhs`` is its plain version:
    the kernel route is not reached, no kernel is counted, and the mesh's
    set-up counter says so.  The kernels' rows name exactly what the plain
    RHS puts in ``diag`` and ``saved`` apart from the lakes, the state's
    slices and the cell update (whose fields are rows too)."""
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import edge as E

    md_j, md_t, cb, fs, y, v = _lin_case(variant)
    td = DTYPES[prec][1]
    dm = to_torch(md_t, td, "cpu")
    fs_t = TFS(**{k: torch.tensor(a, dtype=td) for k, a in fs.items()})
    yt = torch.tensor(y, dtype=td)

    def refuse(*args):
        raise AssertionError("the RHS kernel route on the CPU")

    monkeypatch.setattr(TR, "_rhs_kernels", refuse)
    assert not TR._rhs_on_kernels(dm, fs_t, yt, False)
    E.reset_launch_counts()
    dy, jvp = TR.linearize(dm, fs_t, 0.0, yt, cb)
    jvp(torch.tensor(v, dtype=td))
    dy_f, diag = TR.rhs_full(dm, fs_t, 0.0, yt, cb)
    assert trace.counters()["shud.edge.rhs_kernels"] == 0
    assert set(E.launch_counts.values()) == {0}
    assert torch.equal(dy, dy_f)
    _, _, saved = TR._rhs_plain(dm, fs_t, yt, cb, False)
    lakes = {k for k in (*diag, *saved) if "lake" in k}
    plain = (set(diag) | set(saved)) - lakes - {"sf", "us", "cu"}
    assert plain | set(TR.CellUpdate._fields) == _rhs_outputs()
    assert set(TR.CellUpdate._fields) <= set(TR._RHS_CELL_OUT)


def _fake_rhs_kernels(m, fs, y, cb, calls=None):
    """CPU stand-ins for ``edge.rhs_cell`` and ``edge.rhs_assemble``: each
    checks its inputs as the wrapper does (names, dtypes, shapes) and
    returns ``_rhs_plain``'s values in the kernel's layout.  The assembly
    also checks that it is given torch's sums exactly of the lists
    outside ``edge.sum_in_order``, equal to ``_rhs_plain``'s, and counts
    its launches, first (pre) and proper, in *calls*."""
    from shud_tpu_torch.core import edge as E
    from shud_tpu_torch.core.device import gather_sum

    dy, diag, saved = TR._rhs_plain(m, fs, y, cb, False)
    vals = {**diag, **saved, **saved["cu"]._asdict()}
    ne = m.num_ele
    calls = {} if calls is None else calls

    def cell(floats, flags):
        assert [k for k, _ in floats] == list(TR._RHS_CELL_FIELDS)
        assert [k for k, _ in flags] == ["i_bc"]
        E._check_fields([(k, t, ne) for k, t in floats], y.dtype, y.device)
        E._check_fields([(k, t, ne) for k, t in flags], torch.int64,
                        y.device)
        return torch.stack([vals[k] for k in TR._RHS_CELL_OUT])

    def assemble(floats, flags, ne_, ns, nr, given=None, pre=False):
        assert (ne_, ns, nr) == (ne, m.num_seg, m.num_riv)
        assert [k for k, *_ in floats] == [
            k for group in TR._RHS_ASSEMBLE_FIELDS for k in group]
        assert [k for k, *_ in flags] == [
            k for group in TR._RHS_ASSEMBLE_FLAGS for k in group]
        E._check_fields(floats, y.dtype, y.device)
        E._check_fields(flags, torch.int64, y.device)
        calls["pre" if pre else "assemble"] = calls.get(
            "pre" if pre else "assemble", 0) + 1
        rows = torch.cat([vals[k] for k in TR._RHS_CELL_SUMS
                          + TR._RHS_SEG_OUT + TR._RHS_RIV_OUT])
        if pre:
            return None, None, rows
        given = [None] * 5 if given is None else given
        for (k, row, neg), t in zip(TR._RHS_GIVEN, given):
            lst = getattr(m.lists, k)
            assert (t is None) == E.sum_in_order(lst), k
            if t is not None:
                want = gather_sum(-vals[row] if neg else vals[row], lst)
                assert torch.equal(t, want), (k, row)
        return dy.clone(), vals["q_esub"].clone(), rows

    return cell, assemble


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("variant", ("bc", "branched"))
def test_rhs_kernel_route_keeps_plain_layout(variant, prec, monkeypatch):
    """``_rhs_kernels`` with the two RHS kernels replaced by CPU
    stand-ins that return the plain values in the kernels' layout: the
    inputs it hands them resolve to the state, forcing, mesh, cell rows
    and edge fluxes of the right dtype and shape, and it returns dY,
    ``diag``, ``saved`` and the edge coefficients equal to
    ``_rhs_plain``'s, key for key, through both edge routes."""
    from shud_tpu_torch.core import edge as E

    md_j, md_t, cb, fs, y, _ = _lin_case(variant)
    td = DTYPES[prec][1]
    dm = to_torch(md_t, td, "cpu")
    fs_t = TFS(**{k: torch.tensor(a, dtype=td) for k, a in fs.items()})
    yt = torch.tensor(y, dtype=td)
    cell, assemble = _fake_rhs_kernels(dm, fs_t, yt, cb)
    monkeypatch.setattr(E, "rhs_cell", cell)
    monkeypatch.setattr(E, "rhs_assemble", assemble)
    for coeffs in (None, []):
        ref_c = None if coeffs is None else []
        got = TR._rhs_kernels(dm, fs_t, yt, cb, coeffs)
        ref = TR._rhs_plain(dm, fs_t, yt, cb, False, ref_c)
        assert torch.equal(got[0], ref[0])
        for g, r in zip(got[1:], ref[1:]):
            assert set(g) == set(r)
            for k in r:
                a, b = (tuple(x) if k == "cu" else (x,)
                        for x in (g[k], r[k]))
                assert all(torch.equal(p, q) for p, q in zip(a, b)), k
        if coeffs is not None:
            assert len(coeffs) == len(ref_c) == 6
            assert all(torch.equal(p, q) for p, q in zip(coeffs, ref_c))


@pytest.mark.parametrize("prec", sorted(DTYPES))
@pytest.mark.parametrize("names", (("seg_to_ele",),
                                   ("seg_to_riv", "riv_to_down")))
def test_rhs_kernel_route_sums_wide_lists_in_torch(names, prec,
                                                   monkeypatch):
    """A gather list wider than the order the assembly keeps (130 columns)
    keeps the kernel route: ``_rhs_kernels`` launches the assembly twice
    (first the rows its sums read), hands it torch's sums of exactly those
    lists, states how many in ``shud.edge.rhs_torch_sums``, and returns
    ``_rhs_plain``'s values key for key."""
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import edge as E

    md_j, md_t, cb, fs, y, _ = _lin_case("branched")
    td = DTYPES[prec][1]
    dm = widen_lists(to_torch(md_t, td, "cpu"), names)
    assert [E.sum_in_order(getattr(dm.lists, k)) for k in names] == [
        False] * len(names)
    fs_t = TFS(**{k: torch.tensor(a, dtype=td) for k, a in fs.items()})
    yt = torch.tensor(y, dtype=td)
    calls = {}
    cell, assemble = _fake_rhs_kernels(dm, fs_t, yt, cb, calls)
    monkeypatch.setattr(E, "rhs_cell", cell)
    monkeypatch.setattr(E, "rhs_assemble", assemble)
    got = TR._rhs_kernels(dm, fs_t, yt, cb)
    ref = TR._rhs_plain(dm, fs_t, yt, cb, False)
    assert calls == {"pre": 1, "assemble": 1}
    assert trace.counters()["shud.edge.rhs_torch_sums"] == len(names)
    assert torch.equal(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert set(g) == set(r)
        for k in r:
            a, b = (tuple(x) if k == "cu" else (x,) for x in (g[k], r[k]))
            assert all(torch.equal(p, q) for p, q in zip(a, b)), k


@pytest.mark.parametrize("case", ("card", "off_card", "lake",
                                  "exact_parity", "transform", "autograd"))
def test_rhs_route_decision(case, monkeypatch):
    """Where ``_rhs`` takes the RHS kernels, with the edge kernels' route
    stood in for on the CPU: a lake-free mesh there takes them, and so
    does no call off that route, on a lake mesh, on the absolute-head
    oracle or inside a ``torch.func`` transform; a call autograd would
    record there is refused (``edge.kernels_may_run``, the rule that
    ``_on_kernels`` keeps on the card)."""
    from shud_tpu_torch.core import edge as E

    md_j, md_t, cb, fs, y, v = _lin_case("lake" if case == "lake" else "bc")
    dm = to_torch(md_t, torch.float32, "cpu")
    fs_t = TFS(**{k: torch.tensor(a, dtype=torch.float32)
                  for k, a in fs.items()})
    yt = torch.tensor(y, dtype=torch.float32)
    if case != "off_card":
        monkeypatch.setattr(TR, "_on_kernels",
                            lambda m, *xs: E.kernels_may_run(*xs))
    if case == "autograd":
        with pytest.raises(RuntimeError, match="reverse mode"):
            TR._rhs_on_kernels(dm, fs_t, yt.requires_grad_(True), False)
        return
    if case == "transform":
        seen = []

        def f(yy):
            seen.append(TR._rhs_on_kernels(dm, fs_t, yy, False))
            return yy

        torch.func.jvp(f, (yt,), (torch.ones_like(yt),))
        assert seen == [False]
        return
    want = case == "card"
    assert TR._rhs_on_kernels(dm, fs_t, yt,
                              case == "exact_parity") == want
