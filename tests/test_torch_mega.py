"""The port's megakernel trio (core/mega.py) against the JAX package's.

The same mesh, forcing and state (numpy, from a seed) go through JAX's
``pallas_mega`` (interpret mode on the CPU) and the port's plain versions.
Bars are JAX's own for its megakernel against XLA
(tests/test_pallas_mega.py): dY per-entry relative 2e-4 with a 1e-7
floor, J·v 5e-4 with a 1e-5 floor, diagnostics
``2e-4|ref| + 1e-6 max|ref| + 1e-9``; and scaled 2e-5 in all three.

Meshes: the 12x8 variants of torch_variants.py, one with boundary
conditions and source terms, and one with a branched river network (a
confluence, a reach with several segments and a cell with two segments),
so the fixed-width reductions sum lists longer than one.  States include
exact ties (dry cells, empty reaches).  The driver runs the mega path
(plain versions) against JAX's f32 XLA driver.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from shud_tpu.core import pallas_mega as JM  # noqa: E402
from shud_tpu.core.device import to_device  # noqa: E402
from shud_tpu.core.mesh import build_mesh as jax_build  # noqa: E402
from shud_tpu.core.state import ForcingSlice as JFS  # noqa: E402
from shud_tpu_torch.core import mega as TM  # noqa: E402
from shud_tpu_torch.core.mesh import build_mesh as torch_build  # noqa: E402
from shud_tpu_torch.core.state import ForcingSlice as TFS  # noqa: E402
from torch_variants import (make_project, mega_inputs,  # noqa: E402
                            scaled_err, with_bc)

CASES = ("plain", "lake", "open", "rcm", "with_bc", "branched")
NX, NY = 12, 8


def _project(pkg, case):
    variant = "plain" if case == "with_bc" else case
    return make_project(pkg, variant, NX, NY)


@functools.lru_cache(maxsize=None)
def case_data(case):
    """Both packages' meshes and tables, the shared inputs, and JAX's
    results (computed once: interpret mode takes seconds per call)."""
    md_j = jax_build(_project("jax", case))
    md_t = torch_build(_project("torch", case))
    if case == "with_bc":
        md_j, md_t = with_bc(md_j), with_bc(md_t)
    cb = bool(_project("jax", case).control.close_boundary)
    fs, y, v = mega_inputs(md_j, seed=CASES.index(case))

    mbd = JM.mega_blocks_to_device(JM.build_mega_blocks(md_j))
    fs_j = JFS(**{k: jnp.asarray(a) for k, a in fs.items()})
    seg_ele = to_device(md_j, jnp.float32).seg_ele
    fc, fr, sg, fl = JM.forcing_to_blocks(mbd, fs_j, seg_ele)

    def f(z):
        return JM.rhs_mega(mbd, fc, fr, sg, z, close_boundary=cb, flake=fl)

    z, tz = JM.y_to_z(mbd, jnp.asarray(y)), JM.y_to_z(mbd, jnp.asarray(v))
    dz, jz = jax.jvp(f, (z,), (tz,))
    diag = JM.rhs_mega_diag(mbd, fc, fr, sg, z, close_boundary=cb, flake=fl)
    ref = dict(dy=np.asarray(JM.z_to_y(mbd, dz)),
               jv=np.asarray(JM.z_to_y(mbd, jz)),
               diag={k: np.asarray(a) for k, a in diag.items()})

    tables = TM.build_mega_tables(md_t)
    forcing = TM.pack_forcing(
        tables, TFS(**{k: torch.as_tensor(a) for k, a in fs.items()}))
    return dict(md_j=md_j, md_t=md_t, cb=cb, tables=tables, forcing=forcing,
                y=torch.as_tensor(y), v=torch.as_tensor(v), ref=ref)


def _check_rel(ref, got, rtol, floor):
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), floor)
    assert rel.max() < rtol, (
        f"max rel {rel.max():.3e} at {rel.argmax()} "
        f"(ref {ref[rel.argmax()]:.6e} got {got[rel.argmax()]:.6e})")
    assert scaled_err(ref, got) <= 2e-5


def test_branched_mesh_has_long_lists():
    d = case_data("branched")
    t = d["tables"]
    assert t.seg_to_ele.shape[1] > 1 and t.seg_to_riv.shape[1] > 1
    assert t.riv_up.shape[1] > 1


@pytest.mark.parametrize("case", CASES)
def test_mega_rhs_matches_jax(case):
    d = case_data(case)
    dy = TM.mega_rhs_plain(d["tables"], d["forcing"], d["y"], d["cb"])
    assert dy.dtype == torch.float32 and dy.shape == d["y"].shape
    _check_rel(d["ref"]["dy"], dy.numpy(), 2e-4, 1e-7)


@pytest.mark.parametrize("case", CASES)
def test_mega_jvp_matches_jax(case):
    d = case_data(case)
    jv = TM.mega_jvp_plain(d["tables"], d["forcing"], d["y"], d["v"], d["cb"])
    _check_rel(d["ref"]["jv"], jv.numpy(), 5e-4, 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_mega_diag_matches_jax(case):
    d = case_data(case)
    t = d["tables"]
    flat = TM.mega_diag_plain(t, d["forcing"], d["y"], d["cb"])
    assert flat.shape == (TM.diag_size(t),)
    diag = TM.diag_dict(t, flat)
    assert set(diag) == set(d["ref"]["diag"])
    for k, ref in d["ref"]["diag"].items():
        got = diag[k].numpy()
        assert got.shape == ref.shape, k
        tol = 2e-4 * np.abs(ref) + 1e-6 * np.abs(ref).max() + 1e-9
        bad = np.abs(got - ref) > tol
        assert not bad.any(), (k, int(bad.sum()),
                               float(np.abs(got - ref).max()))
        assert scaled_err(ref, got) <= 2e-5, k


@pytest.mark.parametrize("case", CASES)
def test_mega_diag_matches_eager_diag(case):
    """The window diagnostics of the mega path (the kernel's plain version)
    against the eager f32 ``rhs_full``'s, which the driver takes instead
    when the per-edge output channels are on (driver/fused.py): every
    same-named field, scaled 2e-5 (the mega-vs-eager RHS bar) and
    ``2e-4|ref| + 1e-6 max|ref| + 1e-9`` element-wise.  Port code only."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import rhs_full

    md = torch_build(_project("torch", case))
    if case == "with_bc":
        md = with_bc(md)
    cb = bool(_project("torch", case).control.close_boundary)
    fs, y, _ = mega_inputs(md, seed=CASES.index(case))
    fs = TFS(**{k: torch.as_tensor(a) for k, a in fs.items()})
    y = torch.as_tensor(y)
    t = TM.build_mega_tables(md)
    got = TM.diag_dict(t, TM.mega_diag_plain(t, TM.pack_forcing(t, fs), y,
                                             cb))
    _, eager = rhs_full(to_torch(md, torch.float32, "cpu"), fs, 0.0, y,
                        close_boundary=cb)
    assert set(got) <= set(eager)
    for k, g in got.items():
        ref, g = eager[k].double().numpy(), g.double().numpy()
        assert g.shape == ref.shape, k
        tol = 2e-4 * np.abs(ref) + 1e-6 * np.abs(ref).max() + 1e-9
        bad = np.abs(g - ref) > tol
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - ref).max()))
        assert scaled_err(ref, g) <= 2e-5, k


@pytest.mark.parametrize("kernel", (True, False))
@pytest.mark.parametrize("case", ("plain", "lake", "branched"))
def test_linearize_mega_values(case, kernel):
    """The solver's hook at *y*: ``linearize_mega``'s dY is the RHS
    kernel's plain version and, for each vector, its J·v the tangent
    kernel's plain version, bitwise, whether the kernels or (``kernel=
    False``, the card's reference path) their plain versions are asked
    for."""
    d = case_data(case)
    t, f, cb = d["tables"], d["forcing"], d["cb"]
    fy, jvp = TM.linearize_mega(t, f, d["y"], cb, kernel)
    assert torch.equal(fy, TM.mega_rhs_plain(t, f, d["y"], cb))
    assert torch.equal(fy, TM.rhs_mega(t, f, d["y"], cb, kernel))
    for v in (d["v"], 0.5 * d["v"]):
        assert torch.equal(jvp(v), TM.mega_jvp_plain(t, f, d["y"], v, cb))


@pytest.mark.parametrize("kernel", (True, False))
def test_rhs_mega_refused_inside_func_jvp(kernel):
    """rhs_mega inside a torch.func transform raises on every device and
    names linearize_mega, whose hand tangent autodiff of the plain version
    would not give (``_dabs`` is 0 at 0)."""
    d = case_data("plain")
    t, f, cb = d["tables"], d["forcing"], d["cb"]
    with pytest.raises(RuntimeError, match="linearize_mega"):
        torch.func.jvp(lambda yy: TM.rhs_mega(t, f, yy, cb, kernel),
                       (d["y"],), (d["v"],))


def test_rhs_mega_refuses_reverse_mode():
    d = case_data("plain")
    y = d["y"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="reverse mode"):
        TM.rhs_mega(d["tables"], d["forcing"], y, d["cb"])


@pytest.mark.parametrize("cut", ("fits", "max_cells", "no_rivers",
                                 "too_many_lakes"))
def test_tables_none_exactly_where_blocks_none(cut):
    md_j = jax_build(make_project("jax", "lake", 4, 2))
    md_t = torch_build(make_project("torch", "lake", 4, 2))
    kw, change = {}, {}
    if cut == "max_cells":
        kw = dict(max_cells=md_j.num_ele - 1)
    elif cut == "no_rivers":
        change = dict(num_riv=0)
    elif cut == "too_many_lakes":
        change = dict(num_lake=65)
    md_j = dataclasses.replace(md_j, **change)
    md_t = dataclasses.replace(md_t, **change)
    blocks = JM.build_mega_blocks(md_j, **kw)
    tables = TM.build_mega_tables(md_t, **kw)
    assert (blocks is None) == (tables is None)
    assert (tables is None) == (cut != "fits")


def test_jax_mega_checkpoint_loads_in_port(tmp_path):
    """A JAX checkpoint of the mega path holds the blocked state; the port
    unblocks it into its flat state."""
    from shud_tpu.driver.fused import FusedSimulation as JSim
    from shud_tpu.io.checkpoint import save_checkpoint as jax_save
    from shud_tpu_torch.driver.fused import FusedSimulation as TSim
    from shud_tpu_torch.io.checkpoint import load_checkpoint

    a = JSim.create("synthetic", inp=make_project("jax", "lake", NX, NY, 1.0),
                    float_dtype=jnp.float32, mega=True)
    assert a.use_mega and a.bdf.y.ndim == 2
    b = TSim.create("synthetic",
                    inp=make_project("torch", "lake", NX, NY, 1.0),
                    float_dtype=torch.float32, mega=True, device="cpu")
    path = str(tmp_path / "mega.ckpt.npz")
    jax_save(path, a)
    b.bdf = b.bdf._replace(y=torch.zeros_like(b.bdf.y))
    load_checkpoint(path, b)
    assert b.bdf.y.shape == (3 * b.md.num_ele + b.md.num_riv
                             + b.md.num_lake,)
    np.testing.assert_array_equal(b.y_np(), a.y_np())


def test_checkpoint_of_another_mesh_refused(tmp_path):
    """A state whose shape is neither the flat nor the blocked layout of
    this mesh raises instead of loading."""
    from shud_tpu_torch.driver.fused import FusedSimulation as TSim
    from shud_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    def sim(nx, ny):
        return TSim.create("synthetic",
                           inp=make_project("torch", "plain", nx, ny, 1.0),
                           float_dtype=torch.float32, mega=True,
                           device="cpu")

    path = str(tmp_path / "other.ckpt.npz")
    save_checkpoint(path, sim(6, 4))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, sim(4, 2))


def test_linearize_mega_matches_func_jvp_route(monkeypatch):
    """One storm window of the mega path (12x8, f32, CPU) through the
    solver's linearize hook runs the RHS once per Newton iteration and the
    tangent krylov_m times; the solver's default route, torch.func.jvp of
    rhs_mega, is refused on the mega path, naming the hook."""
    from shud_tpu_torch.driver import fused
    from shud_tpu_torch.driver.fused import FusedSimulation as TSim
    from shud_tpu_torch.solver import bdf

    calls = {}
    for name in ("mega_rhs_plain", "mega_jvp_plain"):
        def counted(*a, _fn=getattr(TM, name), _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(TM, name, counted)

    def window():
        inp = make_project("torch", "plain", NX, NY, 2.0)
        inp.control.day_start = 1.0
        sim = TSim.create("synthetic", inp=inp, float_dtype=torch.float32,
                          mega=True, device="cpu")
        calls.update(mega_rhs_plain=0, mega_jvp_plain=0)
        it0 = bdf.newton_iters
        sim.advance_interval(10.0)
        return sim, dict(calls), bdf.newton_iters - it0

    hook, calls_hook, it_hook = window()
    m = hook.cfg.krylov_m
    assert hook.bdf.nfe == it_hook * (1 + m) > 0
    assert calls_hook == {"mega_rhs_plain": it_hook,
                          "mega_jvp_plain": m * it_hook}
    solve_to = fused.solve_to
    monkeypatch.setattr(fused, "solve_to",
                        lambda f, st, tout, p, cfg, quad_fn, linearize, **kw:
                        solve_to(f, st, tout, p, cfg, quad_fn, **kw))
    with pytest.raises(RuntimeError, match="linearize_mega"):
        window()


@pytest.mark.parametrize("case,n_threads", (
    ("mega ceiling", TM.MAX_CELLS + 128 + TM.MAX_LAKES),
    ("all 528 blocks", 132 * 4 * 128)))
def test_launch_plan_fits_the_card(case, n_threads):
    """At 128 registers a thread an SM holds 65,536 / (128 x 128) = 4
    blocks of 128 threads: on an H100's 132 SMs one thread per cell,
    reach and lake of the largest mega mesh fits."""
    assert TM.launch_plan(n_threads, 132, 4) == -(-n_threads // 128)


@pytest.mark.parametrize("case,n_threads,blocks_per_sm", (
    ("one block too many", 132 * 4 * 128 + 1, 4),
    ("at 255 registers", 132 * 2 * 128 + 1, 2),
    ("no block fits", 1, 0)))
def test_launch_plan_refuses_what_cannot_be_resident(case, n_threads,
                                                     blocks_per_sm):
    with pytest.raises(ValueError, match="resident"):
        TM.launch_plan(n_threads, 132, blocks_per_sm)


@pytest.mark.parametrize("bad,match", (
    ("float64 cell_f", "float32"), ("int64 seg_to_ele", "int32"),
    ("short seg_f", "shape"), ("edge_f without slots", "shape")))
def test_tables_checked_at_to(bad, match):
    """What the kernel calls used to check of the tables on every call is
    checked once, when the tables move to their device."""
    t = case_data("plain")["tables"]
    change = {"float64 cell_f": {"cell_f": t.cell_f.double()},
              "int64 seg_to_ele": {"seg_to_ele": t.seg_to_ele.long()},
              "short seg_f": {"seg_f": t.seg_f[:, 1:]},
              "edge_f without slots": {"edge_f": t.edge_f[:, :, 0]}}[bad]
    t.to("cpu")
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(t, **change).to("cpu")


@pytest.mark.parametrize("bad", ("cells", "reaches"))
def test_forcing_checked_at_pack(bad):
    """The packed forcing is checked once, in pack_forcing: a slice whose
    cell or river fields do not have one value per cell or reach."""
    d = case_data("plain")
    md, t = d["md_t"], d["tables"]
    fs, _, _ = mega_inputs(md, seed=0)
    n, keys = ((md.num_ele + 1, [k for k in fs if k not in ("riv_ybc",
                                                              "riv_qbc")])
               if bad == "cells" else (md.num_riv - 1, ["riv_ybc", "riv_qbc"]))
    fs.update({k: np.resize(fs[k], n) for k in keys})
    with pytest.raises(ValueError, match="shape"):
        TM.pack_forcing(t, TFS(**{k: torch.as_tensor(a)
                                  for k, a in fs.items()}))


@pytest.mark.parametrize("variant,start_day,minutes", (
    ("plain", 0.0, 60.0), ("lake", 0.0, 30.0), ("plain", 1.0, 30.0)),
    ids=("plain", "lake", "storm"))
def test_mega_driver_matches_jax_f32(variant, start_day, minutes):
    """The mega path against JAX's f32 XLA driver: NFE within 2% and the
    state within 2e-5 m, from the start and from the storm's onset (day 1,
    where the surface wets).  On the lake mesh two f32 runs drift apart by
    f32 round-off alone (JAX's own f32 driver ends 1.6e-5 m from its f64
    one after 30 minutes, at equal NFE), so there the state is held
    against JAX's f64 driver, the accurate answer, at the same bar."""
    from shud_tpu.driver.fused import FusedSimulation as JSim
    from shud_tpu_torch.driver.fused import FusedSimulation as TSim

    def project(pkg):
        inp = make_project(pkg, variant, NX, NY, 2.0)
        inp.control.day_start = start_day
        return inp

    def jax_sim(dtype):
        return JSim.create("synthetic", inp=project("jax"), float_dtype=dtype,
                           mega=False, pallas_edges=False)

    a = jax_sim(jnp.float32)
    b = TSim.create("synthetic", inp=project("torch"),
                    float_dtype=torch.float32, mega=True, device="cpu")
    assert b.mega is not None
    a.advance_interval(minutes)
    mb = b.advance_interval(minutes)
    ref = a
    if variant == "lake":
        ref = jax_sim(jnp.float64)
        ref.advance_interval(minutes)
    y_ref = np.asarray(ref.y_np(), np.float64)
    assert np.abs(b.y_np().astype(np.float64) - y_ref).max() < 2e-5
    nfe_a = int(a.bdf.nfe)
    assert abs(b.bdf.nfe - nfe_a) <= 0.02 * nfe_a
    assert all(bool(torch.isfinite(v).all()) for v in mb[0].values())
