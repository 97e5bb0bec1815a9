"""The lake basin of the benchmark's ``lakes-32k`` configuration
(``portbench/generators/lakebasin.py``) and its plain reference
(``portbench/lakes/``), on the CPU at 16 x 12 quads (384 cells, one lake
of 55 cells, 131 reaches).

* The generator gives qhh's layout: one lake, and every reach flows,
  reach by reach, to an outlet on the lake's shore (``down`` -3), as
  many outlets as ``outlets_per_bank_edge`` of the bank edges and no
  reach routed into the lake; no segment lies in the lake, and the
  lake's cells, bank edges and (empty) inflow reaches are the sets that
  ``core/mesh.py`` and the mega tables build; the mega tables state the
  lakes, lake cells and widest lists as the trace's counters.
* On seeded random states and forcing the reference's right-hand side
  and its tangent (``torch.func.jvp``) are the port's at float64
  (``core/rhs.py``), lake entries included, within the 1e-12 the port's
  RHS met against the C++ oracle (J·v 1e-10: the hand tangent's
  local-datum form against autodiff of the absolute heads, as in
  ``test_torch_rhs.py``); the mega path's plain versions in float32
  within 2e-5 scaled (dY) and 1e-4 (J·v), and each lake's dStage and its
  tangent within 2e-4 and 5e-4 of itself, the JAX megakernel's per-entry
  bars (``test_torch_mega.py``): float32 rounding, which the lakes' stage
  -> area lookup at the absolute stage (an ulp of 2.4e-4 m at 3,185 m)
  brings to 3-12e-5 of dStage.
* A replay of two storm hours on the port's fused driver (float64 eager,
  and the float32 mega path on its plain versions) stays within 10
  tolerance units (WRMS of the gaps over reltol |w| + abstol) of the
  reference's run, the lake's stage within 1: two adaptive solvers
  that each hold their local error under one unit a step.
* The reference's right-hand side is JAX's (``shud_tpu``'s
  ``rhs_full`` with ``exact_parity``) at float64 within 1e-12: held
  against an implementation other than the port's.
* Both right-hand-side checks run again with the outlets routed into
  the lake (``down`` -4), the reach -> lake branch that qhh's layout
  leaves untaken.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, gen, harness
from torch_variants import (STAGE_C_BASINS, lake_basin, make_project,
                            random_inputs, scaled_err)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NX, NY = 16, 12
LAKE_KEYS = ("q_lake_evap", "q_lake_prcp", "q_lake_surf", "q_lake_sub",
             "q_lake_rivin", "lake_area")


def _config():
    cfg = json.loads((ROOT / "portbench/configs/lakes-32k.json").read_text())
    return dict(cfg, nx=NX, ny=NY)


def _traffic(end_min=840.0):
    t = json.loads((ROOT / "portbench/traffic/storm.json").read_text())
    return dict(t, end_min=end_min)


@pytest.fixture(scope="module")
def basin():
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.io import project

    cfg = _config()
    hooks = harness.hooks(harness.OWN, cfg)
    raw = gen.make_raw(cfg, _traffic(), generator=hooks.generator)
    ref_inp = gen.to_input(raw, hooks.ref("project"), ".")
    return dict(cfg=cfg, hooks=hooks, raw=raw, ref=hooks.ref,
                ref_md=hooks.ref("mesh").build_mesh(ref_inp),
                md=build_mesh(gen.to_input(raw, project, ".")),
                run=hooks.ref("driver").simulate(
                    ref_inp, _traffic()["interval_min"], "cpu"))


@pytest.fixture(scope="module")
def routed(basin):
    """The basin with its outlets routed into the lake (``down`` -4), as
    SHUD's lake-bound reaches are: the reference's and the port's reach
    -> lake branch, which qhh's layout does not take."""
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.io import project

    riv = basin["raw"]["riv"].copy()
    riv[:, 1] = np.where(riv[:, 1] == -3, -4, riv[:, 1])
    raw = dict(basin["raw"], riv=riv)
    md = build_mesh(gen.to_input(raw, project, "."))
    assert (md.riv_to_lake == 0).sum() == (riv[:, 1] == -4).sum() > 0
    return dict(basin, raw=raw, md=md, ref_md=basin["ref"]("mesh").build_mesh(
        gen.to_input(raw, basin["ref"]("project"), ".")))


def test_generator_gives_a_closed_basin(basin):
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import mega

    raw, md, cfg = basin["raw"], basin["md"], basin["cfg"]
    ne = len(raw["tri"])
    lake = raw["att"][:, 8].astype(np.int64) - 1
    assert sorted(np.unique(lake)) == [-1, 0]
    assert int((lake >= 0).sum()) == round(ne * cfg["lake_cell_share"])
    down = raw["riv"][:, 1].astype(np.int64)
    nr = len(down)
    assert nr == round(ne * cfg["reach_share"])
    assert ((down >= 1) | (down == -3)).all()
    nb = raw["tri"][:, 4:7].astype(np.int64) - 1
    bank = np.where((nb >= 0) & (lake[:, None] < 0),
                    lake[np.maximum(nb, 0)], -1)
    assert int((down == -3).sum()) == round(
        int((bank >= 0).sum()) * cfg["outlets_per_bank_edge"])
    # every reach reaches an outlet, reach by reach, and each outlet's
    # cell lies on the lake's shore
    at = np.arange(nr)
    for _ in range(nr):
        flowing = down[at] >= 1
        if not flowing.any():
            break
        at = np.where(flowing, down[at] - 1, at)
    assert (down[at] == -3).all()
    seg_riv = raw["rivseg"][:, 1].astype(np.int64) - 1
    seg_cell = raw["rivseg"][:, 2].astype(np.int64) - 1
    assert (lake[seg_cell] < 0).all()
    own = seg_cell[np.isin(seg_riv, np.flatnonzero(down == -3))]
    assert (bank[own] >= 0).any(axis=1).all()
    # the lake's cells, bank edges and inflow reaches: core/mesh.py's
    np.testing.assert_array_equal(md.i_lake, lake + 1)
    np.testing.assert_array_equal(md.lakenabr, bank)
    np.testing.assert_array_equal(md.riv_to_lake,
                                  np.where(down <= -4, -4 - down, -1))
    np.testing.assert_array_equal(md.lake_num_ele, np.bincount(lake[lake >= 0]))
    t = mega.build_mega_tables(md)
    # the set-up's counters of the mega path's lakes
    assert {k: v for k, v in trace.counters().items()
            if k.startswith("shud.mega.")} == {
        "shud.mega.lakes": 1, "shud.mega.lake_cells": int((lake >= 0).sum()),
        "shud.mega.kel": t.edge_to_lake.shape[1],
        "shud.mega.krl": t.riv_to_lake.shape[1],
        "shud.mega.kup": t.riv_up.shape[1], "shud.mega.stage_c_rounds": 1}
    for rows, members, pad in (
            (t.cell_to_lake, lake, ne), (t.edge_to_lake, bank.ravel(), 3 * ne),
            (t.riv_to_lake, np.where(down <= -4, -4 - down, -1), nr)):
        for k in range(1):
            got = rows[k].numpy()
            np.testing.assert_array_equal(got[got != pad],
                                          np.flatnonzero(members == k))
    # the same basin whatever the run: the generator draws nothing
    again = basin["hooks"].generator.make(cfg, _traffic())
    first = basin["hooks"].generator.make(cfg, _traffic())
    for k in ("tri", "nodes", "att", "riv", "rivseg"):
        np.testing.assert_array_equal(again[k], first[k], err_msg=k)


@pytest.mark.parametrize("case", ("plain", "lake", "three", "k128", "k129",
                                  "wide"))
def test_mega_tables_state_stage_c_rounds(case, monkeypatch):
    """On a lake mesh ``build_mega_tables`` states
    ``shud.mega.stage_c_rounds``: the gather rounds that the widest lake
    list (bank edges or inflow reaches) takes at ``STAGE_C_CHUNK`` entries
    a round, one on the synthetic lake and the three-lake basin, one at
    128 bank edges, two at 129, three at 267; on a lake-free mesh it states
    the other counters and not this one."""
    from shud_tpu_torch import trace
    from shud_tpu_torch.core import mega
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.io import project

    monkeypatch.setattr(trace, "_REC", trace.Recorder())
    if case in ("plain", "lake"):
        md, rounds = build_mesh(make_project("torch", case)), 1
    else:
        kwargs, _, _, rounds = STAGE_C_BASINS[case]
        md = build_mesh(gen.to_input(lake_basin(**kwargs)[0], project, "."))
    t = mega.build_mega_tables(md)
    got = trace.counters()
    assert got["shud.mega.kel"] == t.edge_to_lake.shape[1]
    if case == "plain":
        assert t.nl == 0 and "shud.mega.stage_c_rounds" not in got
        return
    widest = max(t.edge_to_lake.shape[1], t.riv_to_lake.shape[1])
    assert got["shud.mega.stage_c_rounds"] == rounds == -(
        -widest // mega.STAGE_C_CHUNK)


def test_lake_forcing_pack_takes_as_many_operations_at_any_size(basin):
    """The mega path's window forcing (``pack_forcing``: the lakes' mean
    precipitation and evaporation among it) runs the same operations on
    a lake of 55 cells and on one of 885: on the card each is a
    launch in every window's head, and a sum column by column made two a
    cell of the widest lake."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from shud_tpu_torch.core import mega
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.state import ForcingSlice
    from shud_tpu_torch.io import project

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    def ops(md):
        t = mega.build_mega_tables(md)
        fs, _ = random_inputs(md)
        fs = ForcingSlice(**{k: torch.tensor(v) for k, v in fs.items()})
        with Count() as c:
            mega.pack_forcing(t, fs)
        return c.ops, int(t.cell_to_lake.shape[1])

    cfg = dict(_config(), nx=64, ny=48)
    big = build_mesh(gen.to_input(gen.make_raw(cfg, _traffic()), project, "."))
    (small_ops, small_k), (big_ops, big_k) = ops(basin["md"]), ops(big)
    assert small_k < 100 and big_k > 500
    assert small_ops == big_ops


def _port_and_reference(basin, seed, dtype=torch.float64):
    """The port's device mesh and the reference's, one random forcing
    slice and state (numpy, from *seed*) in each."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.state import ForcingSlice

    from portbench.reference.state import ForcingSlice as RefSlice

    fs, y = random_inputs(basin["md"], seed=seed)
    return (to_torch(basin["md"], dtype, "cpu"),
            ForcingSlice(**{k: torch.tensor(v, dtype=dtype)
                            for k, v in fs.items()}),
            basin["ref"]("device").to_torch(basin["ref_md"], torch.float64,
                                            "cpu"),
            RefSlice(**{k: torch.tensor(v) for k, v in fs.items()}),
            y)


@pytest.mark.parametrize("seed", (0, 1))
def test_rhs_and_jv_match_the_port(basin, seed):
    _rhs_and_jv_match_the_port(basin, seed)


def test_rhs_and_jv_match_the_port_with_reaches_into_the_lake(routed):
    _rhs_and_jv_match_the_port(routed, 2)


def _rhs_and_jv_match_the_port(basin, seed):
    from shud_tpu_torch.core import mega
    from shud_tpu_torch.core import rhs as port

    rhs = basin["ref"]("rhs")
    dm, fs, rdm, rfs, y = _port_and_reference(basin, seed)
    v = np.random.default_rng(seed + 10).standard_normal(len(y))
    dy_r, dg_r = rhs.rhs_full(rdm, rfs, 0.0, torch.tensor(y), True)
    dy_p, dg_p = port.rhs_full(dm, fs, 0.0, torch.tensor(y), True,
                               exact_parity=True)
    nl = basin["md"].num_lake
    assert scaled_err(dy_r, dy_p) <= 1e-12
    assert scaled_err(dy_r[-nl:], dy_p[-nl:]) <= 1e-12
    for k in LAKE_KEYS:
        assert scaled_err(dg_r[k], dg_p[k]) <= 1e-12, k
    _, jv_r = torch.func.jvp(
        lambda yy: rhs.rhs(rdm, rfs, 0.0, yy, True), (torch.tensor(y),),
        (torch.tensor(v),))
    _, jvp = port.linearize(dm, fs, 0.0, torch.tensor(y), True)
    jv_p = jvp(torch.tensor(v))
    assert scaled_err(jv_r, jv_p) <= 1e-10
    assert scaled_err(jv_r[-nl:], jv_p[-nl:]) <= 1e-10
    # the mega path's plain versions, in float32
    t = mega.build_mega_tables(basin["md"])
    f32 = mega.pack_forcing(t, fs)
    y32, v32 = torch.tensor(y, dtype=torch.float32), torch.tensor(
        v, dtype=torch.float32)
    dy_m = mega.mega_rhs_plain(t, f32, y32, True)
    jv_m = mega.mega_jvp_plain(t, f32, y32, v32, True)
    assert scaled_err(dy_r, dy_m) <= 2e-5
    assert scaled_err(jv_r, jv_m) <= 1e-4

    def rel(ref, got):
        return float(((ref - got.double()).abs() / ref.abs()).max())

    assert rel(dy_r[-nl:], dy_m[-nl:]) <= 2e-4
    assert rel(jv_r[-nl:], jv_m[-nl:]) <= 5e-4


@pytest.mark.parametrize("form", ("float64", "mega"))
def test_fused_replay_matches_the_reference(basin, form):
    from portbench.program import Program

    cfg = dict(basin["cfg"], float="float32" if form == "mega" else "float64",
               mega=form == "mega", path="mega" if form == "mega" else "edge")
    traffic = _traffic()
    ref = basin["run"]
    prog = Program(basin["raw"], cfg, traffic, "cpu", ".")
    prog.snapshot()
    got = [prog.interval() for _ in range(prog.n_intervals)]
    nl = prog.sim.md.num_lake
    assert len(got) == 2 and nl == 1
    numbers, _ = compare.gaps(got, ref, cfg["control"])
    assert numbers["water_wrms"] <= 10.0 and numbers["state_wrms"] <= 10.0
    rtol, atol = cfg["control"]["reltol"], cfg["control"]["abstol"]
    for g, r in zip(got, ref):
        stage, want = g["y"][-nl:], r["y"][-nl:]
        assert (np.abs(stage - want) / (rtol * np.abs(want) + atol)
                <= 1.0).all()


def test_reference_rhs_is_jax(basin):
    """The reference's right-hand side against the JAX package's, on the
    basin's mesh built by each from the same input."""
    _reference_rhs_is_jax(basin)


def test_reference_rhs_is_jax_with_reaches_into_the_lake(routed):
    _reference_rhs_is_jax(routed)


def _reference_rhs_is_jax(basin):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from shud_tpu.core import rhs as JR
    from shud_tpu.core.device import to_device
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.core.state import ForcingSlice as JFS
    from shud_tpu.io import project as jax_project

    _, _, rdm, rfs, y = _port_and_reference(basin, 3)
    md_j = jax_build(gen.to_input(basin["raw"], jax_project, "."))
    fs = {k: v.numpy() for k, v in rfs._asdict().items()}
    dy_j, dg_j = JR.rhs_full(to_device(md_j, jnp.float64),
                             JFS(**{k: jnp.asarray(v) for k, v in fs.items()}),
                             0.0, jnp.asarray(y), close_boundary=True,
                             exact_parity=True)
    dy_r, dg_r = basin["ref"]("rhs").rhs_full(rdm, rfs, 0.0, torch.tensor(y),
                                              True)
    assert scaled_err(np.asarray(dy_j), dy_r) <= 1e-12
    for k in LAKE_KEYS:
        assert scaled_err(np.asarray(dg_j[k]), dg_r[k]) <= 1e-12, k
