"""The reference against the port's eager float64 path on the CPU, and the
work count of the rooflines."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import compare, gen, work
from portbench.reference import driver, project as ref_project

BENCH = Path(__file__).resolve().parent


def _tiny(nx=12, ny=8, config="mega-32k", traffic="storm", **kw):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(nx=nx, ny=ny)
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(kw)
    return cfg, tr


def test_reference_rhs_is_the_port_rhs_in_float64():
    """The frozen right-hand side gives the port's eager float64 one in the
    C++ operation order (``exact_parity``) to round-off."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.core.rhs import rhs_full
    from shud_tpu_torch.core.state import ForcingSlice as PortSlice
    from shud_tpu_torch.io import project

    from portbench.reference import device as ref_device
    from portbench.reference import mesh as ref_mesh
    from portbench.reference import rhs as ref_rhs
    from portbench.reference.state import ForcingSlice

    cfg, tr = _tiny()
    raw = gen.make_raw(cfg, tr, 3)
    md = build_mesh(gen.to_input(raw, project, "."))
    dm = to_torch(md, torch.float64, "cpu")
    rmd = ref_mesh.build_mesh(gen.to_input(raw, ref_project, "."))
    rdm = ref_device.to_torch(rmd, torch.float64, "cpu")
    g = torch.Generator().manual_seed(1)
    ne, nr = md.num_ele, md.num_riv
    y = torch.cat([torch.rand(ne, generator=g, dtype=torch.float64) * 0.02,
                   torch.rand(2 * ne, generator=g, dtype=torch.float64) * 4,
                   torch.rand(nr, generator=g, dtype=torch.float64)])
    fields = {k: torch.rand(ne, generator=g, dtype=torch.float64) * 1e-5
              for k in ("net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic")}
    fields.update(lai=torch.full((ne,), 2.0, dtype=torch.float64),
                  fu_surf=torch.ones(ne, dtype=torch.float64),
                  fu_sub=torch.ones(ne, dtype=torch.float64))
    zeros = dict(ele_ybc=torch.zeros(ne, dtype=torch.float64),
                 ele_qbc=torch.zeros(ne, dtype=torch.float64),
                 ele_qss=torch.zeros(ne, dtype=torch.float64),
                 riv_ybc=torch.zeros(nr, dtype=torch.float64),
                 riv_qbc=torch.zeros(nr, dtype=torch.float64))
    got, diag = ref_rhs.rhs_full(rdm, ForcingSlice(**fields, **zeros), 0.0,
                                 y)
    want, want_diag = rhs_full(dm, PortSlice(**fields, **zeros), 0.0, y,
                               exact_parity=True)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-12 * scale
    torch.testing.assert_close(diag["q_riv_down"], want_diag["q_riv_down"],
                               rtol=1e-12, atol=0.0)


def test_reference_follows_the_port_over_an_interval():
    """One storm hour at 192 cells: the reference and the port's eager
    float64 driver (its own solver) agree within the solver's tolerance
    in the comparison's numbers."""
    from portbench.program import Program

    cfg, tr = _tiny(end_min=780.0)
    raw = gen.make_raw(cfg, tr, 21)
    ref = driver.simulate(gen.to_input(raw, ref_project, "."), 60.0, "cpu")
    prog = Program(raw, dict(cfg, float="float64", mega=False, path="edge"),
                   tr, "cpu", ".")
    got = [prog.interval()]
    numbers, _ = compare.gaps(got, ref, cfg["control"])
    assert numbers["water_wrms"] < 0.5, numbers
    assert numbers["flow_gap"] < 1e-3, numbers


def test_control_fails_the_comparison():
    """The control (inputs and initial state in bfloat16, arithmetic in
    float64) fails the tiny cell's limits, which sound runs keep."""
    cfg, tr = _tiny(end_min=840.0)
    raw = gen.make_raw(cfg, tr, 4)
    inp = gen.to_input(raw, ref_project, ".")
    ref = driver.simulate(inp, 60.0, "cpu")
    ctl = driver.simulate(gen.to_input(raw, ref_project, "."), 60.0, "cpu",
                          round_inputs=torch.bfloat16)
    numbers, _ = compare.gaps(ctl, ref, cfg["control"])
    assert not compare.judge(numbers, {"water_wrms": 5.0, "flow_gap": 0.1})


def test_work_counted_from_the_mesh_alone():
    """The roofline's work is the same for one mesh whichever path its
    configuration names (mega or edge), and grows with the mesh."""
    cfg_m, tr = _tiny(config="mega-32k")
    cfg_e, _ = _tiny(config="edge-131k")
    assert cfg_m["path"] != cfg_e["path"]
    a = work.evaluation_work(gen.make_raw(cfg_m, tr, 1), 4)
    b = work.evaluation_work(gen.make_raw(cfg_e, tr, 2), 4)
    assert a == b
    big = work.evaluation_work(gen.make_raw(_tiny(nx=24)[0], tr, 1), 4)
    assert 1.8 < big["rhs"][0] / a["rhs"][0] < 2.2
    n = 3 * 192 + 12
    assert a["jv"][0] == a["rhs"][0] + 4 * n
    assert a["rhs"][1] > 0 and a["jv"][1] == 2 * a["rhs"][1]


def test_roofline_share():
    kind = "NVIDIA H100 80GB HBM3"
    t, by = work.bound_seconds(3.35e6, 1.0, kind)
    assert by == "bytes" and abs(t - 1e-6) < 1e-15
    assert abs(work.roofline_pct((3.35e6, 1.0), 4e-6, kind) - 25.0) < 1e-9
    assert work.roofline_pct((3.35e6, 1.0), 4e-6, "unknown card") is None
    assert np.isclose(work.bound_seconds(1.0, 67e12, kind)[0], 1.0)
