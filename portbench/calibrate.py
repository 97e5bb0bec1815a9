#!/usr/bin/env python3
"""The readings that a cell's limits (``limits/<workload>.json``) are set
from, at the cell's own size, on the card.

    python3 portbench/calibrate.py --workload edge-131k-storm \\
        --orderings 11,12,...  --control-orderings 11,12,13

Each ordering numbers the cell's watershed anew (``gen.make_raw``'s
*order*): the same cell, whose float32 reductions then add in another
order, so the program takes another of its sound trajectories.  For each
of ``--orderings``: the program's set-up and one replay of the cell's
period (the timed path: the interval graph, the fetch), then the
reference, and the comparison's numbers.  For each of
``--control-orderings``: the control, the reference put in the program's
place with every input table and the initial state in bfloat16 (the
precision below the configuration's float32), held against the
reference.  One JSON line a run; the lower reading is the largest number
of the program's orderings, the upper the smallest of the control's.

``--faults`` plants each fault of the timed path in turn at the cell's
own size, on the interval graph, around ``advance_interval``: the state
returned unchanged (``unchanged``), half of the cells left at their state
of the interval's start (``half``), one cell's groundwater altered
(``altered``); one replay each, judged against the reference by the
cell's limits as a run judges, one JSON line a fault.

The watershed, the program and the reference are the cell's own, those
its configuration names (``harness.hooks``), as in a run: a cell's limits
come from its own generator, program and reference.  The control calls
the reference's ``driver.simulate`` with ``round_inputs``; the faults
are planted on the program's ``sim`` (its ``advance_interval`` and
``bdf.y``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _unchanged(before, after, ne):
    return before._replace(t=after.t)


def _half(before, after, ne):
    y = after.y.clone()
    for k in range(3):
        y[k * ne + ne // 2:(k + 1) * ne] = before.y[k * ne + ne // 2:
                                                   (k + 1) * ne]
    return after._replace(y=y)


def _altered(before, after, ne):
    y = after.y.clone()
    y[2 * ne + 5] += 0.05
    return after._replace(y=y)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def plant(sim, fault, ne: int) -> None:
    """*fault(before, after, ne)* applied to the solver state after each
    ``advance_interval`` of *sim*: the state it returns is a new object,
    so the next interval copies it into the graph and goes on from it."""
    advance = sim.advance_interval

    def planted(minutes):
        before = sim.bdf
        out = advance(minutes)
        sim.bdf = fault(before, sim.bdf, ne)
        return out

    sim.advance_interval = planted


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--orderings", default="")
    ap.add_argument("--control-orderings", default="")
    ap.add_argument("--faults", default="",
                    help="comma-separated: unchanged, half, altered")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import compare, gen, harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(ROOT, spec, args.workload)
    harness.check_device(cell["chips"])
    cfg, traffic = cell["config"], cell["traffic"]
    hooks = cell["hooks"]
    interval = float(traffic["interval_min"])
    where = str(ROOT / "build")

    def orders(text):
        return [int(s) for s in text.split(",") if s]

    def make_raw(order=None):
        return gen.make_raw(cfg, traffic, order, hooks.generator)

    def reference(raw, **kw):
        return hooks.ref("driver").simulate(
            gen.to_input(raw, hooks.ref("project"), where), interval, "cuda",
            **kw)

    rows = []
    for order in orders(args.orderings):
        raw = make_raw(order)
        t0 = time.perf_counter()
        prog = hooks.program(raw, cfg, traffic, "cuda", where)
        prog.snapshot()
        got = [prog.interval() for _ in range(prog.n_intervals)]
        nfe = prog.nfe
        prog.close()
        del prog
        gc.collect()
        t1 = time.perf_counter()
        ref = reference(raw)
        t2 = time.perf_counter()
        numbers, _ = compare.gaps(got, ref, cfg["control"])
        rows.append({"side": "program", "order": order, **numbers, "nfe": nfe,
                     "program_s": t1 - t0, "reference_s": t2 - t1})
        print(json.dumps(rows[-1]), flush=True)
    for order in orders(args.control_orderings):
        raw = make_raw(order)
        ref = reference(raw)
        ctl = reference(raw, round_inputs=torch.bfloat16)
        numbers, _ = compare.gaps(ctl, ref, cfg["control"])
        rows.append({"side": "control", "order": order, **numbers})
        print(json.dumps(rows[-1]), flush=True)
    faults = [f for f in args.faults.split(",") if f]
    if faults:
        raw = make_raw()
        ref = reference(raw)
        ne = len(raw["tri"])
        for name in faults:
            prog = hooks.program(raw, cfg, traffic, "cuda", where)
            plant(prog.sim, FAULTS[name], ne)
            prog.snapshot()
            got = [prog.interval() for _ in range(prog.n_intervals)]
            prog.close()
            del prog
            gc.collect()
            numbers, per = compare.gaps(got, ref, cfg["control"])
            print(json.dumps({
                "side": "fault", "fault": name, **numbers,
                "correct": compare.judge(numbers, cell["limits"]),
                "failed": compare.failed_intervals(per, cell["limits"])}),
                flush=True)
    summary = {}
    for k in compare.NUMBERS:
        prog_vals = [r[k] for r in rows if r["side"] == "program"]
        ctl_vals = [r[k] for r in rows if r["side"] == "control"]
        summary[k] = {"lower": max(prog_vals) if prog_vals else None,
                      "upper": min(ctl_vals) if ctl_vals else None}
    print(json.dumps({"workload": args.workload, "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
