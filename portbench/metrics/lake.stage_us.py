"""lake.stage_us: the slowest lake's microseconds in stage C a mega RHS
or J·v call (one thread a lake, from the fused kernel's second grid
barrier to its last write: the bank-edge and inflow-reach sums, the
bathymetry scan and dStage), from the kernels' own clock
(``shud_tpu_torch.core.mega.lake_stage_ns``, on while the program's
tracing is) over three replays on an interval graph built with tracing
on, divided by the RHS and J·v kernels' runs in them (their device
counters).  On stderr: each lake's microseconds, the mesh's sizes and
the set-up's counters.  None on a lake-free mesh, off the mega path,
without an interval graph, or where the program has no such clock."""

import sys

REPLAYS = 3
KERNELS = ("mega_rhs", "mega_jvp")


def read(probe):
    try:
        from shud_tpu_torch import trace
        from shud_tpu_torch.core import mega
    except ImportError:
        return None
    if not hasattr(mega, "lake_stage_ns"):
        return None
    prog = probe.prog
    sim = prog.sim
    plain = sim.interval
    if plain is None or sim.mega is None or sim.mega.nl == 0:
        return None
    graph = None
    try:
        trace.enable()
        sim.interval = graph = type(plain)(sim, plain.w_max, plain.capture)
        prog.restore()
        prog.interval()  # builds it
        mega.reset_lake_stage(sim.mega)
        before = mega.device_launch_counts()
        for _ in range(REPLAYS):
            prog.restore()
            for _ in range(prog.n_intervals):
                prog.interval()
        after = mega.device_launch_counts()
        ns = mega.lake_stage_ns(sim.mega)
    finally:
        trace.disable()
        sim.interval = plain
        if graph is not None:
            graph.close()
    calls = sum(after[k] - before[k] for k in KERNELS)
    if ns is None or not calls:
        return None
    per_lake = [sum(ns[k][lake] for k in KERNELS) / calls / 1e3
                for lake in range(sim.mega.nl)]
    t = sim.mega
    print(f"lake stage: us a RHS or J-v call per lake {per_lake!r} over "
          f"{calls} calls; {t.ne} cells, {t.nr} reaches, {t.ns} segments, "
          f"{t.nl} lakes; counters {trace.counters()!r}", file=sys.stderr)
    return max(per_lake)
