"""The system under test: the port's fused driver on one generated cell.

``Program`` builds ``shud_tpu_torch``'s ``FusedSimulation`` from the
generated input, keeps a snapshot of its start state (the solver state
with its history, the buckets, the time), and replays the cell's period
from it interval by interval, as ``run_project_fast`` does: one
``advance_interval`` call, then the interval's means, stages and state
fetched to the host.  No output file is written.

It is the program of every configuration that names none.  A
configuration's own (``programs/<name>.py``, named by its ``program``
key, ``harness.hooks``) is a class ``Program`` built as
``Program(raw, config, traffic, device, where)`` from ``gen.make_raw``'s
watershed, and offers what the harness, its ``Probe`` and ``spans.py``
read of this one:

- ``n_intervals``, ``interval_min``: the replayed period's intervals and
  their minutes;
- ``snapshot()``, ``restore()``: keep the start state, and go back to it
  before each replay; ``interval(after_advance=None)``: one interval,
  returning ``{"t", "y", "q_riv_down"}`` on the host as the reference's
  ``driver.simulate`` does (``compare.py`` reads them), and calling
  *after_advance* between the interval's advance and that fetch (the
  device time's CUDA events end there);
- ``nfe``: the right-hand-side evaluations so far; ``graph_stats()``: the
  interval graph's counters, or None; ``solver_functions()``: the
  solver's ``(rhs(t, y), lin(t, y))`` with ``lin`` returning ``(_,
  jvp(v))``, or None;
- ``sim.bdf`` (its ``y``), ``sim.t`` and ``sim.interval``: the solver
  state and time after an interval, and the interval graph or None
  (``spans.py`` builds two more of its type, ``type(g)(sim, g.w_max,
  g.capture)``, and reads ``stats``, ``reset_phases()``, ``phases()``
  and ``close()``; ``calibrate.py --faults`` also wraps
  ``sim.advance_interval`` and replaces ``sim.bdf``);
- ``close()``: free the device memory before the reference runs.

A program without an interval graph (``sim.interval``, ``graph_stats()``
and ``solver_functions()`` None) leaves these readers with nothing to
read: ``graph.build_s``, ``rhs_roofline``, ``jv_roofline`` and every
reader of ``spans.py`` (``driver.host_us_per_interval``,
``setup.create_s``, ``setup.first_interval_s``, ``solver.newton_us``,
``window.head_us``, ``window.tail_us``).  ``device.*``,
``graph.launches_per_nfe`` and ``solver.nfe_per_sim_day`` read every
program.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from portbench import gen

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def clone(tree):
    """The tensors of *tree* copied, its other leaves shared."""
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class Program:
    """One cell's simulation, ready to replay its period."""

    def __init__(self, raw: dict, config: dict, traffic: dict, device,
                 where: str):
        from shud_tpu_torch.driver.fused import FusedSimulation
        from shud_tpu_torch.driver.run_fast import _to_host
        from shud_tpu_torch.io import project

        self._to_host = _to_host
        inp = gen.to_input(raw, project, where)
        self.sim = FusedSimulation.create(
            "synthetic", inp=inp, float_dtype=DTYPES[config["float"]],
            device=device, mega=config["mega"])
        on_mega = self.sim.mega is not None
        if config["path"] != ("mega" if on_mega else "edge"):
            raise RuntimeError(
                f"the configuration names the {config['path']} path, the "
                f"program took the {'mega' if on_mega else 'edge'} path")
        self.interval_min = float(traffic["interval_min"])
        span = traffic["end_min"] - traffic["start_min"]
        self.n_intervals = int(round(span / self.interval_min))
        self._start = self._work = None

    def snapshot(self) -> None:
        """Keep the start state that every replay begins from, and one set
        of tensors that each replay starts in."""
        s = self.sim
        self._start = (clone(s.bdf), clone(s.buckets), clone(s.cryo), s.t)
        self._work = clone(self._start[:3])

    def restore(self) -> None:
        """Back to the snapshot, copied into the same tensors for every
        replay (a replay may update its state in place; the graph copies
        the state in from fixed addresses)."""
        pytree.tree_map(
            lambda w, x: w.copy_(x) if isinstance(w, torch.Tensor) else w,
            self._work, self._start[:3])
        s = self.sim
        s.bdf, s.buckets, s.cryo = self._work
        s.t = self._start[3]

    def interval(self, after_advance=None) -> dict:
        """Advance one output interval and fetch its results to the host;
        returns the state ``y`` at its end and the interval-mean river
        discharge ``q_riv_down`` (what the comparison reads).
        *after_advance*: called between ``advance_interval`` and the
        fetch."""
        s = self.sim
        mean_e, mean_r, stages, qdowns = s.advance_interval(self.interval_min)
        if after_advance is not None:
            after_advance()
        host = self._to_host({
            "y": s.y_dev(), "ic": s.buckets.ic_stg, "snow": s.buckets.snow,
            "mean_e": mean_e, "mean_r": mean_r, "stages": stages,
            "qdowns": qdowns})
        return {"t": s.t, "y": host["y"],
                "q_riv_down": host["mean_r"]["q_riv_down"]}

    @property
    def nfe(self) -> int:
        return int(self.sim.bdf.nfe)

    def graph_stats(self) -> "dict | None":
        """The interval graph's counters (None where the program runs no
        graph, as on the CPU)."""
        g = self.sim.interval
        return None if g is None else dict(g.stats)

    def solver_functions(self):
        """``(rhs(t, y), lin(t, y))`` as the interval graph's solver calls
        them, on the forcing of the last window it ran (None without a
        graph)."""
        g = self.sim.interval
        if g is None:
            return None
        p = g.pieces.solver
        return p.rhs, p.lin

    def close(self) -> None:
        """Free the graph and the simulation's device memory."""
        if self.sim.interval is not None:
            self.sim.interval.close()
        self.sim = self._start = self._work = None

