"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives: ``configs/<config>.json`` (named by the
configuration's ``file``), ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the comparison's limits of the cell) and
``metrics/<metric>.py`` (a reader: ``read(probe)`` returns the metric's
value, or None where it finds nothing to read).  A configuration may also
name its own input generator, program and reference (``hooks``): every
step of a run, and ``calibrate.py``, takes them from there.
"""

from __future__ import annotations

import functools
import gc
import importlib
import importlib.util
import json
import re
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from portbench import compare, gen, trace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "shud_tpu")
# the sleep kernel queued ahead of an interval whose device time is read:
# ~50 ms at the H100's 1.98 GHz, longer than the host takes to prepare and
# launch the interval
SLEEP_CYCLES = 10**8


class Refused(Exception):
    """The run cannot be made here; nothing is printed on stdout."""


OWN = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
# what a configuration's ``generator``, ``program`` and ``reference`` keys
# name, and the names the keys take when the configuration leaves them out
DEFAULT_HOOKS = {"generator": "hillslope", "program": "program",
                 "reference": "reference"}


class Hooks(NamedTuple):
    """A configuration's own parts.  ``generator``: a module whose
    ``make(config, traffic)`` returns the watershed before its cells are
    ordered (``gen.make_raw``).  ``program``: the class of the system under
    test, with ``program.py``'s interface.  ``reference``: a package with
    ``reference/``'s layout; ``ref(name)`` is its module *name*."""

    generator: object
    program: type
    reference: object

    def ref(self, name: str):
        return importlib.import_module(f"{self.reference.__name__}.{name}")


def hook_path(bench: Path, kind: str, name: str) -> Path:
    """Where the *kind* hook *name* lives under *bench*:
    ``generators/<name>.py``; ``programs/<name>.py`` (the program named
    ``program`` is ``program.py``); the package directory ``<name>/``."""
    if kind == "generator":
        return bench / "generators" / f"{name}.py"
    if kind == "program":
        return bench / ("program.py" if name == "program"
                        else f"programs/{name}.py")
    return bench / name


def hooks(bench: Path, config: dict) -> Hooks:
    """The generator, program and reference that *config* names, found
    under *bench*; where it names none, this directory's default
    (``DEFAULT_HOOKS``).  Refused, naming the missing file, where one is
    not there."""
    found = {}
    for kind, default in DEFAULT_HOOKS.items():
        name = config.get(kind, default)
        path = hook_path(bench if kind in config else OWN, kind, name)
        if not (isinstance(name, str) and NAME.fullmatch(name)
                and (path / "__init__.py" if kind == "reference"
                     else path).is_file()):
            raise Refused(f"the configuration {config.get('name')!r} names "
                          f"the {kind} {name!r}: no {path}")
        found[kind] = load(path)
    return Hooks(found["generator"], found["program"].Program,
                 found["reference"])


def load(path: Path):
    """The module at *path*, a ``.py`` file or a package's directory,
    loaded once a process.  One of this directory whose path is made of
    identifiers is imported by its name (``portbench.reference``): the
    module that the benchmark's own imports give, whose modules import
    each other by that name.  Any other is loaded from its file under a
    name made from its path."""
    path = path.resolve()
    parts = (path.relative_to(OWN).with_suffix("").parts
             if path.is_relative_to(OWN) else ())
    if parts and all(p.isidentifier() for p in parts):
        return importlib.import_module(".".join(("portbench",) + parts))
    name = "portbench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path))
    if name in sys.modules:
        return sys.modules[name]
    package = path.is_dir()
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py" if package else path,
        submodule_search_locations=[str(path)] if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def load_cell(root: Path, spec: dict, workload: str) -> dict:
    """The cell *workload* of *spec*: its entry, configuration, traffic,
    limits, per-layer metrics and the configuration's ``hooks``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / spec["paths"][0]
    reports = {m["name"] for m in spec["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
    config = json.loads((root / entry["file"]).read_text())
    return {
        "name": workload, "chips": cell["chips"],
        "config": config, "hooks": hooks(bench, config),
        "traffic": json.loads(
            (bench / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (bench / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in spec["end_to_end"]
                       if m["name"] in reports],
        "per_layer": [m for m in spec["per_layer"]
                      if workload in m.get("workloads", [workload])
                      and m["moves"] in reports],
        "bench": bench,
    }


def reader(bench: Path, name: str):
    """The module ``metrics/<name>.py``."""
    return load(bench / "metrics" / f"{name}.py")


def measure_window(prog, seconds: float, rng) -> dict:
    """Replay the cell's period from the snapshot until *seconds* have
    passed (and one replay is whole); each interval timed from its
    ``advance_interval`` call to its results on the host.  One whole
    replay, drawn from the seed, is kept for the comparison."""
    n = prog.n_intervals
    walls, replay_walls = [], []
    sample, nfe = None, 0
    gc.collect()
    gc.disable()  # no collection pauses inside the window
    try:
        start = end = time.perf_counter()
        while not (end >= start + seconds and replay_walls):
            prog.restore()
            nfe0, r0 = prog.nfe, time.perf_counter()
            got = []
            while len(got) < n and not (end >= start + seconds
                                        and replay_walls):
                t0 = time.perf_counter()
                got.append(prog.interval())
                end = time.perf_counter()
                walls.append(end - t0)
            nfe += prog.nfe - nfe0
            if len(got) == n:
                replay_walls.append(end - r0)
                if rng.random() * len(replay_walls) < 1.0:  # uniform
                    sample = got
    finally:
        gc.enable()
    return {"wall_s": end - start, "interval_walls": walls,
            "replay_walls": replay_walls, "intervals": len(walls),
            "sim_minutes": len(walls) * prog.interval_min, "nfe": nfe,
            "sample": sample}


END_TO_END = {
    "sim_days_per_s": lambda r: r["window"]["sim_minutes"] / 1440.0
    / r["window"]["wall_s"],
    "interval_p95_ms": lambda r: 1e3 * float(
        np.percentile(r["window"]["interval_walls"], 95)),
    "peak_mem_mib": lambda r: r["peak_bytes"] / 2**20,
    "setup_s": lambda r: r["setup_s"],
}


class Probe:
    """What the per-layer readers read, each measured once on demand
    after the window: the window's totals, the set-up's graph counters,
    the device time and wall of whole replays without the profiler, the
    work and device time of one RHS and one J·v at the state the
    traffic's ``profile_interval`` ends in, and that interval profiled.
    ``unprofiled_first`` takes the readings without the profiler before
    the profiled one, the replays' device time first of all: replays made
    after the profiled interval and the RHS and J·v graphs ran slower
    (edge-131k on an H100: 1.46 s against the window's 0.96 s)."""

    def __init__(self, prog, run: dict, raw: dict, cell: dict, kind: str):
        self.prog, self.raw, self.cell, self.kind = prog, raw, cell, kind
        self.window = run["window"]
        self.graph_stats = run["graph_stats"]

    def unprofiled_first(self) -> None:
        self.device_time, self.rhs_seconds, self.jv_seconds

    @functools.cached_property
    def profile(self) -> dict:
        """One interval (the traffic's ``profile_interval``) of a replay
        under the profiler, with its NFE."""
        k = int(self.cell["traffic"].get("profile_interval", 0))
        self.prog.restore()
        for _ in range(k):
            self.prog.interval()
        nfe0 = self.prog.nfe
        p = trace.profile_call(self.prog.interval)
        p["nfe"] = self.prog.nfe - nfe0
        return p

    @functools.cached_property
    def device_time(self) -> dict:
        """The card's time in a whole replay, without the profiler:
        ``busy_s``, each interval's ``advance_interval`` from its first
        device operation to its last (CUDA events, the host's preparation
        and launch hidden behind a sleep kernel queued ahead of it: the
        one read of the solver's scalars inside it stays), ``wall_s``, a
        replay's wall unprofiled and unslowed, the two taken alternately,
        medians of three each; and the replay's ``nfe``."""
        import torch

        prog, n = self.prog, self.prog.n_intervals
        busy, walls = [], []
        gc.collect()
        gc.disable()
        try:
            for _ in range(3):
                prog.restore()
                nfe0, total = prog.nfe, 0.0
                for _ in range(n):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(SLEEP_CYCLES)
                    e0.record()
                    prog.interval(after_advance=e1.record)
                    total += e0.elapsed_time(e1) / 1e3
                busy.append(total)
                nfe = prog.nfe - nfe0
                prog.restore()
                t0 = time.perf_counter()
                for _ in range(n):
                    prog.interval()
                walls.append(time.perf_counter() - t0)
        finally:
            gc.enable()
        return {"busy_s": statistics.median(busy),
                "wall_s": statistics.median(walls), "nfe": nfe}

    @functools.cached_property
    def work(self) -> dict:
        width = 4 if self.cell["config"]["float"] == "float32" else 8
        return work.evaluation_work(self.raw, width,
                                    self.cell["hooks"].reference)

    @functools.cached_property
    def _functions(self):
        """The solver's ``(rhs, lin)`` at the state and forcing an
        unprofiled replay reaches at the end of the traffic's
        ``profile_interval`` (None without a graph)."""
        k = int(self.cell["traffic"].get("profile_interval", 0))
        self.prog.restore()
        for _ in range(k + 1):
            self.prog.interval()
        fns = self.prog.solver_functions()
        if fns is None:
            return None
        import torch

        y = self.prog.sim.bdf.y.clone()
        t = torch.full((), float(self.prog.sim.t), dtype=y.dtype,
                       device=y.device)
        return fns, t, y

    @functools.cached_property
    def rhs_seconds(self) -> "float | None":
        got = self._functions
        if got is None:
            return None
        (rhs, _), t, y = got
        return graph_seconds(lambda: rhs(t, y))

    @functools.cached_property
    def jv_seconds(self) -> "float | None":
        got = self._functions
        if got is None:
            return None
        (_, lin), t, y = got
        _, jvp = lin(t, y)
        v = y * 1e-3 + 1e-4
        return graph_seconds(lambda: jvp(v))


def graph_seconds(fn, inner: int = 20, reps: int = 10) -> float:
    """Device seconds a call of *fn*: *inner* calls captured in one CUDA
    graph (after a warm-up on a side stream), the graph replayed warm,
    CUDA events around *reps* replays; the median of five such samples."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            g.replay()
        e1.record()
        e1.synchronize()
        samples.append(e0.elapsed_time(e1) / 1e3 / (reps * inner))
    del g
    return statistics.median(samples)


def check_device(chips: int) -> dict:
    """The card, or Refused without enough of them."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} are visible")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(cell: dict, run: dict) -> dict:
    """The cell's end-to-end metrics of *run* (its ``setup_s``,
    ``window`` and ``peak_bytes``)."""
    return {m["name"]: {"value": float(END_TO_END[m["name"]](run)),
                        "unit": m["unit"]} for m in cell["end_to_end"]}


def per_layer(cell: dict, probe: Probe) -> dict:
    """The cell's per-layer metrics that their readers find."""
    out = {}
    for m in cell["per_layer"]:
        value = reader(cell["bench"], m["name"]).read(probe)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check(raw: dict, cell: dict, sample: list, device, where: str) -> tuple:
    """The cell's reference's run of *raw* against the program's replay
    *sample*: (the numbers, the intervals over a limit)."""
    h = cell["hooks"]
    ref = h.ref("driver").simulate(gen.to_input(raw, h.ref("project"), where),
                                   float(cell["traffic"]["interval_min"]),
                                   device)
    numbers, per = compare.gaps(sample, ref, cell["config"]["control"])
    return numbers, compare.failed_intervals(per, cell["limits"])


def result_line(metrics: dict, numbers: dict, failed: int, limits: dict,
                attempted: int, device: dict, breakdown=None) -> dict:
    """The run's last line; the numbers compared, each beside its limit,
    come last."""
    result = {"metrics": metrics}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(correct=compare.judge(numbers, limits),
                  attempted=attempted, failed=failed, device=device)
    result["compared"] = compare.report(numbers, limits)
    return result


def run_cell(root: Path, spec: dict, workload: str, seed: int,
             seconds: float, traced: bool, t_start: float) -> dict:
    """One run on the card; returns the result line (a dict)."""
    import torch

    torch.set_num_threads(1)
    cell = load_cell(root, spec, workload)
    dev_info = check_device(cell["chips"])
    raw = gen.make_raw(cell["config"], cell["traffic"],
                       generator=cell["hooks"].generator)
    where = str(root / "build")
    torch.cuda.reset_peak_memory_stats()
    if traced:
        # the profiler's CUDA tracing started before the interval graph is
        # instantiated, so that the graph's kernels are traced
        trace.start_tracing()
    prog = cell["hooks"].program(raw, cell["config"], cell["traffic"], "cuda",
                                 where)
    prog.snapshot()
    prog.interval()  # builds the interval graph; warms the fetch
    prog.restore()
    torch.cuda.synchronize()
    run = {"setup_s": time.perf_counter() - t_start}
    run["window"] = measure_window(
        prog, seconds, np.random.default_rng([seed % 2**63, 1]))
    run["peak_bytes"] = torch.cuda.max_memory_allocated()
    w = run["window"]
    walls = sorted(w["replay_walls"])
    print(f"window: {w['intervals']} intervals, replay walls (s) "
          f"{walls[::max(len(walls) // 4, 1)]}", file=sys.stderr)
    run["graph_stats"] = prog.graph_stats()
    breakdown = None
    if traced:
        probe = Probe(prog, run, raw, cell, dev_info["kind"])
        probe.unprofiled_first()
        d = probe.device_time
        print(f"unprofiled replays: device {d['busy_s']!r} s, wall "
              f"{d['wall_s']!r} s", file=sys.stderr)
        metrics = per_layer(cell, probe)
        p = probe.profile
        dev_info.update(busy_s=p["busy_s"], window_s=p["wall_s"])
        breakdown = {"device_ops": p["device_ops"],
                     "idle_gaps": p["idle_gaps"]}
    else:
        metrics = end_to_end(cell, run)
    prog.close()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    # the reference, once the window has closed and the program is freed
    numbers, failed = check(raw, cell, w["sample"], "cuda", where)
    dev_info["memory_peak_bytes"] = run["peak_bytes"]
    return result_line(metrics, numbers, failed, cell["limits"],
                       w["intervals"], dev_info, breakdown)
