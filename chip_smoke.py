#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (shud_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the main-path runs below
    python3 chip_smoke.py --sim-minutes 60  # shorter main-path runs

Two paths, both run_project_fast in float32 on the card: the megakernel
path at 32,768 cells for one simulated day (one kernel call per RHS, J·v
and diagnostics, csrc/mega.cu) and the edge-flux path at 131,072 cells
over the storm's first six hours (eager RHS with the edge trio,
csrc/edge_flux.cu, linearized once per Newton iteration by
rhs.linearize).  Phases (any failed check raises
and the script exits nonzero; nothing falls back to the CPU):
 1. the card (nvidia-smi name and power limit), exit if CUDA is absent;
 2. build both CUDA sources (one nvcc each, in parallel); registers and
    spills of every kernel;
 3. the meshes: 131,072 and 32,768 cells, shuffled then RCM-localised,
    storm from minute 720; an 8,192-cell lake mesh; a 32,768-cell mesh
    with a branched river network;
 4. each edge kernel against its plain PyTorch version (both boundary
    modes, every 7th cell dry); per-call times (CUDA events, median of
    20), profiler device time, and the bound;
 5. each mega kernel against its plain version on the 32k, lake and
    branched meshes, both boundary modes: mega_rhs and mega_jvp bitwise
    and mega_diag bitwise equal, all bitwise repeatable; times and
    bound as in 4, the device launches of one call (1 each), the
    registers of the three instantiations of the fused kernel, and the
    fixed cost of its design (an empty cooperative launch with 0, 1 and 2
    grid barriers at the 32k grid); 4 and 5 also time each kernel with a
    cold L2 (a 64 MB buffer written before each call);
 6. the full f32 RHS and J·v: edge kernels vs plain at 131k (and the lake
    mesh), and the J·v as the solver calls it (rhs.linearize, one
    edge_coeff call, then one edge_apply call per vector) against
    torch.func.jvp of rhs, with the kernels and on the plain versions;
    mega vs eager at 32k, and the J·v as the solver calls it
    (linearize_mega) beside torch.func.jvp of rhs_mega;
 7. each main path with every launch count set to 0 just before and read
    just after: at 131k edge_coeff once per Newton iteration, edge_apply
    krylov_m times and edge_flux once a window (the diagnostics; the run
    has no water-balance quadrature), no mega kernel; at 32k the mega
    trio and no edge kernel, mega_rhs once per Newton iteration, mega_jvp
    krylov_m times and mega_diag once a window; output file set and
    finite values;
 8. 6 storm windows on each kernel path beside its references, window by
    window, NFE within 2%: at 131k the plain f32 path, state within
    2e-5 m; at 32k the mega path on the kernels' plain versions, state
    within 2e-5 m (bitwise equal so far), and the eager path with the
    edge kernels, state within 2e-5 m while the eager float32 and float64
    runs are (the storm then brings cells to the infiltration switch,
    where any two roundings part: PERF.md section 6); one window twice,
    bitwise identical;
 9. the cryosphere: a frosty window (-4.5 C, the frozen fractions below 1
    for a day) and 6 storm windows on each kernel path beside its
    reference, NFE within 2%: at 32k the mega kernels bitwise equal to
    the mega path on their plain versions, at 131k the edge kernels
    within 2e-5 m of the plain f32 path;
10. the per-window driver (Simulation.advance_window) at 131k over 6
    storm windows beside FusedSimulation: within 2e-5 m, NFE within 2%;
11. the command line in fresh processes: python -m shud_tpu_torch -h
    exits 0, -g --f32 exits nonzero (-g runs float64 only);
12. one storm window of each path under torch.profiler: device busy time,
    idle share, launches per NFE, mega kernel launches per NFE (reported,
    not checked);
13. the operator-split driver (run_project_split, -g, float64) over the 6
    storm windows at 32k and on the lake mesh against the fused float64
    eager driver: every block within 5e-3 m (the lake stage 5e-2 m); the
    sub-solvers' steps and NFE, the wall per window; no kernel launched;
14. the fixed-step float64 truth (fixed_bdf1 with rhs.linearize) over the
    6 storm windows at 32k from a 12-hour spin-up, h = 0.5 min against
    h = 0.25 min within 1e-4 m after every window; eager f64, eager f32
    with the edge kernels and the mega path each within 5e-4 m of it on
    gw heads and river stages after every window;
15. NetCDF: the 32k project's forcing as a CMFD2 NetCDF-3 set (scipy),
    the decoded table equal to the written one, the mega path forced
    from it bitwise equal (else within 2e-5 m) to the CSV-forced run;
    OUTPUT_MODE NETCDF refused naming h5py where h5py is absent, else
    written and read back;
16. the 131k mesh refined twice (2,097,152 cells): the edge-kernel path
    beside the plain path over the 6 storm windows within 2e-5 m, with
    phase 7's launch counts; set-up time, wall per window, peak memory;
17. the sharded driver (shud_tpu_torch/parallel) at 131k: the partition
    (build time, np_cells, halo per round, rounds K), the edge trio at one
    shard's shape against its plain versions, then 4 ranks on this card
    over gloo (explicit host staging), 6 storm windows in f32 with the
    edge kernels beside the same on their plain versions (2e-5 m) and
    beside the single-device f32 edge path (2e-5 m under phase 8's rule,
    NFE within 2%); every rank the same steps, NFE and Newton iterations,
    and per rank edge_coeff once per Newton iteration, edge_apply
    krylov_m times and edge_flux once a window; run_project_sharded over
    one simulated hour writes run_project_fast's file set, the same
    headers, payloads within 1e-4; NCCL with 2 ranks where 2 GPUs exist;
18. the autocalibration tools (shud_tpu_torch.tools) at 32k, a twin
    experiment over 3 days in f32: the objective at the truth scores NSE
    >= 1 - 1e-9; the search (4 candidates from the default calibration)
    with the mega trio's launch counts (mega_rhs = Newton iterations,
    mega_jvp = krylov_m times, mega_diag = windows, no edge kernel) and
    the card's memory after each candidate within 1 MiB of the first's;
    an NFE budget below day 0's aborts after day 1 with 5.0; the
    tournament over {truth, default} writes the truth; the tool's -h in a
    fresh process.  Set-up and wall per candidate-day reported.
The line before the last is a JSON object of the six kernels; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EDGE_SOURCE = "shud_tpu_torch/csrc/edge_flux.cu"
MEGA_SOURCE = "shud_tpu_torch/csrc/mega.cu"
REPLACES = {
    "edge_flux": "shud_tpu/core/pallas_edge.py:480",
    "edge_coeff": "shud_tpu/core/pallas_edge.py:532",
    "edge_apply": "shud_tpu/core/pallas_edge.py:664",
}
MEGA_REPLACES = {
    "mega_rhs": "shud_tpu/core/pallas_mega.py:1446",
    "mega_jvp": "shud_tpu/core/pallas_mega.py:1478",
    "mega_diag": "shud_tpu/core/pallas_mega.py:1461",
}
# device kernel launches per call: one cooperative launch of the fused
# kernel each (csrc/mega.cu)
MEGA_DEVICE_LAUNCHES = {"mega_rhs": 1, "mega_jvp": 1, "mega_diag": 1}
# bars: the Pallas edge kernel's against XLA (tests/test_pallas_edge.py)
BAR_Q_SURF = 2e-6
BAR_Q_SUB = 1e-6
BAR_TANGENT = 1e-6
BAR_RHS = 2e-6
BAR_DRIVER = 2e-5  # [m], tests/test_pallas_mega.py:254
# mega kernels vs their plain versions, scaled per field (reported; built
# without fused multiply-adds, each is gated bitwise equal to its plain
# version as well): dY and each diagnostic 2e-6, J·v 1e-5
BAR_MEGA_RHS = 2e-6
BAR_MEGA_JVP = 1e-5
# the mega RHS vs the eager RHS, scaled: the JAX package's megakernel
# against its XLA path (tests/test_pallas_mega.py, scaled 2e-5)
BAR_RHS_PATHS = 2e-5
DEVICE = "cuda"
# (nx, ny) of make_synthetic_project, 2 nx ny cells: the edge-flux path,
# the mega path (the JAX package's 32,768-cell ceiling), the lake mesh
EDGE_MESH, MEGA_MESH, LAKE_MESH = (256, 256), (128, 128), (64, 64)
# the edge path's main-path run, (start, minutes): the storm's first six
# hours, minutes 720-1080 (six hours rather than the whole day, so that
# the script with phases 13-16 stays near 300 s)
EDGE_MAIN_SPAN = (720.0, 360.0)
# storm windows of 10 minutes on each kernel path against its references
STORM_WINDOWS = 6
# the cryosphere phase: one window at this temperature [C] before the
# storm, whose first accumulator flush holds for a day: fu_surf
# 1 - (-1 + 4.5) / 4 = 0.125, fu_sub 1 - (-3 + 4.5) / 7 = 0.786 (the
# calibration's default bounds)
FROST_C = -4.5
# the operator-split (-g) driver against the implicit one after the storm
# windows [m]: tests/test_driver.py:309-316 (the lake stage integrates the
# frozen-inflow Gauss-Seidel error, hence its own bound)
SPLIT_BAR, SPLIT_BAR_LAKE = 5e-3, 5e-2
# the fixed-step truth: step [min], sized so that the h and h/2 truths
# agree within TRUTH_SELF [m] (tools/verify_trajectory.py's
# self-convergence); each adaptive path within TRUTH_BAR [m] of it on gw
# heads and river stages (tests/test_solver.py:104-105)
TRUTH_H, TRUTH_SELF, TRUTH_BAR = 0.5, 1e-4, 5e-4
# the refined mesh: the edge path's 131k mesh split 4:1 this many times
REFINE_LEVELS = 2
# the sharded driver's ranks on the one card (gloo, host staging)
SHARDS = 4
# the calibration's twin experiment: the truth it recovers, the simulated
# days of a candidate, and the search's generations and population
CALIB_TRUTH = {"geol_ksath": 0.3, "lc_rough": 2.0}
CALIB_DAYS, CALIB_GENS, CALIB_POP = 3, 1, 4

# written before each call of a cold-L2 time: above the H100's 50 MB L2
FLUSH_BYTES = 64 << 20
# the bound: NVIDIA's published H100 SXM peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations (one per add, multiply, divide, compare-and-select, square
# root or transcendental) per entity, counted from the sources: per edge
# for the edge kernels (edge_flux.cu), per cell (its pointwise physics,
# three edges and assembly), segment and reach for the mega kernels
# (mega.cu)
EDGE_OPS = {"edge_flux": 45, "edge_coeff": 110, "edge_apply": 10}
MEGA_OPS = {
    "mega_rhs": {"cell": 290, "seg": 40, "reach": 55},
    "mega_jvp": {"cell": 590, "seg": 80, "reach": 110},
    "mega_diag": {"cell": 280, "seg": 40, "reach": 35},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def scaled_err(ref, got) -> float:
    ref = ref.double()
    scale = float(ref.abs().max()) or 1.0
    return float((ref - got.double()).abs().max()) / scale


def abs_err(ref, got) -> float:
    return float((ref.double() - got.double()).abs().max())


def time_ms(fn, reps: int = 20) -> float:
    """Median per-call device time of *fn* with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_per_call(fn, reps: int = 20, tries: int = 3):
    """Device time (ms) and device launches per call of *fn* from
    torch.profiler, or (None, None) when it records no device time in
    *tries* sessions (a session on the card has come back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if _self_device_us(r) > 0]
        busy_us = sum(_self_device_us(r) for r in rows)
        if busy_us > 0:
            return busy_us / 1e3 / reps, sum(r.count for r in rows) / reps
    return None, None


def device_ms(fn, before=None, n: int = 1, reps: int = 20) -> float:
    """Median device time (ms) of *n* back-to-back calls of *fn*, divided
    by *n*: CUDA events around the calls, queued behind a spin kernel
    (torch.cuda._sleep) so that the host's enqueueing is hidden and the
    events time the device alone.  *before* runs ahead of each sample,
    outside the events (the L2 flush)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda._sleep(1_000_000 + 40_000 * n)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def cold_l2(fn, reps: int = 20) -> dict:
    """*fn* with a cold L2: FLUSH_BYTES written before each call.  Device
    time per call from CUDA events (device_ms) and from the profiler's
    device rows of *fn*'s own launches (those of the write left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(FLUSH_BYTES // 4, device=DEVICE)

    def flush():
        buf.fill_(1.0)

    ev_ms = device_ms(fn, before=flush, reps=reps)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as p0:
        flush()
        torch.cuda.synchronize()
    flush_keys = {r.key for r in p0.key_averages() if _self_device_us(r) > 0}
    with profile(activities=acts) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages()
            if _self_device_us(r) > 0 and r.key not in flush_keys]
    prof_ms = (sum(_self_device_us(r) for r in rows) / 1e3 / reps
               if rows else None)
    return {"event_device_ms": ev_ms, "profiler_device_ms": prof_ms}


def _self_device_us(row) -> float:
    """Device time of a profiler row that runs on the device (a kernel, a
    copy or a fill); 0 for host operators, whose rows repeat the time of
    the kernels they launched."""
    from torch.autograd import DeviceType

    if getattr(row, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return float(getattr(row, "self_device_time_total",
                         getattr(row, "self_cuda_time_total", 0.0)) or 0.0)


def storm_project(nx: int, ny: int, end_day: float, with_lake=False,
                  localize=True):
    """The synthetic watershed with the forcing shifted half a day earlier,
    so the storm starts at minute 720 of the first day."""
    import numpy as np

    from shud_tpu_torch.utils.reorder import localize_project, permute_project
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(nx, ny, end_day=end_day, with_lake=with_lake)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]
    if localize:
        ne = inp.tri.shape[0]
        perm = np.random.default_rng(0).permutation(ne)
        inp, _ = localize_project(permute_project(inp, perm))
    return inp


def random_slice(md, dtype, device, seed):
    import numpy as np
    import torch

    from shud_tpu_torch.core.state import ForcingSlice

    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=device).to(dtype)

    fs = ForcingSlice(
        net_prcp=t(rng.uniform(0, 2e-5, ne)), prcp=t(rng.uniform(0, 2e-5, ne)),
        pot_evap=t(rng.uniform(0, 1e-6, ne)),
        pot_tran=t(rng.uniform(0, 1e-6, ne)), e_ic=t(rng.uniform(0, 1e-7, ne)),
        lai=t(np.full(ne, 2.0)), fu_surf=t(np.ones(ne)), fu_sub=t(np.ones(ne)),
        ele_ybc=t(np.zeros(ne)), ele_qbc=t(np.zeros(ne)),
        ele_qss=t(np.zeros(ne)), riv_ybc=t(np.zeros(nr)),
        riv_qbc=t(np.zeros(nr)),
    )
    sf = rng.uniform(0, 0.05, ne)
    sf[::7] = 0.0
    y = np.concatenate([sf, rng.uniform(0, 1.0, ne), rng.uniform(0, 8.0, ne),
                        rng.uniform(0, 1.0, nr), rng.uniform(0.5, 2.0, nl)])
    return fs, t(y)


def phase_kernels(md, torch, edge, results, device_times):
    """Phase 4: each kernel vs its plain version on the card."""
    import numpy as np

    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import update_element

    f32, dev = torch.float32, torch.device(DEVICE)
    dm = to_torch(md, f32, dev)
    et = dm.edge_tables
    ne = md.num_ele
    rng = np.random.default_rng(1)
    sf = rng.uniform(0, 0.05, ne)
    sf[::7] = 0.0  # exactly-dry cells exercise the tie conventions
    gw = rng.uniform(0, 8.0, ne)
    us = rng.uniform(0, 1.0, ne)

    def t(a):
        return torch.as_tensor(a, device=dev).to(f32)

    sf, gw, us = t(sf), t(gw), t(us)
    kh = update_element(dm, sf, us, gw).eff_kh.contiguous()
    tan = [t(rng.standard_normal(ne)) for _ in range(3)]
    err = {k: 0.0 for k in REPLACES}
    for cb in (True, False):
        qk = edge.edge_flux(sf, gw, kh, et, cb)
        qp = edge.edge_flux_plain(sf, gw, kh, et, cb)
        torch.cuda.synchronize()
        e_s, e_b = scaled_err(qp[0], qk[0]), scaled_err(qp[1], qk[1])
        log(f"  edge_flux  cb={cb}: q_surf {e_s:.3e} q_sub {e_b:.3e}")
        check(e_s <= BAR_Q_SURF and e_b <= BAR_Q_SUB, "edge_flux disagrees")
        err["edge_flux"] = max(err["edge_flux"], abs_err(qp[0], qk[0]),
                               abs_err(qp[1], qk[1]))

        ck = edge.edge_coeff(sf, gw, kh, et, cb)
        cp = edge.edge_coeff_plain(sf, gw, kh, et, cb)
        torch.cuda.synchronize()
        errs = [scaled_err(p, k) for p, k in zip(cp, ck)]
        log("  edge_coeff cb=%s: q %.3e %.3e coeffs %s" % (
            cb, errs[0], errs[1], " ".join(f"{e:.3e}" for e in errs[2:])))
        check(errs[0] <= BAR_Q_SURF and errs[1] <= BAR_Q_SUB
              and max(errs[2:]) <= BAR_TANGENT, "edge_coeff disagrees")
        err["edge_coeff"] = max([err["edge_coeff"]]
                                + [abs_err(p, k) for p, k in zip(cp, ck)])

        ak = edge.edge_apply(cp[2:], *tan, et)
        ap = edge.edge_apply_plain(cp[2:], *tan, et)
        torch.cuda.synchronize()
        e_s, e_b = scaled_err(ap[0], ak[0]), scaled_err(ap[1], ak[1])
        log(f"  edge_apply cb={cb}: tq_surf {e_s:.3e} tq_sub {e_b:.3e}")
        check(e_s <= BAR_TANGENT and e_b <= BAR_TANGENT, "edge_apply disagrees")
        err["edge_apply"] = max(err["edge_apply"], abs_err(ap[0], ak[0]),
                                abs_err(ap[1], ak[1]))

    # per-call times at the main path's shapes and boundary mode (closed)
    coeffs = edge.edge_coeff_plain(sf, gw, kh, et, True)[2:]
    tables = edge._table_list(et)
    n_edges = 3 * ne
    calls = {
        "edge_flux": (lambda: edge.edge_flux(sf, gw, kh, et, True),
                      lambda: edge.edge_flux_plain(sf, gw, kh, et, True),
                      nbytes(sf, gw, kh, *tables) + 2 * 4 * n_edges),
        "edge_coeff": (lambda: edge.edge_coeff(sf, gw, kh, et, True),
                       lambda: edge.edge_coeff_plain(sf, gw, kh, et, True),
                       nbytes(sf, gw, kh, *tables) + 8 * 4 * n_edges),
        "edge_apply": (lambda: edge.edge_apply(coeffs, *tan, et),
                       lambda: edge.edge_apply_plain(coeffs, *tan, et),
                       nbytes(*tan, et.nabr, *coeffs) + 2 * 4 * n_edges),
    }
    for name, (kern, plain, n_bytes) in calls.items():
        timed(name, kern, plain, n_bytes, EDGE_OPS[name] * n_edges,
              err[name], results, device_times)


def timed(name, kern, plain, n_bytes, n_ops, max_abs_err, results,
          device_times):
    """Time a kernel's wrapper and its plain version (CUDA events and
    profiler device time) and record them beside the kernel's bound."""
    ms, plain_ms = time_ms(kern), time_ms(plain)
    dev_ms, dev_launches = device_per_call(kern)
    dev_plain_ms, _ = device_per_call(plain)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    # events around one launch also hold the device's launch latency
    # (~4 us), so the cold kernel alone is its profiler time plus the
    # cold-minus-warm difference of the events
    warm_ms, cold = device_ms(kern), cold_l2(kern)
    cold["kernel_ms"] = (None if dev_ms is None
                         else dev_ms + cold["event_device_ms"] - warm_ms)
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call "
        f"(CUDA events); device time {dev_ms} ms in {dev_launches} "
        f"launches vs {dev_plain_ms} ms (profiler); bound {bound_ms:.5f} ms "
        f"({bound_by}: {n_bytes} B, {n_ops} ops)")
    log(f"    one launch, events: warm L2 {warm_ms:.5f} ms, cold L2 "
        f"{cold['event_device_ms']:.5f} ms; cold kernel alone "
        f"{cold['kernel_ms']} ms, bound {bound_ms:.5f} ms (profiler, cold: "
        f"{cold['profiler_device_ms']} ms)")
    results[name] = {"max_abs_err": max_abs_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
    device_times[name] = {"device_ms": dev_ms,
                          "plain_device_ms": dev_plain_ms,
                          "device_launches_per_call": dev_launches,
                          "event_device_ms": warm_ms, "cold_l2": cold,
                          "bound_ms": bound_ms}


def phase_rhs(md, lake_md, torch, summary):
    """Phase 6: the full f32 RHS with vs without the kernels; at 131k the
    J·v as the solver calls it (rhs.linearize) against torch.func.jvp of
    rhs, with the kernels and on their plain versions."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import linearize, rhs

    dev = torch.device(DEVICE)
    for name, mesh in (("131k", md), ("lake64", lake_md)):
        fs, y = random_slice(mesh, torch.float32, dev, seed=2)
        dm_k = to_torch(mesh, torch.float32, dev)
        dm_p = to_torch(mesh, torch.float32, dev, edge_kernel=False)
        cb = True
        dy_k = rhs(dm_k, fs, 0.0, y, cb)
        dy_p = rhs(dm_p, fs, 0.0, y, cb)
        torch.cuda.synchronize()
        e = scaled_err(dy_p, dy_k)
        log(f"  rhs {name}: dY scaled err {e:.3e}")
        check(e <= BAR_RHS, f"rhs with kernels disagrees on {name}")
        if name != "131k":
            continue
        v = torch.randn(y.shape[0], device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(3))

        def jv(dm):
            return torch.func.jvp(lambda yy: rhs(dm, fs, 0.0, yy, cb),
                                  (y,), (v,))[1]

        jk, jp = jv(dm_k), jv(dm_p)
        torch.cuda.synchronize()
        e = scaled_err(jp, jk)
        log(f"  J.v {name}: scaled err {e:.3e}")
        check(e <= BAR_RHS, "J.v with kernels disagrees")
        # the solver's J·v: linearized once (the coefficient kernel in the
        # primal), then one apply kernel and tensor arithmetic a vector
        for dm, ref, what in ((dm_k, jk, "kernels"), (dm_p, jp, "plain")):
            dy_h, jv_h = linearize(dm, fs, 0.0, y, cb)
            dy_r = rhs(dm, fs, 0.0, y, cb)
            got = jv_h(v)
            torch.cuda.synchronize()
            e_dy, e_jv = scaled_err(dy_r, dy_h), scaled_err(ref, got)
            log(f"  linearize {name} ({what}): dY scaled err {e_dy:.3e} "
                f"(bitwise {torch.equal(dy_r, dy_h)}), J.v vs "
                f"torch.func.jvp scaled err {e_jv:.3e}")
            check(e_dy <= BAR_RHS and e_jv <= BAR_RHS,
                  f"rhs.linearize disagrees with rhs / torch.func.jvp "
                  f"({what})")
        _, jv_h = linearize(dm_k, fs, 0.0, y, cb)
        summary["rhs_ms"] = time_ms(lambda: rhs(dm_k, fs, 0.0, y, cb))
        summary["rhs_plain_ms"] = time_ms(lambda: rhs(dm_p, fs, 0.0, y, cb))
        summary["jvp_ms"] = time_ms(lambda: jv(dm_k))
        summary["jvp_plain_ms"] = time_ms(lambda: jv(dm_p))
        summary["linearize_ms"] = time_ms(
            lambda: linearize(dm_k, fs, 0.0, y, cb))
        summary["jvp_solver_ms"] = time_ms(lambda: jv_h(v))
        log("  rhs per eval: kernel %.3f ms, plain %.3f ms; J.v by "
            "torch.func.jvp: kernel %.3f ms, plain %.3f ms; as the solver "
            "calls it: linearize %.3f ms, then %.3f ms a J.v (CUDA events)"
            % (summary["rhs_ms"], summary["rhs_plain_ms"],
               summary["jvp_ms"], summary["jvp_plain_ms"],
               summary["linearize_ms"], summary["jvp_solver_ms"]))


def mega_slice(md, device, seed):
    """Forcing, state and tangent for the mega kernels on the card
    (``tests/torch_variants.mega_inputs``: non-unit fu_surf/fu_sub, BC
    values, and exact ties: dry cells, empty unsaturated layers, water
    tables at the surface, empty reaches)."""
    import torch
    from torch_variants import mega_inputs

    from shud_tpu_torch.core.state import ForcingSlice

    fs, y, v = mega_inputs(md, seed)

    def t(a):
        return torch.as_tensor(a, device=device)

    return ForcingSlice(**{k: t(a) for k, a in fs.items()}), t(y), t(v)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the f32 peak (3.35 TB/s, 67 TFLOP/s)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mega_work(t, f, kernel: str, close_boundary: bool = True):
    """Bytes a mega kernel must move in one call on these tables, and the
    operations it does.  Bytes: each table row and forcing field the
    kernel reads for this mesh and boundary mode, once (csrc/mega.cu):
    the lake tables only on a lake mesh, the open-boundary fields only
    with an open boundary, a BC value only where its flag is set, no
    assembly fields for the diagnostics; the state (and tangent) once and
    the output once."""
    from shud_tpu_torch.core import mega

    diag, rhs = kernel == "mega_diag", kernel == "mega_rhs"
    lake = t.nl > 0

    def rows(table, names, fields):
        return sum(4 * table[names.index(k)].numel() for k in fields)

    cell_i = ["ibc_pos"] + (["ibc_neg", "iss_pos", "iss_neg"] if rhs else [])
    n_bytes = (
        rows(t.cell_f, mega.CELL_F, [k for k in mega.CELL_F if not (
            (k == "rough" and close_boundary)
            or (k in ("area", "sy") and diag))])
        + rows(t.cell_i, mega.CELL_I, cell_i + (["is_lake"] if lake else []))
        + rows(t.edge_f, mega.EDGE_F, ["B", "dist", "ravg", "dzs", "dzb"]
               + ([] if close_boundary else ["d2e"])
               + (["lk_dzl", "lk_dzb"] if lake else []))
        + rows(t.edge_i, mega.EDGE_I, ["nbq", "m_int"]
               + ([] if close_boundary else ["m_bnd"])
               + (["m_lake", "lk_id"] if lake else []))
        + nbytes(t.seg_f, t.seg_i, t.riv_f, t.seg_to_ele, t.seg_to_riv,
                 t.riv_up, f.segfu)
        + rows(t.riv_i, mega.RIV_I, ["has_down", "dn", "crit_out",
                                     "to_lake", "bc_pos"])
        + (nbytes(t.edge_to_lake, t.riv_to_lake, t.lake_zmin, t.bathy_y,
                  t.bathy_a, f.flake) if lake else 0)
        + rows(f.fcell, mega.FORC_CELL, ["net_prcp", "pot_evap", "pot_tran",
                                         "e_ic", "lai", "fu_surf", "fu_sub"])
        + (0 if diag else rows(f.friv, mega.FORC_RIV, ["riv_qbc"])))
    # BC values, read where their flag is set
    flags = {k: t.cell_i[mega.CELL_I.index(k)] > 0 for k in mega.CELL_I}
    n_bc = int(flags["ibc_pos"].sum())
    if rhs:
        n_bc += int(flags["ibc_neg"].sum())
        n_bc += int((flags["iss_pos"] | flags["iss_neg"]).sum())
    n_bc += int((t.riv_i[mega.RIV_I.index("bc_pos")] > 0).sum())
    n = 3 * t.ne + t.nr + t.nl
    n_state = 2 if kernel == "mega_jvp" else 1
    n_out = mega.diag_size(t) if diag else n
    per = MEGA_OPS[kernel]
    return (n_bytes + 4 * n_bc + 4 * n * n_state + 4 * n_out,
            per["cell"] * t.ne + per["seg"] * t.ns + per["reach"] * t.nr)


def phase_mega_kernels(meshes, torch, mega, results, device_times):
    """Each mega kernel against its plain version on the card: 32,768-cell,
    8,192-cell lake and branched meshes, both boundary modes; bitwise
    repeatable; per-call times at the main path's shapes."""
    dev = torch.device(DEVICE)
    err = {k: 0.0 for k in MEGA_REPLACES}
    for name, md in meshes.items():
        t = mega.build_mega_tables(md).to(dev)
        fs, y, v = mega_slice(md, dev, seed=4)
        f = mega.pack_forcing(t, fs)
        for cb in (True, False):
            outs = [mega.mega_rhs(t, f, y, cb), mega.mega_jvp(t, f, y, v, cb),
                    mega.mega_diag(t, f, y, cb)]
            again = [mega.mega_rhs(t, f, y, cb),
                     mega.mega_jvp(t, f, y, v, cb), mega.mega_diag(t, f, y, cb)]
            plain = [mega.mega_rhs_plain(t, f, y, cb),
                     mega.mega_jvp_plain(t, f, y, v, cb),
                     mega.mega_diag_plain(t, f, y, cb)]
            torch.cuda.synchronize()
            for kname, a, b in zip(MEGA_REPLACES, outs, again):
                check(torch.equal(a, b), f"{kname} not bitwise repeatable")
            ne, nr = t.ne, t.nr
            cuts = {"sf": (0, ne), "us": (ne, 2 * ne), "gw": (2 * ne, 3 * ne),
                    "riv": (3 * ne, 3 * ne + nr), "lake": (3 * ne + nr, None)}
            worst = {}
            for kname, k_out, p_out, bar in (
                    ("mega_rhs", outs[0], plain[0], BAR_MEGA_RHS),
                    ("mega_jvp", outs[1], plain[1], BAR_MEGA_JVP)):
                errs = {fld: scaled_err(p_out[a:b], k_out[a:b])
                        for fld, (a, b) in cuts.items()
                        if p_out[a:b].numel()}
                worst[kname] = max(errs.values())
                check(worst[kname] <= bar,
                      f"{kname} disagrees on {name} cb={cb}: {errs}")
            kd, pd = mega.diag_dict(t, outs[2]), mega.diag_dict(t, plain[2])
            errs = {k: scaled_err(pd[k], kd[k]) for k in pd}
            worst["mega_diag"] = max(errs.values())
            check(worst["mega_diag"] <= BAR_MEGA_RHS,
                  f"mega_diag disagrees on {name} cb={cb}: {errs}")
            # the solve on the kernels is the solve on the plain versions
            # only if the RHS and the tangent equal them to the last bit,
            # and the window's diagnostics are then the plain path's too
            for kname, a, b in zip(MEGA_REPLACES, outs, plain):
                check(torch.equal(a, b), f"{kname} is not bitwise equal to "
                      f"its plain version on {name} cb={cb}")
            log(f"  {name} cb={cb}: scaled err " + " ".join(
                f"{k} {e:.3e}" for k, e in worst.items())
                + "; bitwise repeatable; all three bitwise equal to plain")
            for kname, a, b in zip(MEGA_REPLACES, outs, plain):
                err[kname] = max(err[kname], abs_err(b, a))

    # per-call times at the main path's shapes and boundary mode (closed)
    md = meshes["32k"]
    t = mega.build_mega_tables(md).to(dev)
    fs, y, v = mega_slice(md, dev, seed=4)
    f = mega.pack_forcing(t, fs)
    calls = {
        "mega_rhs": (lambda: mega.mega_rhs(t, f, y, True),
                     lambda: mega.mega_rhs_plain(t, f, y, True)),
        "mega_jvp": (lambda: mega.mega_jvp(t, f, y, v, True),
                     lambda: mega.mega_jvp_plain(t, f, y, v, True)),
        "mega_diag": (lambda: mega.mega_diag(t, f, y, True),
                      lambda: mega.mega_diag_plain(t, f, y, True)),
    }
    for name, (kern, plain) in calls.items():
        timed(name, kern, plain, *mega_work(t, f, name), err[name], results,
              device_times)
        # rounded: the profiler may drop a record of the 20 calls
        want = MEGA_DEVICE_LAUNCHES[name]
        got = device_times[name]["device_launches_per_call"]
        check(got is not None and round(got) == want,
              f"{name}: {got} device launches per call in the profile, "
              f"{want} expected")
    regs = {name: mega.occupancy(name)["registers"] for name in calls}
    log("  registers a thread of the fused kernel: " + ", ".join(
        f"{k} {r}" for k, r in regs.items()))
    n_threads = t.ne + t.nr + t.nl
    occ = mega.occupancy("mega_rhs")
    grid = mega.launch_plan(n_threads, occ["sm_count"], occ["blocks_per_sm"])
    return {"registers": regs,
            "cooperative_fixed_cost": barrier_probe(torch, grid)}


def barrier_probe(torch, grid: int) -> dict:
    """The fixed cost of the fused kernels' design: one cooperative launch
    of *grid* empty blocks of 128 threads meeting at 0, 1 and 2 grid
    barriers (csrc/mega.cu shud_mega_barrier_probe): device time per
    launch alone and back to back (CUDA events), and the profiler's
    device time, as the kernels' is read."""
    from shud_tpu_torch.core.cuda_build import load_library

    lib = load_library()
    out = {"grid": grid}
    for n_sync in (0, 1, 2):
        def launch(n_sync=n_sync):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.shud_mega_barrier_probe(grid, n_sync, stream)
            check(err == 0, f"barrier probe refused: CUDA error {err}")

        out[f"sync{n_sync}"] = {"alone_ms": device_ms(launch),
                                "back_to_back_ms": device_ms(launch, n=100),
                                "profiler_ms": device_per_call(launch)[0]}
    log(f"  empty cooperative launch, {grid} blocks of 128, device time: "
        + "; ".join(
            f"{k}: {v['alone_ms']:.5f} ms alone, {v['back_to_back_ms']:.5f} "
            f"ms back to back (events), {v['profiler_ms']} ms (profiler)"
            for k, v in out.items() if k != "grid"))
    return out


def phase_mega_rhs(md, torch, mega):
    """The RHS and its J·v per evaluation at 32,768 cells: the mega path
    against the eager path with the edge kernels."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import rhs

    dev = torch.device(DEVICE)
    fs, y, v = mega_slice(md, dev, seed=6)
    t = mega.build_mega_tables(md).to(dev)
    f = mega.pack_forcing(t, fs)
    dm = to_torch(md, torch.float32, dev)
    dy_m, dy_e = mega.rhs_mega(t, f, y, True), rhs(dm, fs, 0.0, y, True)
    torch.cuda.synchronize()
    e = scaled_err(dy_e, dy_m)
    log(f"  32k rhs mega vs eager: dY scaled err {e:.3e}")
    check(e <= BAR_RHS_PATHS, "the mega RHS disagrees with the eager RHS")

    def jv_mega():
        return torch.func.jvp(lambda yy: mega.rhs_mega(t, f, yy, True),
                              (y,), (v,))[1]

    def jv_eager():
        return torch.func.jvp(lambda yy: rhs(dm, fs, 0.0, yy, True),
                              (y,), (v,))[1]

    # the J·v as the solver calls it: linearized once, then one tangent
    # call per Krylov vector
    _, jv_solver = mega.linearize_mega(t, f, y, True)
    check(torch.equal(jv_solver(v), jv_mega()),
          "the solver's J·v differs from torch.func.jvp of rhs_mega")
    out = {"rhs_mega_ms": time_ms(lambda: mega.rhs_mega(t, f, y, True)),
           "rhs_eager_ms": time_ms(lambda: rhs(dm, fs, 0.0, y, True)),
           "jvp_solver_ms": time_ms(lambda: jv_solver(v)),
           "jvp_mega_ms": time_ms(jv_mega), "jvp_eager_ms": time_ms(jv_eager)}
    log("  32k per evaluation: rhs mega %.4f ms, eager %.4f ms; J.v as the "
        "solver calls it %.4f ms, torch.func.jvp of rhs_mega %.4f ms, of "
        "the eager rhs %.4f ms (CUDA events)" % (
            out["rhs_mega_ms"], out["rhs_eager_ms"], out["jvp_solver_ms"],
            out["jvp_mega_ms"], out["jvp_eager_ms"]))
    return out

def expected_files(sim) -> set:
    """The file set run_project_fast writes for this configuration."""
    prj = sim.inp.paths.project
    names = {f"{prj}.{s}" for s in (
        "SHUD", "cfg.calib.bak", "cfg.ic.bak", "cfg.ic.update", "ckpt.npz",
        "flood.csv", "time.csv", "wb.basin.csv")}
    cs = sim.inp.control
    channels = {
        "eleyic": cs.dt_ye_ic, "eleysnow": cs.dt_ye_snow,
        "eleysurf": cs.dt_ye_surf, "eleyunsat": cs.dt_ye_unsat,
        "eleygw": cs.dt_ye_gw, "elevprcp": cs.dt_qe_prcp,
        "elevnetprcp": cs.dt_qe_prcp, "elevetp": cs.dt_qe_etp,
        "eleveta": cs.dt_qe_eta, "elevrech": cs.dt_qe_rech,
        "eleqsub": cs.dt_Qe_sub, "eleqsurf": cs.dt_Qe_surf,
        "eleqrsub": cs.dt_Qe_rsub, "eleqrsurf": cs.dt_Qe_rsurf,
        "elevinfil": cs.dt_qe_infil, "elevexfil": cs.dt_qe_infil,
        "elevetic": cs.dt_qe_et, "elevettr": cs.dt_qe_et,
        "elevetev": cs.dt_qe_et, "rn_h": cs.dt_qe_et, "rn_t": cs.dt_qe_et,
        "rn_factor": cs.dt_qe_et, "rivqup": cs.dt_Qr_up,
        "rivqdown": cs.dt_Qr_down, "rivqsub": cs.dt_Qr_sub,
        "rivqsurf": cs.dt_Qr_surf, "rivystage": cs.dt_yr_stage,
    }
    names |= {f"{prj}.{c}.dat" for c, dt in channels.items() if dt > 0}
    for base, on in (("eleqsub", cs.dt_Qe_subx), ("eleqsurf", cs.dt_Qe_surfx)):
        if on > 0:
            names |= {f"{prj}.{base}{j}.dat" for j in (1, 2, 3)}
    return names


def phase_main(inp, torch, kernels, bdf, minutes, outdir, start_min=0.0):
    """A main path: run_project_fast in f32 on the card from *start_min*
    for *minutes*, every launch count set to 0 just before and read just
    after.  Returns what it measured, the counts under "launches"."""
    import numpy as np

    from shud_tpu_torch.driver.run_fast import run_project_fast

    inp.control.day_start = start_min / 1440.0
    end_min = start_min + minutes
    windows = int(round(minutes / inp.control.solver_step))
    for k in kernels:
        k.reset_launch_counts()
    syncs0, iters0 = bdf.host_syncs, bdf.newton_iters
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = run_project_fast("synthetic", inp=inp, end_day=end_min / 1440.0,
                           float_dtype=torch.float32, device=DEVICE,
                           outpath=outdir, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for k in kernels for n, c in k.launch_counts.items()}
    syncs, iters = bdf.host_syncs - syncs0, bdf.newton_iters - iters0
    ne = sim.md.num_ele
    nfe, nsteps = sim.bdf.nfe, sim.bdf.nsteps
    log(f"  main path: {ne} cells, simulated minutes {start_min:g}-"
        f"{end_min:g}, nsteps {nsteps}, nfe {nfe}, Newton iterations "
        f"{iters}, wall {wall:.2f} s, host syncs {syncs}")
    log(f"  cell-steps/s (NumEle x NFE / wall): {ne * nfe / wall:.6g}")
    log(f"  launches: {counts}; per NFE "
        + " ".join(f"{k} {n / nfe:.3f}" for k, n in counts.items()))
    check(float(sim.bdf.t) == end_min, f"stopped at t={sim.bdf.t}")
    check(bool(np.isfinite(sim.y_np()).all()), "non-finite state")
    files = set(os.listdir(outdir))
    want = expected_files(sim)
    check(files == want, f"file set differs: extra {sorted(files - want)}, "
          f"missing {sorted(want - files)}")
    for f in sorted(files):
        if f.endswith(".dat"):
            with open(os.path.join(outdir, f), "rb") as fh:
                fh.seek(1024)
                data = np.frombuffer(fh.read(), np.float64)
            check(data.size > 1 and bool(np.isfinite(data).all()),
                  f"{f}: empty or non-finite")
    return dict(start_min=start_min, sim_minutes=minutes, nsteps=nsteps,
                nfe=nfe, newton_iters=iters, krylov_m=sim.cfg.krylov_m,
                windows=windows, wall_s=wall, host_syncs=syncs,
                cell_steps_per_s=ne * nfe / wall, num_ele=ne,
                output_files=len(files), launches=counts,
                mega=sim.mega is not None)


def storm_sim(inp, torch, float_dtype=None, start=720.0, per_window=False,
              **kw):
    """A simulation from the storm's onset (minute 720, or *start*), where
    the surface wets: before it the surface is dry and any two paths agree
    trivially.  *per_window*: the per-window driver's Simulation instead
    of FusedSimulation."""
    from shud_tpu_torch.driver.fused import FusedSimulation
    from shud_tpu_torch.driver.simulate import Simulation

    at = copy.deepcopy(inp)
    at.control.day_start = start / 1440.0
    cls = Simulation if per_window else FusedSimulation
    return cls.create("synthetic", inp=at,
                      float_dtype=float_dtype or torch.float32,
                      device=DEVICE, **kw)


def advance(sim, minutes: float):
    """One window of either driver."""
    if hasattr(sim, "advance_interval"):
        sim.advance_interval(minutes)
    else:
        sim.advance_window(sim.t + minutes)


def max_gap(a, b):
    """max |a - b| over two states, and where: (gap, block, index)."""
    d = (a.bdf.y.double() - b.bdf.y.double()).abs()
    i = int(d.argmax())
    ne, nr = a.md.num_ele, a.md.num_riv
    cuts = ((3 * ne + nr, "lake", 3 * ne + nr), (3 * ne, "riv", 3 * ne),
            (2 * ne, "gw", 2 * ne), (ne, "us", ne), (0, "sf", 0))
    block, off = next((n, o) for lo, n, o in cuts if i >= lo)
    return float(d[i]), block, i - off


def phase_paths(inp, torch, paths: dict, gated: dict, what: str,
                start: float = 720.0, n_windows: int = STORM_WINDOWS,
                bitwise: tuple = (), repeat: bool = True, after=None):
    """Storm windows on several paths side by side: 6 windows of 10
    minutes from the storm's onset (*n_windows* from minute *start*),
    window by window.  *paths* maps a name to the keywords of
    ``storm_sim``, the kernel path first.  After each window, max |dy| of
    every pair of paths, and where.  Each pair "a-b" in *gated* is held to
    |dy| < 2e-5 m after every window; a pair gated with the name of
    another pair only after the windows where that pair (the reference
    path in float32 and float64) is itself within 2e-5 m; each pair in
    *bitwise* to equal states.  NFE of each path within 2% of the kernel
    path's.  Wall and cell-steps/s of each; then (*repeat*) one window
    twice on the kernel path, bitwise identical.  *after(sims)* adds its
    dict of checks to the result."""
    sims = {n: storm_sim(inp, torch, start=start, **kw)
            for n, kw in paths.items()}
    names = list(sims)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    walls = dict.fromkeys(names, 0.0)
    windows = []
    for w in range(n_windows):
        for name, sim in sims.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            advance(sim, 10.0)
            torch.cuda.synchronize()
            walls[name] += time.perf_counter() - t0
        gaps = {f"{a}-{b}": max_gap(sims[a], sims[b]) for a, b in pairs}
        log(f"  {what}, window {w}: max |dy| " + ", ".join(
            f"{k} {g:.3e} m ({blk} {i})" for k, (g, blk, i) in gaps.items()))
        for pair, unless in gated.items():
            if unless is not None and gaps[unless][0] >= BAR_DRIVER:
                log(f"    {pair} not gated: {unless} {gaps[unless][0]:.3e} m")
                continue
            check(gaps[pair][0] < BAR_DRIVER,
                  f"{what}: {pair} parts by {gaps[pair][0]:.3e} m "
                  f"(window {w})")
        for a, b in bitwise:
            check(torch.equal(sims[a].bdf.y, sims[b].bdf.y),
                  f"{what}: {a} and {b} not bitwise equal (window {w})")
        windows.append({k: g[0] for k, g in gaps.items()})
    kernel = sims[names[0]]
    out = {n: {"wall_s": walls[n], "nfe": s.bdf.nfe,
               "cell_steps_per_s": s.md.num_ele * s.bdf.nfe / walls[n]}
           for n, s in sims.items()}
    log(f"  {what}: nfe " + ", ".join(f"{n} {o['nfe']}" for n, o in out.items())
        + "; wall " + ", ".join(f"{n} {o['wall_s']:.3f} s"
                                for n, o in out.items())
        + f"; {names[0]}-{names[1]} bitwise equal "
        f"{torch.equal(kernel.bdf.y, sims[names[1]].bdf.y)}")
    for name, sim in sims.items():
        check(abs(sim.bdf.nfe - kernel.bdf.nfe) <= 0.02 * sim.bdf.nfe,
              f"{what}: NFE of {name} differs by more than 2%")
    out["max_dy"] = windows
    if after is not None:
        out.update(after(sims))
    if repeat:
        c, e = (storm_sim(inp, torch, start=start, **paths[names[0]])
                for _ in range(2))
        advance(c, 10.0)
        advance(e, 10.0)
        same = torch.equal(c.bdf.y, e.bdf.y) and c.bdf.nfe == e.bdf.nfe
        log(f"  one storm window twice on the kernel path: bitwise equal "
            f"{same}")
        check(same, "kernel path is not deterministic")
    return out


def frost_project(inp):
    """*inp* with the cryosphere on and the forcing record before the
    storm (minutes -720 to 720) at FROST_C: a window from minute 710
    flushes the accumulators' first "day" at FROST_C, and the frozen
    fractions hold through the storm windows that follow."""
    cold = copy.deepcopy(inp)
    cold.control.cryosphere = 1
    cold.forc.data[0][0, 1] = FROST_C
    return cold


def frozen_fractions(sims) -> dict:
    """fu_surf and fu_sub of the kernel path's cryosphere state, checked
    below 1 (some cells' subsurface fluxes cut)."""
    from shud_tpu_torch.core.cryo import acc_temp_mean
    from shud_tpu_torch.core.landsurface import frozen_fraction

    sim = sims["kernel"]
    gc = sim.inp.calib
    fu = {"fu_surf": 1.0 - frozen_fraction(acc_temp_mean(sim.cryo.surf),
                                            gc.fzn_surfmax, gc.fzn_surfmin),
          "fu_sub": 1.0 - frozen_fraction(acc_temp_mean(sim.cryo.sub),
                                           gc.fzn_submax, gc.fzn_submin)}
    out = {f"{k}_{f}": float(getattr(v, f)()) for k, v in fu.items()
           for f in ("min", "max")}
    log("  frozen fractions: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in out.items()))
    check(out["fu_sub_min"] < 1.0, "the cryosphere cut no subsurface flux")
    return out


def phase_cli(torch) -> dict:
    """The command line in fresh processes on the card's host: -h exits 0,
    a flag refused under -g (--f32) exits nonzero with its message."""
    out = {}
    for name, argv, ok, text in (
            ("help", ["-h"], True, "--per-window"),
            ("split_f32", ["-g", "--f32", "synthetic"], False,
             "not supported with -g")):
        r = subprocess.run([sys.executable, "-m", "shud_tpu_torch", *argv],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=300)
        log(f"  python -m shud_tpu_torch {' '.join(argv)}: exit "
            f"{r.returncode}")
        check((r.returncode == 0) == ok and text in (r.stdout + r.stderr),
              f"python -m shud_tpu_torch {argv}: exit {r.returncode}, "
              f"{r.stderr[-500:]}")
        out[name] = r.returncode
    return out


def phase_profile(inp, torch, **kw):
    """Where one storm window's time goes (torch.profiler): device busy
    time, idle share, launches per NFE, kernel time by name."""
    from torch.profiler import ProfilerActivity, profile

    sim = storm_sim(inp, torch, **kw)
    sim.advance_interval(10.0)
    torch.cuda.synchronize()
    nfe0 = sim.bdf.nfe
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance_interval(10.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(r.key, _self_device_us(r), r.count) for r in prof.key_averages()]
    busy_s = sum(us for _, us, _ in rows) / 1e6
    top = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:10]
    nfe = sim.bdf.nfe - nfe0
    launches = sum(c for _, us, c in rows if us > 0)
    # mega.cu's fused kernel by name: all three instantiations, and the
    # diagnostics' (once a window)
    mega_launches = {kind: sum(c for k, us, c in rows if us > 0 and pat in k)
                     for kind, pat in (("fused", "::fused<"),
                                       ("diag", "fused<false, true>"))}
    prof_summary = {
        "window_wall_s": wall, "nfe": nfe, "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / wall) if busy_s > 0 else None,
        "kernel_launches": launches, "launches_per_nfe": launches / nfe,
        "mega_launches": mega_launches,
        "mega_launches_per_nfe": {k: n / nfe for k, n in
                                  mega_launches.items()},
        "top_device_ms": {k[:60]: round(us / 1e3, 3) for k, us, _ in top},
    }
    log(f"  one storm window under the profiler: wall {wall:.3f} s, nfe "
        f"{nfe}, device busy {busy_s:.3f} s, idle share "
        f"{prof_summary['device_idle_share']}, {launches} launches "
        f"({launches / nfe:.1f} per NFE); mega kernel launches per NFE "
        + ", ".join(f"{k} {n / nfe:.3f}" for k, n in mega_launches.items()))
    for k, us, c in top:
        log(f"    {us / 1e3:9.3f} ms  {c:6d}x  {k[:70]}")
    return prof_summary


def blocks_gap(a, b, ne: int, nr: int) -> dict:
    """max |a - b| per state block (sf, us, gw, riv, lake) of two flat
    states, on the host in float64."""
    d = (a.double() - b.double()).abs().cpu()
    cuts = {"sf": (0, ne), "us": (ne, 2 * ne), "gw": (2 * ne, 3 * ne),
            "riv": (3 * ne, 3 * ne + nr), "lake": (3 * ne + nr, d.numel())}
    return {k: float(d[lo:hi].max()) for k, (lo, hi) in cuts.items()
            if hi > lo}


def spin_up(inp, torch) -> dict:
    """The state an f64 adaptive run (fused, eager) reaches at minute 720,
    the storm's onset, from the initial condition at minute 0: phases 13
    and 14 start from it, since the river's start-up transient from the
    initial condition is fast enough to dominate both the splitting error
    and a fixed-step truth's error."""
    from shud_tpu_torch.driver.fused import FusedSimulation

    p = copy.deepcopy(inp)
    p.control.day_start = 0.0
    sim = FusedSimulation.create("synthetic", inp=p, float_dtype=torch.float64,
                                 mega=False, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.advance_interval(720.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  spin-up ({sim.md.num_ele} cells): minutes 0-720, f64 eager, "
        f"{sim.bdf.nfe} NFE in {wall:.2f} s")
    return {"y": sim.bdf.y, "buckets": sim.buckets, "cfg": sim.cfg,
            "nfe": sim.bdf.nfe, "wall_s": wall}


def phase_split(inp, torch, kernels, what: str, spun: dict) -> dict:
    """Phase 13: run_project_split (float64, the card) resumed from a -g
    checkpoint of the spun-up state at minute 720 over the 6 storm
    windows, one output interval a window (the time log has each window's
    wall), against the fused float64 eager driver from the same state:
    every block within the splitting bound (lake: its own).  No kernel of
    the six runs on this path (float64); the counts are set to 0 just
    before and read just after."""
    import numpy as np

    from shud_tpu_torch.driver.uncoupled import (
        _SplitCheckpointShim, init_uncoupled, run_project_split)
    from shud_tpu_torch.io.checkpoint import save_checkpoint

    p = copy.deepcopy(inp)
    p.control.day_start = 0.5
    for name in vars(p.control):
        if name.startswith("dt_"):
            setattr(p.control, name, 10)
    p.control.dt_Qe_subx = p.control.dt_Qe_surfx = 0
    end = 720.0 + 10.0 * STORM_WINDOWS
    ne, nr = p.tri.shape[0], p.riv.shape[0]
    nl = spun["y"].numel() - 3 * ne - nr
    for k in kernels:
        k.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="shud_split_") as out:
        ckpt = os.path.join(out, "spun.ckpt.npz")
        save_checkpoint(ckpt, _SplitCheckpointShim(
            init_uncoupled(spun["y"], ne, nr, 720.0, spun["cfg"], nl=nl),
            spun["buckets"], 720.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run_project_split("synthetic", inp=p, end_day=end / 1440.0,
                               outpath=out, verbose=False, device=DEVICE,
                               resume=ckpt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log_rows = np.loadtxt(os.path.join(out, "synthetic.time.csv"),
                              skiprows=1, ndmin=2)
        n_files = len(os.listdir(out))
    counts = {n: c for k in kernels for n, c in k.launch_counts.items()}
    check(not any(counts.values()), f"{what}: a kernel ran on -g: {counts}")
    parts = {k: getattr(st, k) for k in ("surf", "unsat", "gw", "riv", "lake")
             if getattr(st, k) is not None}
    check(("lake" in parts) == bool(nl), f"{what}: lake sub-solve")
    for k, s in parts.items():
        check(float(s.t) == end and s.y.dtype == torch.float64
              and bool(torch.isfinite(s.y).all()), f"{what}: {k} state")
    per_window = np.diff(log_rows[:, 4], prepend=0.0)
    solvers = {k: {"nsteps": s.nsteps, "nfe": s.nfe} for k, s in parts.items()}
    log(f"  {what}: -g over {STORM_WINDOWS} storm windows in {wall:.2f} s "
        f"(wall per window from the time log: "
        + ", ".join(f"{w:.2f}" for w in per_window) + " s); sub-solvers "
        + ", ".join(f"{k} {v['nsteps']} steps {v['nfe']} NFE"
                    for k, v in solvers.items()) + f"; {n_files} files")
    check(len(log_rows) == STORM_WINDOWS, f"{what}: {len(log_rows)} intervals")
    ref = restart_at(storm_sim(inp, torch, float_dtype=torch.float64,
                               mega=False), 720.0, spun["y"],
                     spun["buckets"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STORM_WINDOWS):
        ref.advance_interval(10.0)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    y_split = torch.cat([s.y for s in parts.values()])
    gaps = blocks_gap(y_split, ref.bdf.y, ne, nr)
    log(f"  {what}: -g vs the fused f64 eager driver ({ref.bdf.nfe} NFE, "
        f"{ref_wall:.2f} s): max |dy| " + ", ".join(
            f"{k} {v:.3e} m" for k, v in gaps.items()))
    for k, v in gaps.items():
        bar = SPLIT_BAR_LAKE if k == "lake" else SPLIT_BAR
        check(v < bar, f"{what}: -g {k} parts from the implicit driver by "
              f"{v:.3e} m (bar {bar:g})")
    return {"wall_s": wall, "window_wall_s": per_window.tolist(),
            "solvers": solvers, "vs_implicit_m": gaps,
            "implicit_nfe": ref.bdf.nfe, "implicit_wall_s": ref_wall,
            "launches": counts}


def restart_at(sim, t: float, y, buckets):
    """*sim* (either driver) restarted at minute *t* from the state *y* and
    *buckets*, cast to its precision: the solver history begins anew, as
    at the start of a run."""
    from shud_tpu_torch.core.landsurface import BucketState
    from shud_tpu_torch.solver.bdf import bdf_init

    dt = sim.bdf.y.dtype
    sim.bdf = bdf_init(t, y.to(dt), sim.cfg, quad0=sim.bdf.quad)
    sim.buckets = BucketState(*[b.to(dt) for b in buckets])
    sim.t = t
    return sim


def phase_truth(inp, torch, edge, mega, bdf, spun: dict) -> dict:
    """Phase 14: the fixed-step f64 truth (fixed_bdf1, rhs.linearize as its
    hook) over the 6 storm windows at 32k, from the spun-up state at
    minute 720 (``spin_up``: from the initial condition, the river's
    start-up transient would need a far smaller step).
    The truth at TRUTH_H and at half of it within TRUTH_SELF of each other
    after every window (self-convergence); then each adaptive path from
    the same state, held to TRUTH_BAR on gw heads and river stages after
    every window: eager f64, eager f32 with the edge kernels, the mega
    path with its kernels (launch counts set to 0 before each path and
    read after it)."""
    from shud_tpu_torch.core import rhs as R
    from shud_tpu_torch.solver.fixed import fixed_bdf1

    y0, bk0 = spun["y"], spun["buckets"]
    ne, nr = inp.tri.shape[0], inp.riv.shape[0]

    def f(t, y, p):
        return R.rhs(p[0], p[1], t, y, True)

    def lin(t, y, p):
        return R.linearize(p[0], p[1], t, y, True)

    truths, truth_s = {}, {}
    for h in (TRUTH_H, TRUTH_H / 2):
        sim = restart_at(storm_sim(inp, torch, float_dtype=torch.float64,
                                   per_window=True), 720.0, y0, bk0)
        y, t, ys = sim.bdf.y, sim.t, []
        syncs = bdf.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STORM_WINDOWS):
            fs, _ = sim.forcing_slice(t + 10.0)
            t, y = fixed_bdf1(f, y, t, (sim.dm, fs), h, int(round(10.0 / h)),
                              linearize=lin)
            t = float(t)
            ys.append(y)
        torch.cuda.synchronize()
        truth_s[h] = time.perf_counter() - t0
        check(bdf.host_syncs == syncs, "the truth read the device")
        truths[h] = ys
        log(f"  truth h={h:g} min: {int(round(10.0 / h))} steps a window, "
            f"{truth_s[h]:.2f} s")
    self_conv = []
    for w in range(STORM_WINDOWS):
        g = blocks_gap(truths[TRUTH_H][w], truths[TRUTH_H / 2][w], ne, nr)
        self_conv.append(g)
        log(f"  window {w}: truth h vs h/2 " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items()))
        check(max(g.values()) < TRUTH_SELF,
              f"truth h={TRUTH_H:g} not converged: {g} (window {w})")

    paths = {"eager64": dict(float_dtype=torch.float64, mega=False),
             "eager32": dict(mega=False), "mega32": {}}
    out = {"h_min": TRUTH_H, "truth_s": truth_s,
           "self_convergence_m": self_conv}
    for name, kw in paths.items():
        sim = restart_at(storm_sim(inp, torch, **kw), 720.0, y0, bk0)
        for k in (edge, mega):
            k.reset_launch_counts()
        gaps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(STORM_WINDOWS):
            sim.advance_interval(10.0)
            g = blocks_gap(sim.bdf.y, truths[TRUTH_H][w], ne, nr)
            gaps.append(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for k in (edge, mega)
                  for n, c in k.launch_counts.items()}
        log(f"  {name} vs truth ({sim.bdf.nfe} NFE, {wall:.2f} s, launches "
            f"{counts}): " + "; ".join(
                f"w{w} gw {g['gw']:.3e} riv {g['riv']:.3e} sf {g['sf']:.3e} "
                f"us {g['us']:.3e}" for w, g in enumerate(gaps)))
        for w, g in enumerate(gaps):
            for blk in ("gw", "riv"):
                check(g[blk] < TRUTH_BAR,
                      f"{name}: {blk} {g[blk]:.3e} m from the truth "
                      f"(window {w}, bar {TRUTH_BAR:g})")
        if name == "eager32":
            check(counts["edge_coeff"] > 0 and counts["edge_apply"] > 0
                  and not counts["mega_rhs"], f"{name}: {counts}")
        if name == "mega32":
            check(sim.mega is not None and counts["mega_rhs"] > 0
                  and counts["mega_jvp"] > 0 and not counts["edge_coeff"],
                  f"{name}: {counts}")
        out[name] = {"nfe": sim.bdf.nfe, "wall_s": wall, "vs_truth_m": gaps,
                     "launches": counts}
    return out


def phase_netcdf(inp, torch, mega, kernels) -> dict:
    """Phase 15: the 32k storm project's forcing written as a CMFD2
    NetCDF-3 set (scipy), decoded by the project loader's reader and
    checked equal to the table it was written from; the mega path over
    the 6 storm windows forced from it beside the same forced by that
    table as CSV (bitwise where the tables are equal, else 2e-5 m); then
    OUTPUT_MODE NETCDF: refused naming h5py where h5py is absent, else
    written and read back."""
    import numpy as np

    from torch_variants import write_cmfd_netcdf3

    from shud_tpu_torch.driver.run_fast import run_project_fast
    from shud_tpu_torch.io.project import _read_forc_netcdf

    out = {}
    with tempfile.TemporaryDirectory(prefix="shud_nc_") as tmp:
        nc = copy.deepcopy(inp)
        t0 = time.perf_counter()
        t_min, data = write_cmfd_netcdf3(nc, os.path.join(tmp, "input"),
                                         nc.control.end_time)
        got = _read_forc_netcdf(nc.paths, nc.control)
        io_s = time.perf_counter() - t0
    equal = (np.array_equal(got.t_min[0], t_min)
             and np.array_equal(got.data[0], data))
    log(f"  NetCDF-3 forcing: {len(t_min)} records written and decoded in "
        f"{io_s:.2f} s, decoded table equal to the written one: {equal}")
    check(equal and got.num_stations == 1, "decoded forcing differs")
    nc.forc = got
    csv = copy.deepcopy(inp)
    csv.forc.t_min, csv.forc.data = [t_min], [data]
    sims = {n: storm_sim(p, torch) for n, p in (("netcdf", nc), ("csv", csv))}
    for k in kernels:
        k.reset_launch_counts()
    for w in range(STORM_WINDOWS):
        for sim in sims.values():
            sim.advance_interval(10.0)
        a, b = sims["netcdf"].bdf.y, sims["csv"].bdf.y
        same = bool(torch.equal(a, b))
        gap = float((a.double() - b.double()).abs().max())
        check(same or gap < BAR_DRIVER, f"NetCDF-forced run parts by {gap}")
    counts = dict(mega.launch_counts)
    log(f"  mega path over {STORM_WINDOWS} storm windows: NetCDF-forced vs "
        f"CSV-forced bitwise equal {same} (max |dy| {gap:.3e} m), NFE "
        f"{sims['netcdf'].bdf.nfe} / {sims['csv'].bdf.nfe}, launches "
        f"{counts}")
    check(sims["netcdf"].mega is not None and counts["mega_rhs"] > 0,
          f"the NetCDF-forced run is off the mega path: {counts}")
    out.update(records=len(t_min), decoded_equal=equal, bitwise=same,
               max_dy_m=gap, nfe=sims["netcdf"].bdf.nfe, launches=counts)

    try:
        import h5py
    except ImportError:
        h5py = None
    p = copy.deepcopy(inp)
    p.control.output_mode = "NETCDF"
    p.control.day_start = 0.5
    p.control.dt_Qe_subx = p.control.dt_Qe_surfx = 0
    for name in vars(p.control):
        if name.startswith("dt_") and getattr(p.control, name):
            setattr(p.control, name, 10)
    with tempfile.TemporaryDirectory(prefix="shud_ncout_") as tmp:
        outdir = os.path.join(tmp, "out")
        if h5py is None:
            try:
                run_project_fast("synthetic", inp=p, end_day=730.0 / 1440,
                                 float_dtype=torch.float32, outpath=outdir,
                                 verbose=False, device=DEVICE)
                refused = ""
            except RuntimeError as e:
                refused = str(e)
            log(f"  OUTPUT_MODE NETCDF without h5py: refused: {refused!r}")
            check("h5py" in refused and not os.path.exists(outdir),
                  "OUTPUT_MODE NETCDF was not refused before the run")
            out["netcdf_output"] = "refused: " + refused
        else:
            run_project_fast("synthetic", inp=p, end_day=730.0 / 1440,
                             float_dtype=torch.float32, outpath=outdir,
                             verbose=False, device=DEVICE)
            with h5py.File(os.path.join(outdir, "synthetic.ele.nc")) as f:
                shape = f["y_gw"].shape
                ok = bool(np.isfinite(f["y_gw"][()]).all())
            log(f"  OUTPUT_MODE NETCDF with h5py {h5py.__version__}: "
                f"y_gw {shape}, finite {ok}")
            check(ok and shape == (1, p.tri.shape[0]), "NetCDF output")
            out["netcdf_output"] = f"written, y_gw {shape}"
    return out


def phase_refined(inp, torch, edge, bdf) -> dict:
    """Phase 16: the 131k storm project refined REFINE_LEVELS times (4:1
    each), the fused f32 driver with the edge kernels beside the same on
    their plain versions over the 6 storm windows, window by window:
    within 2e-5 m after every window, NFE within 2%; on the kernel path
    edge_coeff once per Newton iteration, edge_apply krylov_m times and
    edge_flux once a window (counts set to 0 just before its first window
    and read after its last; its Newton iterations counted around its own
    windows).  Set-up time, wall per window and peak device memory."""
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.utils.refine import refine_project

    t0 = time.perf_counter()
    fine = refine_project(copy.deepcopy(inp), REFINE_LEVELS)
    refine_s = time.perf_counter() - t0
    ne = fine.tri.shape[0]
    check(ne == inp.tri.shape[0] * 4 ** REFINE_LEVELS, "wrong refined size")
    out = {"num_ele": ne, "refine_s": refine_s}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k = storm_sim(fine, torch)
    torch.cuda.synchronize()
    # the plain path shares the kernel simulation's (read-only) mesh and
    # forcing tensors, with the edge kernels switched off: one set-up
    sims = {"kernel": k, "plain": dataclasses.replace(
        k, dm=dataclasses.replace(k.dm, edge_kernel=False))}
    for name in sims:
        out[name] = {"setup_s": time.perf_counter() - t0, "window_wall_s": []}
        out[name]["resident_gib"] = torch.cuda.memory_allocated() / 2**30
    md = k.md
    log(f"  refined mesh: {md.num_ele} cells, {md.num_riv} reaches, "
        f"{md.num_seg} segments; refined in {refine_s:.2f} s, set-up "
        f"{out['kernel']['setup_s']:.2f} s (the plain path shares it); "
        f"device memory resident {out['plain']['resident_gib']:.2f} GiB")
    edge.reset_launch_counts()
    iters = 0
    for w in range(STORM_WINDOWS):
        for name, sim in sims.items():
            it0 = bdf.newton_iters
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.advance_interval(10.0)
            torch.cuda.synchronize()
            out[name]["window_wall_s"].append(time.perf_counter() - t0)
            if name == "kernel":
                iters += bdf.newton_iters - it0
        a, b = sims["kernel"].bdf.y, sims["plain"].bdf.y
        gap = float((a.double() - b.double()).abs().max())
        log(f"  refined, window {w}: kernel vs plain max |dy| {gap:.3e} m")
        check(gap < BAR_DRIVER,
              f"refined: kernel path parts by {gap:.3e} m (window {w})")
    counts = dict(edge.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, sim in sims.items():
        check(sim.mega is None, "the refined mesh took the mega path")
        out[name]["nfe"] = sim.bdf.nfe
        log(f"  {name}: wall per window " + ", ".join(
            f"{x:.2f}" for x in out[name]["window_wall_s"])
            + f" s, {sim.bdf.nfe} NFE")
    log(f"  kernel path: {iters} Newton iterations, launches {counts}; peak "
        f"device memory {peak:.2f} GiB")
    check(counts["edge_coeff"] == iters
          and counts["edge_apply"] == k.cfg.krylov_m * iters
          and counts["edge_flux"] == STORM_WINDOWS,
          f"refined: {counts} for {iters} Newton iterations")
    check(abs(k.bdf.nfe - sims["plain"].bdf.nfe) <= 0.02 * k.bdf.nfe,
          "refined: NFE of the plain path differs by more than 2%")
    out.update(max_dy_m=gap, newton_iters=iters, launches=counts,
               peak_gib=peak)
    return out

def timed_collectives(group) -> dict:
    """Count and time this rank's halo exchanges and gathers (the psums
    go through all_gather): the group's two methods wrapped in place.
    The time holds the wait for the other ranks."""
    stats = {"ppermute_round": [0, 0.0], "all_gather": [0, 0.0]}
    for name in stats:
        fn = getattr(group, name)

        def wrapped(*args, _fn=fn, _st=stats[name]):
            t0 = time.perf_counter()
            out = _fn(*args)
            _st[0] += 1
            _st[1] += time.perf_counter() - t0
            return out

        setattr(group, name, wrapped)
    return stats


def sharded_rank(group, inp, n_windows, hour=None,
                 paths=("kernel", "plain")):
    """A rank of phase 17 (``comm.spawn`` pickles it by name): the sharded
    simulation over *n_windows* storm windows with the edge kernels, the
    same on their plain versions, then (*hour*: its output directory and
    project) ``run_project_sharded`` over the hour.  Every launch count is
    set to 0 just before a run's first window and read after its last."""
    import torch

    from shud_tpu_torch.core import edge
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.parallel.runtime import (
        ShardedSimulation, run_project_sharded)
    from shud_tpu_torch.solver import bdf

    md = build_mesh(inp)
    out = {"rank": group.rank}
    stats = timed_collectives(group)
    for name in paths:
        kernel = "auto" if name == "kernel" else False
        t0 = time.perf_counter()
        sim = ShardedSimulation(inp, md, group, float_dtype=torch.float32,
                                edge_kernel=kernel)
        setup_s = time.perf_counter() - t0
        # the first RHS, linearization and J·v of a fresh process, timed
        # apart from the windows (zero forcing; the state stays as it is)
        rhs = sim.rhs
        zc = torch.zeros(rhs.np_cells, device=rhs.device)
        zr = torch.zeros(rhs.nr_riv, device=rhs.device)
        slc = rhs.forcing_slice(
            dict.fromkeys(("net_prcp", "prcp", "pot_evap", "pot_tran",
                           "e_ic", "lai", "fu_surf", "fu_sub", "ele_ybc",
                           "ele_qbc", "ele_qss"), zc),
            {"riv_ybc": zr, "riv_qbc": zr})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rhs.rhs_full(0.0, sim.state.y, slc)
        rhs.linearize(0.0, sim.state.y, slc)[1](sim.state.y)
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        walls, ys, coll = [], [], []
        edge.reset_launch_counts()
        it0 = bdf.newton_iters
        for _ in range(n_windows):
            acc = sim.acc_zero()
            torch.cuda.synchronize()
            group.barrier()
            c0 = {k: list(v) for k, v in stats.items()}
            t0 = time.perf_counter()
            sim.advance_window(sim.t + inp.control.solver_step, acc)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            coll.append({k: [v[0] - c0[k][0], v[1] - c0[k][1]]
                         for k, v in stats.items()})
            y = sim.y_full()
            if group.is_main:
                ys.append(y)
        out[name] = dict(launches=dict(edge.launch_counts),
                         newton_iters=bdf.newton_iters - it0, nfe=sim.nfe,
                         nsteps=int(sim.state.nsteps), wall_s=walls,
                         collectives=coll, setup_s=setup_s,
                         first_call_s=first_call_s,
                         krylov_m=sim.cfg.krylov_m, ys=ys)
    if hour is None:
        return out
    outdir, hour_inp = hour
    t0 = time.perf_counter()
    sim = run_project_sharded("synthetic", group=group, inp=hour_inp,
                              outpath=outdir, float_dtype=torch.float32,
                              verbose=group.is_main)
    out["hour"] = {"wall_s": time.perf_counter() - t0, "nfe": sim.nfe,
                   "y": sim.y_full()}
    return out


def compare_outputs(sh_dir: str, sd_dir: str) -> dict:
    """The sharded driver's output directory against run_project_fast's:
    the same file set, byte-identical .dat headers, each .dat payload
    within 1e-4 of the largest value (at least 1), as the JAX package's
    tests/test_sharded_driver.py holds its two drivers."""
    import numpy as np

    files = sorted(os.listdir(sd_dir))
    check(sorted(os.listdir(sh_dir)) == files,
          f"sharded file set {sorted(os.listdir(sh_dir))} vs {files}")
    worst = ("", 0.0)
    for fn in files:
        if not fn.endswith(".dat"):
            continue
        with open(os.path.join(sh_dir, fn), "rb") as f0, \
                open(os.path.join(sd_dir, fn), "rb") as f1:
            h0, h1 = f0.read(1024), f1.read(1024)
            d0 = np.frombuffer(f0.read(), np.float64)
            d1 = np.frombuffer(f1.read(), np.float64)
        check(h0 == h1, f"{fn}: headers differ")
        check(d0.shape == d1.shape and bool(np.isfinite(d0).all()),
              f"{fn}: payload shape or non-finite")
        err = float(np.abs(d0 - d1).max()) / max(1.0, float(np.abs(d1).max()))
        if err >= worst[1]:
            worst = (fn, err)
        check(err < 1e-4, f"{fn}: payloads part by {err:.3e} (scaled)")
    log(f"  output files: {len(files)}, headers equal; worst payload "
        f"{worst[0]} {worst[1]:.3e} (scaled, bar 1e-4)")
    return {"files": len(files), "worst_file": worst[0],
            "worst_scaled": worst[1]}


def shard_kernel_times(sm, torch, edge) -> dict:
    """The edge trio at one shard's shape (rank 0's cell block with its
    ghost rows): kernel and plain times (CUDA events, median of 20), the
    bound, and kernel vs plain."""
    import numpy as np

    from shud_tpu_torch.parallel.comm import Group
    from shud_tpu_torch.parallel.sharded import ShardRHS

    rhs = ShardRHS(sm, Group(0, sm.p, DEVICE), torch.float32)
    et = rhs.ev.edge_tables
    n = et.dep.shape[0]
    rng = np.random.default_rng(3)

    def t(a):
        return torch.as_tensor(a, device=DEVICE).to(torch.float32)

    sf = rng.uniform(0, 0.05, n)
    sf[::7] = 0.0
    sf, gw, kh = t(sf), t(rng.uniform(0, 8.0, n)), t(rng.uniform(0, 1e-3, n))
    tan = [t(rng.standard_normal(n)) for _ in range(3)]
    coeffs = edge.edge_coeff_plain(sf, gw, kh, et, True)[2:]
    tables = edge._table_list(et)
    ne3 = 3 * n
    calls = {
        "edge_flux": (lambda: edge.edge_flux(sf, gw, kh, et, True),
                      lambda: edge.edge_flux_plain(sf, gw, kh, et, True),
                      nbytes(sf, gw, kh, *tables) + 2 * 4 * ne3),
        "edge_coeff": (lambda: edge.edge_coeff(sf, gw, kh, et, True),
                       lambda: edge.edge_coeff_plain(sf, gw, kh, et, True),
                       nbytes(sf, gw, kh, *tables) + 8 * 4 * ne3),
        "edge_apply": (lambda: edge.edge_apply(coeffs, *tan, et),
                       lambda: edge.edge_apply_plain(coeffs, *tan, et),
                       nbytes(*tan, et.nabr, *coeffs) + 2 * 4 * ne3),
    }
    out = {"rows": n}
    for name, (kern, plain, n_bytes) in calls.items():
        err = max(abs_err(a, b) for a, b in zip(plain(), kern()))
        ms, plain_ms = time_ms(kern), time_ms(plain)
        bound_ms, bound_by = bound(n_bytes, EDGE_OPS[name] * ne3)
        log(f"  per shard ({n} rows): {name} {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (CUDA events), bound {bound_ms:.5f} ms "
            f"({bound_by}), max |kernel - plain| {err:.3e}")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err}
    return out


def phase_sharded(inp, torch, edge, smi: str) -> dict:
    """Phase 17: the domain-decomposed driver (parallel/) at 131,072 cells,
    SHARDS ranks time-sliced on this one card over gloo (explicit host
    staging), 6 storm windows in float32: with the edge kernels beside the
    same on their plain versions (within 2e-5 m after every window) and
    beside the single-device f32 edge path (within 2e-5 m after every
    window in which the single-device float32 and float64 runs agree,
    phase 8's rule; NFE within 2%); every rank takes the same steps, NFE
    and Newton iterations; per rank edge_coeff once per Newton iteration,
    edge_apply krylov_m times and edge_flux once a window.  Then
    run_project_sharded over one simulated hour against run_project_fast
    (compare_outputs).  NCCL with two ranks on a host with two GPUs."""
    import numpy as np

    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.driver.run_fast import run_project_fast
    from shud_tpu_torch.parallel import comm
    from shud_tpu_torch.parallel.partition import build_sharded_mesh

    at = copy.deepcopy(inp)
    at.control.day_start = 720.0 / 1440.0
    md = build_mesh(at)
    t0 = time.perf_counter()
    sm = build_sharded_mesh(md, SHARDS)
    part_s = time.perf_counter() - t0
    plan = sm.plan
    log(f"  {smi}; partition of {md.num_ele} cells into {SHARDS} shards in "
        f"{part_s:.3f} s: np_cells {sm.np_cells}, nr_riv {sm.nr_riv}, "
        f"rounds K {plan.k}, halo per round: cells {plan.s_cell}, reaches "
        f"{plan.s_riv}; ghost rows {plan.g_cell}")
    out = {"card": smi, "shards": SHARDS, "partition_s": part_s,
           "np_cells": sm.np_cells, "rounds": plan.k,
           "halo_cells": plan.s_cell, "halo_reaches": plan.s_riv,
           "per_shard": shard_kernel_times(sm, torch, edge)}

    # the single-device references: f32 with the edge kernels, f64
    refs = {"f32": storm_sim(inp, torch), "f64": storm_sim(
        inp, torch, float_dtype=torch.float64)}
    ref_y = {k: [] for k in refs}
    for _ in range(STORM_WINDOWS):
        for k, sim in refs.items():
            advance(sim, 10.0)
            ref_y[k].append(sim.y_np().astype(np.float64))

    hour = copy.deepcopy(at)
    cs = hour.control
    for name in vars(cs):
        if name.startswith("dt_") and getattr(cs, name):
            setattr(cs, name, 60)
    cs.update_ic_step = 60
    end_day = (720.0 + 60.0) / 1440.0
    with tempfile.TemporaryDirectory(prefix="shud_shard_") as tmp:
        sh_dir, sd_dir = os.path.join(tmp, "sh"), os.path.join(tmp, "sd")
        hour.control.day_end = end_day
        t0 = time.perf_counter()
        ranks = comm.spawn(sharded_rank, SHARDS, "gloo", [DEVICE] * SHARDS,
                           args=(at, STORM_WINDOWS, (sh_dir, hour)),
                           timeout=900)
        out["spawn_s"] = time.perf_counter() - t0
        fast = run_project_fast("synthetic", inp=copy.deepcopy(hour),
                                end_day=end_day, float_dtype=torch.float32,
                                device=DEVICE, outpath=sd_dir, verbose=False)
        out["hour"] = compare_outputs(sh_dir, sd_dir)
        out["hour"].update(wall_s=ranks[0]["hour"]["wall_s"],
                           nfe=ranks[0]["hour"]["nfe"], fast_nfe=fast.bdf.nfe)
        gap = float(np.abs(ranks[0]["hour"]["y"]
                           - fast.y_np().astype(np.float64)).max())
        log(f"  run_project_sharded over one hour: {ranks[0]['hour']['nfe']}"
            f" NFE (run_project_fast {fast.bdf.nfe}), wall "
            f"{ranks[0]['hour']['wall_s']:.2f} s, state gap {gap:.3e} m")
        out["hour"]["max_dy_m"] = gap

    k0 = ranks[0]["kernel"]
    for r in ranks:
        for name in ("kernel", "plain"):
            a = r[name]
            log(f"  rank {r['rank']} {name}: nsteps {a['nsteps']}, nfe "
                f"{a['nfe']}, Newton iterations {a['newton_iters']}, "
                f"launches {a['launches']}, set-up {a['setup_s']:.2f} s, "
                f"first RHS + linearization + J·v {a['first_call_s']:.2f} s")
            b = ranks[0][name]
            check((a["nsteps"], a["nfe"], a["newton_iters"])
                  == (b["nsteps"], b["nfe"], b["newton_iters"]),
                  f"rank {r['rank']} {name}: steps/NFE/iterations differ")
        n, it, m = r["kernel"]["launches"], r["kernel"]["newton_iters"], \
            r["kernel"]["krylov_m"]
        check(n["edge_coeff"] == it and n["edge_apply"] == m * it
              and n["edge_flux"] == STORM_WINDOWS,
              f"rank {r['rank']}: {n} for {it} Newton iterations in "
              f"{STORM_WINDOWS} windows")
        check(r["plain"]["launches"] == dict.fromkeys(n, 0),
              f"rank {r['rank']}: the plain run launched a kernel")
    gaps = []
    for w in range(STORM_WINDOWS):
        kp = float(np.abs(k0["ys"][w] - ranks[0]["plain"]["ys"][w]).max())
        ks = float(np.abs(k0["ys"][w] - ref_y["f32"][w]).max())
        sd = float(np.abs(ref_y["f32"][w] - ref_y["f64"][w]).max())
        (n_x, s_x), (n_g, s_g) = (k0["collectives"][w][k] for k in (
            "ppermute_round", "all_gather"))
        log(f"  sharded, window {w}: wall {k0['wall_s'][w]:.3f} s (plain "
            f"{ranks[0]['plain']['wall_s'][w]:.3f} s), rank 0: {n_x} halo "
            f"exchanges {s_x:.3f} s, {n_g} gathers {s_g:.3f} s; max |dy| "
            f"kernel-plain {kp:.3e} m, sharded-single f32 {ks:.3e} m, single "
            f"f32-f64 {sd:.3e} m")
        check(kp < BAR_DRIVER, f"sharded: kernel vs plain {kp:.3e} m "
              f"(window {w})")
        if sd < BAR_DRIVER:
            check(ks < BAR_DRIVER, f"sharded vs single-device f32 {ks:.3e} "
                  f"m (window {w})")
        else:
            log(f"    sharded-single not gated: single f32-f64 {sd:.3e} m")
        gaps.append({"kernel-plain": kp, "sharded-single": ks,
                     "single_f32-f64": sd})
    nfe1 = refs["f32"].bdf.nfe
    check(abs(k0["nfe"] - nfe1) <= 0.02 * nfe1,
          f"sharded NFE {k0['nfe']} vs single-device {nfe1}")
    log(f"  NFE: sharded {k0['nfe']}, single-device f32 {nfe1}; 4 ranks "
        "time-sliced on one card say nothing of multi-GPU speed")
    out.update(max_dy=gaps, nfe=k0["nfe"], single_nfe=nfe1,
               newton_iters=k0["newton_iters"],
               launches=[r["kernel"]["launches"] for r in ranks],
               window_wall_s=k0["wall_s"], collectives=k0["collectives"],
               plain_window_wall_s=ranks[0]["plain"]["wall_s"],
               setup_s=k0["setup_s"], first_call_s=k0["first_call_s"])
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        # two ranks on two cards over NCCL, with the edge kernels
        nccl = comm.spawn(sharded_rank, 2, "nccl", ["cuda:0", "cuda:1"],
                          args=(at, STORM_WINDOWS, None, ("kernel",)),
                          timeout=600)
        a = nccl[0]["kernel"]
        for w in range(STORM_WINDOWS):
            ks = float(np.abs(a["ys"][w] - ref_y["f32"][w]).max())
            log(f"  NCCL, 2 ranks, window {w}: sharded-single f32 "
                f"{ks:.3e} m")
            if gaps[w]["single_f32-f64"] < BAR_DRIVER:
                check(ks < BAR_DRIVER, f"NCCL: {ks:.3e} m (window {w})")
        check(nccl[1]["kernel"]["nfe"] == a["nfe"], "NCCL ranks' NFE differ")
        out["nccl"] = {"nfe": a["nfe"], "window_wall_s": a["wall_s"]}
    else:
        log(f"  NCCL with more than one rank was not exercised: {n_gpu} GPU "
            "on this host")
        out["nccl"] = None
    return out


def phase_calib(torch, kernels, bdf, smi: str) -> dict:
    """Phase 18: the port's autocalibration (shud_tpu_torch.tools) on the
    mega-32k mesh, a twin experiment in float32: the observations are the
    mega path's daily outlet discharge over CALIB_DAYS at CALIB_TRUTH.  The
    objective at the truth scores NSE >= 1 - 1e-9 (the mega path is bitwise
    repeatable); the search (--log, CALIB_GENS x CALIB_POP candidates from
    the default calibration) with every launch count set to 0 just before
    and read just after: mega_rhs = Newton iterations, mega_jvp = krylov_m
    x Newton iterations, mega_diag = windows, no edge kernel; the card's
    allocated memory after each candidate within 1 MiB of the first's; a
    budget below day 0's NFE in one-day chunks aborts after day 1 with
    the penalty; the tournament over {truth, default} writes the truth;
    one storm window of the truth's candidate under the profiler;
    ``python -m shud_tpu_torch.tools.autocalibrate -h`` exits 0."""
    import numpy as np

    from shud_tpu_torch.io.project import read_calib
    from shud_tpu_torch.tools import autocalibrate as tac
    from shud_tpu_torch.tools import calib_tournament as ttour
    from shud_tpu_torch.utils.calibrate import (calib_from_vector,
                                                run_with_calib)

    t_phase = time.perf_counter()
    names = list(CALIB_TRUTH)
    truth = np.array(list(CALIB_TRUTH.values()))
    inp = storm_project(*MEGA_MESH, end_day=CALIB_DAYS)
    base = copy.deepcopy(inp.calib)
    default = [getattr(base, n) for n in names]

    # the observations: the mega path's daily discharge at the truth, day 0
    # apart (its NFE sets the abort's budget)
    sim = run_with_calib("synthetic", ".", calib_from_vector(
        names, truth, base=base), CALIB_DAYS, float_dtype=torch.float32,
        inp=inp, device=DEVICE)
    check(sim.mega is not None, "calibration mesh not on the mega path")
    wpd = int(round(1440.0 / inp.control.solver_step))
    day0 = tac.run_daily(sim, 1, 1)
    nfe_day0 = sim.bdf.nfe
    rest = tac.run_daily(sim, CALIB_DAYS - 1, CALIB_DAYS - 1)
    del sim
    obs_t = (np.arange(CALIB_DAYS) + 0.5) * 1440.0
    obs_q = np.concatenate([day0.q, rest.q])
    log(f"  {smi}; observations at {CALIB_TRUTH}: {obs_q.tolist()} m3/day; "
        f"day 0 nfe {nfe_day0}")
    check(bool(np.isfinite(obs_q).all()) and obs_q.std() > 0,
          "degenerate observations")

    parse = tac.build_parser().parse_args
    common = ["synthetic", "--f32", "--params", ",".join(names), "--days",
              str(CALIB_DAYS), "--chunk-days", str(CALIB_DAYS)]
    out = {"obs_m3_day": obs_q.tolist(), "nfe_day0": nfe_day0}
    inp.calib = copy.deepcopy(base)
    truth_obj = tac.Objective(parse(common), inp, obs_t, obs_q)
    out["truth_nse"] = -float(truth_obj.evaluate(truth))
    log(f"  the objective at the truth: NSE {out['truth_nse']!r}")
    check(out["truth_nse"] >= 1 - 1e-9, f"truth scores {out['truth_nse']}")

    with tempfile.TemporaryDirectory(prefix="shud_calib_") as outdir:
        inp.calib = copy.deepcopy(base)
        args = parse(common + ["--log", "--gens", str(CALIB_GENS),
                               "--popsize", str(CALIB_POP), "-o", outdir])
        for k in kernels:
            k.reset_launch_counts()
        iters0 = bdf.newton_iters
        t0 = time.perf_counter()
        res = tac.calibrate(args, inp, obs_t, obs_q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for k in kernels for n, c in k.launch_counts.items()}
        iters = bdf.newton_iters - iters0
        cands = res.candidates
        windows = sum(c.days for c in cands) * wpd
        krylov_m = bdf.SolverConfig().krylov_m
        log(f"  search: {len(cands)} candidates in {wall:.2f} s, "
            f"{iters} Newton iterations, {windows} windows; launches "
            f"{counts}")
        check(len(cands) == CALIB_GENS * CALIB_POP, "wrong candidate count")
        check(counts["mega_rhs"] == iters
              and counts["mega_jvp"] == krylov_m * iters
              and counts["mega_diag"] == windows,
              f"calibration: {counts} for {iters} Newton iterations in "
              f"{windows} windows")
        for k in ("edge_flux", "edge_coeff", "edge_apply"):
            check(counts[k] == 0, f"{k} launched in the calibration")
        mem = [c.device_bytes for c in cands]
        check(all(abs(m - mem[0]) <= 1 << 20 for m in mem),
              f"device memory grows across candidates: {mem}")
        out.update(
            search_wall_s=wall, launches=counts, newton_iters=iters,
            windows=windows, best_nse=res.score, best_x=res.x.tolist(),
            device_bytes=mem,
            candidates=[dict(x=c.x.tolist(), nse=-c.f, nfe=c.nfe,
                             setup_s=c.setup_s, run_s=c.run_s,
                             s_per_day=c.run_s / c.days) for c in cands])
        check(os.path.isfile(res.path), "no .cfg.calib.opt written")
        log("  " + tac.cost_summary(cands))
        log(f"  best NSE {res.score!r} at {res.x.tolist()}; set-up per "
            f"candidate {[round(c.setup_s, 3) for c in cands]} s, wall per "
            f"candidate-day {[round(c.run_s / c.days, 3) for c in cands]} s, "
            f"NFE {[c.nfe for c in cands]}; device bytes {mem}")

        # the NFE budget: below day 0's, one-day chunks
        inp.calib = copy.deepcopy(base)
        abort = tac.Objective(parse(common + [
            "--chunk-days", "1", "--nfe-budget-per-day",
            str(nfe_day0 - 1)]), inp, obs_t, obs_q)
        f = abort.evaluate(truth)
        c = abort.candidates[0]
        check(f == tac.ABORT_PENALTY and c.aborted and c.days == 1,
              f"budget {nfe_day0 - 1}: f {f}, {c.days} days")
        out["abort"] = dict(f=f, days=c.days, nfe=c.nfe)

        # the tournament over {truth, default}
        inp.calib = copy.deepcopy(base)
        targs = ttour.build_parser().parse_args([
            "synthetic", "--days", str(CALIB_DAYS), "--warmup", "0",
            "--chunk-days", str(CALIB_DAYS), "--params", ",".join(names),
            "--cand", "default:" + ",".join(map(repr, default)),
            "--cand", "truth:" + ",".join(map(repr, truth.tolist()))])
        entries, path = ttour.tournament(targs, inp, obs_t, obs_q, outdir)
        got = read_calib(path)
        check(entries[0].label == "truth"
              and [getattr(got, n) for n in names] == truth.tolist(),
              f"tournament: {[(e.label, e.nse) for e in entries]}, wrote "
              f"{[getattr(got, n) for n in names]}")
        out["tournament"] = {e.label: dict(nse=e.nse, aet_mm=e.aet_mm,
                                           p_mm=e.p_mm, nfe=e.nfe,
                                           wall_s=e.wall_s)
                             for e in entries}

    # a candidate's storm window under the profiler (reported)
    inp.calib = calib_from_vector(names, truth, base=base)
    out["profile"] = phase_profile(inp, torch)

    r = subprocess.run([sys.executable, "-m",
                        "shud_tpu_torch.tools.autocalibrate", "-h"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    log(f"  python -m shud_tpu_torch.tools.autocalibrate -h: exit "
        f"{r.returncode}")
    check(r.returncode == 0 and "--cpu" in r.stdout,
          f"autocalibrate -h: exit {r.returncode}, {r.stderr[-500:]}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim-minutes", type=float, default=1440.0,
                    help="simulated span of each main-path run (minutes)")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not all((ROOT / src).is_file() for src in (EDGE_SOURCE, MEGA_SOURCE)):
        print("chip_smoke: shud_tpu_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tests"))  # torch_variants: shared inputs

    from torch_variants import branch_rivers, with_bc

    from shud_tpu_torch.core import cuda_build, edge, mega
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.solver import bdf
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    summary = {"card": smi, "sim_minutes": args.sim_minutes}

    # phase 2: build the kernels (both sources, one nvcc each, in parallel)
    lib = cuda_build.load_library()
    info = cuda_build.build_info
    log(f"kernels built in {info['seconds']:.2f} s: {info['path']}")
    for line in info["ptxas"].splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log("  " + line.strip())
    check(lib is not None, "no kernel library")
    summary["build_s"] = info["seconds"]

    # phase 3: the meshes
    t0 = time.perf_counter()
    days = max(1.0, args.sim_minutes / 1440)
    inp = storm_project(*EDGE_MESH, end_day=days)
    inp32 = storm_project(*MEGA_MESH, end_day=days)
    for p, per_edge in ((inp, 1440), (inp32, 0)):
        for name in vars(p.control):
            if name.startswith("dt_"):
                setattr(p.control, name, 1440)
        # the per-edge flux channels need rhs_full's [Ne,3] fluxes, which
        # take the window diagnostics off the mega kernel (as in JAX)
        p.control.dt_Qe_subx = p.control.dt_Qe_surfx = per_edge
    md, md32 = build_mesh(inp), build_mesh(inp32)
    lake_md = build_mesh(storm_project(*LAKE_MESH, 1.0, with_lake=True,
                                       localize=False))
    branched_md = with_bc(build_mesh(branch_rivers(
        make_synthetic_project(*MEGA_MESH), MEGA_MESH[0])))
    summary["setup_s"] = time.perf_counter() - t0
    log(f"meshes: {md.num_ele} cells, {md.num_riv} reaches, {md.num_seg} "
        f"segments; {md32.num_ele} cells, {md32.num_riv} reaches; lake mesh "
        f"{lake_md.num_ele} cells, {lake_md.num_lake} lake; branched "
        f"{branched_md.num_ele} cells, {branched_md.num_riv} reaches, "
        f"{branched_md.num_seg} segments; set-up {summary['setup_s']:.2f} s")
    check(md.num_ele == 2 * EDGE_MESH[0] * EDGE_MESH[1]
          and md32.num_ele == 2 * MEGA_MESH[0] * MEGA_MESH[1],
          "wrong mesh size")
    check(mega.build_mega_tables(md) is None, "131k mesh on the mega path")

    results, device_times = {}, {}
    log("phase 4: edge kernels vs plain versions (131k)")
    phase_kernels(md, torch, edge, results, device_times)
    log("phase 5: mega kernels vs plain versions (32k, lake, branched)")
    summary["mega_design"] = phase_mega_kernels(
        {"32k": md32, "lake8k": lake_md, "branched": branched_md}, torch,
        mega, results, device_times)
    summary["kernel_device_ms"] = device_times
    log("phase 6: full RHS and J.v")
    phase_rhs(md, lake_md, torch, summary)
    summary["mega_rhs_32k"] = phase_mega_rhs(md32, torch, mega)

    log("phase 7: the main paths (run_project_fast, f32, cuda)")
    counts = {}
    for name, p, want, absent, start, span in (
            ("edge_131k", inp, edge, mega, *EDGE_MAIN_SPAN),
            ("mega_32k", inp32, mega, edge, 0.0, args.sim_minutes)):
        with tempfile.TemporaryDirectory(prefix="shud_smoke_") as outdir:
            run = phase_main(copy.deepcopy(p), torch, (edge, mega), bdf,
                             min(span, args.sim_minutes), outdir, start)
        for k in want.launch_counts:
            check(run["launches"][k] > 0, f"{k} not launched on {name}")
        for k in absent.launch_counts:
            check(run["launches"][k] == 0, f"{k} launched on {name}")
        check(run["mega"] == (want is mega), f"{name}: wrong RHS path")
        it, m = run["newton_iters"], run["krylov_m"]
        if want is edge:
            # linearized once per Newton iteration (the coefficient kernel
            # in the primal), one apply per Krylov vector; edge_flux only
            # in the window diagnostics (no quad_rates: SHUD_WB_DIAG off)
            n = run["launches"]
            check(n["edge_coeff"] == it and n["edge_apply"] == m * it
                  and n["edge_flux"] == run["windows"],
                  f"{name}: {n} for {it} Newton iterations in "
                  f"{run['windows']} windows")
        if want is mega:
            # linearized once per Newton iteration: one RHS launch, then
            # one tangent launch per Krylov vector
            check(run["launches"]["mega_rhs"] == it
                  and run["launches"]["mega_jvp"] == m * it,
                  f"{name}: {run['launches']} for {it} Newton iterations")
            check(run["launches"]["mega_diag"] == run["windows"],
                  f"{name}: {run['launches']['mega_diag']} mega_diag "
                  f"launches in {run['windows']} windows")
        counts.update({k: run["launches"][k] for k in want.launch_counts})
        summary[f"main_{name}"] = run

    log("phase 8: kernel paths vs reference paths, determinism")
    summary["paths_edge_131k"] = phase_paths(
        inp, torch, {"kernel": {}, "plain": {"edge_kernel": False}},
        {"kernel-plain": None}, "131k edge kernels vs plain")
    summary["paths_mega_32k"] = phase_paths(
        inp32, torch, {"kernel": {}, "plain": {"mega_kernel": False},
                       "eager": {"mega": False},
                       "eager64": {"mega": False,
                                   "float_dtype": torch.float64}},
        {"kernel-plain": None, "kernel-eager": "eager-eager64"},
        "32k mega")
    log("phase 9: the cryosphere, a frosty window and 6 storm windows")
    summary["cryo_mega_32k"] = phase_paths(
        frost_project(inp32), torch,
        {"kernel": {}, "plain": {"mega_kernel": False}},
        {"kernel-plain": None}, "32k mega, frozen ground", start=710.0,
        n_windows=STORM_WINDOWS + 1, bitwise=(("kernel", "plain"),),
        repeat=False, after=frozen_fractions)
    summary["cryo_edge_131k"] = phase_paths(
        frost_project(inp), torch,
        {"kernel": {}, "plain": {"edge_kernel": False}},
        {"kernel-plain": None}, "131k edge kernels, frozen ground",
        start=710.0, n_windows=STORM_WINDOWS + 1, repeat=False,
        after=frozen_fractions)
    log("phase 10: the per-window driver vs the fused driver (131k)")
    summary["per_window_131k"] = phase_paths(
        inp, torch, {"per_window": {"per_window": True}, "fused": {}},
        {"per_window-fused": None}, "131k per-window vs fused",
        repeat=False)
    log("phase 11: the command line")
    summary["cli"] = phase_cli(torch)
    log("phase 12: profile of one storm window on each path")
    summary["profile_edge_131k"] = phase_profile(inp, torch)
    summary["profile_mega_32k"] = phase_profile(inp32, torch)
    log("phase 13: the operator-split driver (-g, f64) vs the implicit one")
    spun32 = spin_up(inp32, torch)
    summary["split_32k"] = phase_split(inp32, torch, (edge, mega), "32k",
                                       spun32)
    lake_inp = storm_project(*LAKE_MESH, 1.0, with_lake=True, localize=False)
    summary["split_lake8k"] = phase_split(lake_inp, torch, (edge, mega),
                                          "lake 8k", spin_up(lake_inp, torch))
    log("phase 14: adaptive paths vs the fixed-step f64 truth (32k)")
    summary["truth_32k"] = phase_truth(inp32, torch, edge, mega, bdf, spun32)
    log("phase 15: NetCDF forcing and output (32k)")
    summary["netcdf_32k"] = phase_netcdf(inp32, torch, mega, (edge, mega))
    log(f"phase 16: the refined mesh ({REFINE_LEVELS} levels of the 131k)")
    summary["refined"] = phase_refined(inp, torch, edge, bdf)
    log(f"phase 17: the sharded driver ({SHARDS} ranks, 131k, gloo)")
    summary["sharded_131k"] = phase_sharded(inp, torch, edge, smi)
    log(f"phase 18: autocalibration on the mega path ({MEGA_MESH[0]}x"
        f"{MEGA_MESH[1]} mesh, f32)")
    summary["calib_32k"] = phase_calib(torch, (edge, mega), bdf, smi)

    summary["script_s"] = time.perf_counter() - t_script
    log(f"script: {summary['script_s']:.1f} s")
    log(json.dumps({"summary": summary}))
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep[name],
                    launches=counts[name], **results[name])
               for src, rep in ((EDGE_SOURCE, REPLACES),
                                (MEGA_SOURCE, MEGA_REPLACES))
               for name in rep]
    for k in kernels:  # the later main paths' launches
        if k["name"] in REPLACES:  # phase 17's, per rank
            k["sharded_launches"] = [
                n[k["name"]] for n in summary["sharded_131k"]["launches"]]
        else:  # phase 18's main path: the search's launches
            k["calib_launches"] = summary["calib_32k"]["launches"][k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
