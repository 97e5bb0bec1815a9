#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (shud_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # one simulated day, 131,072 cells
    python3 chip_smoke.py --sim-minutes 60  # a shorter main-path run

Phases (any failed check raises and the script exits nonzero; nothing
falls back to the CPU):
 1. the card (nvidia-smi name and power limit), exit if CUDA is absent;
 2. build the edge-flux CUDA kernels from shud_tpu_torch/csrc/edge_flux.cu;
 3. build a 131,072-cell synthetic watershed, shuffled then RCM-localised;
 4. each kernel against its plain PyTorch version on the card, both
    boundary modes, every 7th cell dry; per-call times (CUDA events,
    median of 20);
 5. the full f32 RHS with vs without the kernels (and on a lake mesh);
 6. the main path: run_project_fast in float32 on the card, with the
    kernel launch counters reset just before and read just after;
 7. 6 windows on the kernel path vs the plain f32 path, from the storm's
    onset;
 8. one window twice on the kernel path, bitwise identical;
 9. one storm window under torch.profiler: device busy time and idle
    share, kernel time by name (reported, not checked).
The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "shud_tpu_torch/csrc/edge_flux.cu"
REPLACES = {
    "edge_flux": "shud_tpu/core/pallas_edge.py:480",
    "edge_coeff": "shud_tpu/core/pallas_edge.py:532",
    "edge_apply": "shud_tpu/core/pallas_edge.py:664",
}
# bars: the Pallas edge kernel's against XLA (tests/test_pallas_edge.py)
BAR_Q_SURF = 2e-6
BAR_Q_SUB = 1e-6
BAR_TANGENT = 1e-6
BAR_RHS = 2e-6
BAR_DRIVER = 2e-5  # [m], tests/test_pallas_mega.py:254
DEVICE = "cuda"


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


def device_ms_per_call(fn, reps: int = 20):
    """Device (kernel) time per call of *fn* from torch.profiler, or None
    when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_self_device_us(r) for r in prof.key_averages())
    return busy_us / 1e3 / reps if busy_us > 0 else None


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
    calls = {
        "edge_flux": (lambda: edge.edge_flux(sf, gw, kh, et, True),
                      lambda: edge.edge_flux_plain(sf, gw, kh, et, True)),
        "edge_coeff": (lambda: edge.edge_coeff(sf, gw, kh, et, True),
                       lambda: edge.edge_coeff_plain(sf, gw, kh, et, True)),
        "edge_apply": (lambda: edge.edge_apply(coeffs, *tan, et),
                       lambda: edge.edge_apply_plain(coeffs, *tan, et)),
    }
    for name, (kern, plain) in calls.items():
        ms, plain_ms = time_ms(kern), time_ms(plain)
        dev_ms, dev_plain_ms = device_ms_per_call(kern), device_ms_per_call(plain)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call "
            f"(CUDA events); device time {dev_ms} ms vs {dev_plain_ms} ms "
            f"(profiler)")
        results[name] = {"max_abs_err": err[name], "ms": ms,
                         "plain_ms": plain_ms}
        device_times[name] = {"device_ms": dev_ms,
                              "plain_device_ms": dev_plain_ms}


def phase_rhs(md, lake_md, torch, summary):
    """Phase 5: the full f32 RHS with vs without the kernels."""
    from shud_tpu_torch.core.device import to_torch
    from shud_tpu_torch.core.rhs import rhs

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
        summary["rhs_ms"] = time_ms(lambda: rhs(dm_k, fs, 0.0, y, cb))
        summary["rhs_plain_ms"] = time_ms(lambda: rhs(dm_p, fs, 0.0, y, cb))
        summary["jvp_ms"] = time_ms(lambda: jv(dm_k))
        summary["jvp_plain_ms"] = time_ms(lambda: jv(dm_p))
        log("  rhs per eval: kernel %.3f ms, plain %.3f ms; J.v: kernel "
            "%.3f ms, plain %.3f ms" % (summary["rhs_ms"],
                                        summary["rhs_plain_ms"],
                                        summary["jvp_ms"],
                                        summary["jvp_plain_ms"]))


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


def phase_main(inp, torch, edge, bdf, summary, outdir):
    """Phase 6: the main path, run_project_fast in f32 on the card."""
    import numpy as np

    from shud_tpu_torch.driver.run_fast import run_project_fast

    minutes = summary["sim_minutes"]
    edge.reset_launch_counts()
    syncs0 = bdf.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = run_project_fast("synthetic", inp=inp, end_day=minutes / 1440.0,
                           float_dtype=torch.float32, device=DEVICE,
                           outpath=outdir, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(edge.launch_counts)
    syncs = bdf.host_syncs - syncs0
    ne = sim.md.num_ele
    nfe, nsteps = sim.bdf.nfe, sim.bdf.nsteps
    log(f"  main path: {minutes:g} simulated minutes, nsteps {nsteps}, "
        f"nfe {nfe}, wall {wall:.2f} s, host syncs {syncs}")
    log(f"  cell-steps/s (NumEle x NFE / wall): {ne * nfe / wall:.6g}")
    log(f"  launches: {counts}")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(float(sim.bdf.t) == minutes, f"stopped at t={sim.bdf.t}")
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
    summary.update(nsteps=nsteps, nfe=nfe, wall_s=wall, host_syncs=syncs,
                   cell_steps_per_s=ne * nfe / wall, num_ele=ne,
                   output_files=len(files))
    return counts


def phase_paths(inp, torch, summary):
    """Phases 7-8: kernel vs plain f32 over 6 windows; determinism.  Both
    start at the storm's onset (minute 720), where the surface wets: before
    it the surface is dry and the two paths agree trivially."""
    from shud_tpu_torch.driver.fused import FusedSimulation

    def sim(**kw):
        start = copy.deepcopy(inp)
        start.control.day_start = 0.5
        return FusedSimulation.create("synthetic", inp=start,
                                      float_dtype=torch.float32,
                                      device=DEVICE, **kw)

    a, b = sim(), sim(edge_kernel=False)
    check(a.dm.edge_kernel and not b.dm.edge_kernel, "paths not as asked")
    a.advance_interval(60.0)
    b.advance_interval(60.0)
    d = float((a.bdf.y.double() - b.bdf.y.double()).abs().max())
    log(f"  6 storm windows kernel vs plain f32: max |dy| {d:.3e} m, nfe "
        f"{a.bdf.nfe} vs {b.bdf.nfe}")
    check(d < BAR_DRIVER, "kernel path drifts from the plain f32 path")
    summary["six_window_max_dy"] = d

    c, e = sim(), sim()
    c.advance_interval(10.0)
    e.advance_interval(10.0)
    same = torch.equal(c.bdf.y, e.bdf.y) and c.bdf.nfe == e.bdf.nfe
    log(f"  one storm window twice on the kernel path: bitwise equal {same}")
    check(same, "kernel path is not deterministic")


def phase_profile(inp, torch, summary):
    """Phase 9: where one storm window's time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from shud_tpu_torch.driver.fused import FusedSimulation

    start = copy.deepcopy(inp)
    start.control.day_start = 0.5
    sim = FusedSimulation.create("synthetic", inp=start,
                                 float_dtype=torch.float32, device=DEVICE)
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
    prof_summary = {
        "window_wall_s": wall, "nfe": sim.bdf.nfe - nfe0,
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / wall) if busy_s > 0 else None,
        "kernel_launches": sum(c for _, us, c in rows if us > 0),
        "top_device_ms": {k[:60]: round(us / 1e3, 3) for k, us, _ in top},
    }
    log(f"  one storm window under the profiler: wall {wall:.3f} s, device "
        f"busy {busy_s:.3f} s, idle share {prof_summary['device_idle_share']}")
    for k, us, c in top:
        log(f"    {us / 1e3:9.3f} ms  {c:6d}x  {k[:70]}")
    summary["profile"] = prof_summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim-minutes", type=float, default=1440.0,
                    help="simulated span of the main-path run (minutes)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "shud_tpu_torch" / "csrc" / "edge_flux.cu").is_file():
        print("chip_smoke: shud_tpu_torch is not next to this script",
              file=sys.stderr)
        return 2

    from shud_tpu_torch.core import edge
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.solver import bdf

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

    # phase 2: build the kernels
    lib = edge.build_library()
    log(f"kernels built in {edge.build_info['seconds']:.2f} s: "
        f"{edge.build_info['path']}")
    for line in edge.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  " + line.strip())
    check(lib is not None, "no kernel library")
    summary["build_s"] = edge.build_info["seconds"]

    # phase 3: the 131,072-cell mesh
    t0 = time.perf_counter()
    inp = storm_project(256, 256, end_day=max(1.0, args.sim_minutes / 1440))
    for name in vars(inp.control):
        if name.startswith("dt_"):
            setattr(inp.control, name, 1440)
    md = build_mesh(inp)
    lake_md = build_mesh(storm_project(64, 64, 1.0, with_lake=True,
                                       localize=False))
    summary["setup_s"] = time.perf_counter() - t0
    log(f"mesh: {md.num_ele} cells, {md.num_riv} reaches, {md.num_seg} "
        f"segments; lake mesh {lake_md.num_ele} cells, {lake_md.num_lake} "
        f"lake; set-up {summary['setup_s']:.2f} s")
    check(md.num_ele == 131072, "wrong mesh size")

    log("phase 4: kernels vs plain versions")
    results, device_times = {}, {}
    phase_kernels(md, torch, edge, results, device_times)
    summary["kernel_device_ms"] = device_times
    log("phase 5: full RHS with vs without kernels")
    phase_rhs(md, lake_md, torch, summary)
    log("phase 6: main path (run_project_fast, f32, cuda)")
    with tempfile.TemporaryDirectory(prefix="shud_smoke_") as outdir:
        counts = phase_main(copy.deepcopy(inp), torch, edge, bdf, summary,
                            outdir)
    log("phases 7-8: kernel vs plain driver path, determinism")
    phase_paths(inp, torch, summary)
    log("phase 9: profile of one storm window")
    phase_profile(inp, torch, summary)

    log(json.dumps({"summary": summary}))
    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
