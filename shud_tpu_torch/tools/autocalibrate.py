"""Autocalibration against observed outlet discharge.

The counterpart of the JAX package's ``tools/autocalibrate.py``, with its
flags, search and outputs.  The reference's calibration workflow drives an
external CMA-ES through the ``-e dir_cmaes`` CLI hook and the
``globalCal::copy(varname[], x[])`` vector API (CommandIn.cpp:210-212,
ModelConfigure.cpp:368-375); this tool closes the loop in-process: CMA-ES
(``utils/calibrate.py``) proposes calibration vectors, each candidate runs
the fused driver (``FusedSimulation``) for ``--days`` simulated days, and
the objective is -NSE of daily outlet discharge against the project's
``tsd.obs``.

Each candidate builds its own simulation (mesh, megakernel tables, device
tensors) from the loaded project and the forcing tables of the first; the
previous candidate's simulation is dropped before the next is built, so
device memory does not grow with the candidate count.  With ``--f32`` on a
mesh the megakernel tables admit (at most 32,768 cells and 64 lakes) every
candidate runs the mega kernels, above that the eager RHS with the edge
kernels; without ``--f32`` the eager float64 path.  Runs on the card unless
``--cpu`` is given; without a card it raises.

    python -m shud_tpu_torch.tools.autocalibrate ccw --f32 --days 60 \\
        --gens 8 --params geol_ksath,soil_kinf,lc_rough
    python -m shud_tpu_torch.tools.autocalibrate ccw --cpu --days 2 ...

Writes the best calibration to output/<prj>.out/<prj>.cfg.calib.opt (the
format of .cfg.calib, usable with ``-c`` by either package).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from shud_tpu_torch.io.project import (
    _CALIB_KEYS,
    load_project,
    read_tsd_csv,
    write_calib,
)
from shud_tpu_torch.utils.calibrate import (
    calib_from_vector,
    cma_es,
    nse,
    run_with_calib,
)

# the score of a candidate aborted over its NFE budget (an NSE is <= 1)
ABORT_PENALTY = 5.0


class UsageError(ValueError):
    """A flag value the tool refuses; ``main`` reports it as a usage
    error, as the JAX tool's ``ap.error`` does."""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m shud_tpu_torch.tools.autocalibrate",
        description="CMA-ES calibration against observed outlet discharge")
    ap.add_argument("project")
    ap.add_argument("-b", "--base", default=".")
    ap.add_argument("--days", type=float, default=60.0)
    ap.add_argument("--gens", type=int, default=8)
    ap.add_argument("--popsize", type=int, default=None)
    ap.add_argument("--params", default="geol_ksath,soil_kinf,lc_rough",
                    help="comma-separated calibration keys to optimise")
    ap.add_argument("--sigma0", type=float, default=0.3)
    ap.add_argument("--log", action="store_true",
                    help="search multiplicative keys in log10 space with "
                         "wide bounds (10^[-2.5, 2.5]); `*_add` keys stay "
                         "linear.  Conductivity multipliers span orders of "
                         "magnitude — log search reaches them.")
    ap.add_argument("--log-bound", type=float, default=2.5,
                    help="half-width of the log10 search box for "
                         "multiplicative keys under --log (default 2.5 "
                         "decades)")
    ap.add_argument("--bound", action="append", default=[],
                    help="per-key search-box override 'key=lo:hi' in the "
                         "key's search space (log10 for multiplicative "
                         "keys under --log, linear otherwise); e.g. "
                         "'et_etp=-0.5:0.5' keeps the ET multiplier "
                         "physically plausible (0.3-3.2x)")
    ap.add_argument("--nfe-budget-per-day", type=int, default=0,
                    help="abort a candidate once its RHS-eval count "
                         "exceeds budget*days (pathological parameter "
                         "combinations go 100-200x stiffer than normal; "
                         "fail fast with a penalty score instead of "
                         "running for minutes).  0 = no budget")
    ap.add_argument("--best-file", default=None,
                    help="path to persist the best vector as it improves "
                         "(one line: NSE,x1,x2,...) — lets a watchdog "
                         "resume via --x0 after the process dies")
    ap.add_argument("--x0", default=None,
                    help="comma-separated initial vector (same order as "
                         "--params) to seed from a previous round")
    ap.add_argument("--chunk-days", type=int, default=30,
                    help="days advanced per host transfer (daily "
                         "discharge from the per-window outlet discharge "
                         "of the chunk)")
    ap.add_argument("--warmup", type=float, default=0.0,
                    help="spin-up days excluded from the NSE score "
                         "(simulated but not fitted)")
    ap.add_argument("--wb-penalty", type=float, default=0.0,
                    help="multi-objective water-balance term: subtract "
                         "LAMBDA*max(0,(AET-P)/P) from the NSE score, "
                         "where AET/P are basin means over the window — "
                         "rejects the effective-parameter regime that "
                         "sustains AET > precipitation by storage "
                         "drawdown")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("-o", "--output", default=None,
                    help="directory for the optimised calib "
                         "(default ./output/<prj>.out — NEVER under "
                         "a read-only --base)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap


def param_names(params: str) -> list[str]:
    """The calibration keys of ``--params``; unknown keys are refused."""
    names = [s.strip() for s in params.split(",") if s.strip()]
    bad = [n for n in names if n.lower() not in _CALIB_KEYS]
    if bad:
        raise UsageError(f"unknown calibration key(s): {', '.join(bad)}")
    return names


def read_obs(inp, project: str) -> tuple[np.ndarray, np.ndarray]:
    """The project's observed outlet discharge: (t [min], Q [m3/day])."""
    obs_path = os.path.join(inp.paths.inpath, f"{project}.tsd.obs")
    if not os.path.exists(obs_path):
        raise SystemExit(f"{project} has no tsd.obs — nothing to fit")
    _, obs_t, obs_data = read_tsd_csv(obs_path)
    return obs_t, obs_data[:, 0]  # gauge discharge (Q_cmd column)


def daily_obs(obs_t, obs_q, ndays: int) -> np.ndarray:
    """Observed daily means over days [0, ndays); NaN on a day without a
    record."""
    obs_day = np.floor(obs_t / 1440.0).astype(int)
    obs_daily = np.full(ndays, np.nan)
    for d in range(ndays):
        m = obs_day == d
        if m.any():
            obs_daily[d] = np.nanmean(obs_q[m])
    return obs_daily


@dataclasses.dataclass
class DailyRun:
    """A candidate's simulated days."""
    q: np.ndarray  # [ndays] daily mean outlet |Q| [m3/day]
    aet_sum: float  # basin AET and precipitation [m3/min], day-weighted
    p_sum: float
    area: float  # the basin's area [m2]
    days: int  # days simulated (fewer than ndays when aborted)
    aborted: bool


def run_daily(sim, ndays: int, chunk_days: int, water: bool = False,
              nfe_budget_per_day: int = 0) -> DailyRun:
    """Advance *sim* ``ndays`` days, ``chunk_days`` at a time, with one
    host transfer a chunk: the outlet reaches' per-window discharge (the
    window diagnostics), and under *water* the basin's mean AET and
    precipitation.  With a budget, stop after the first chunk that leaves
    the NFE above budget x the days so far (prorated: a 100x-stiff
    candidate aborts after its first chunk)."""
    md = sim.md
    outlet = np.flatnonzero((np.asarray(md.riv_down) < 0)
                            & (np.asarray(md.riv_to_lake) < 0))
    outlet_dev = torch.as_tensor(outlet, device=sim.bdf.y.device)
    wpd = int(round(1440.0 / sim.inp.control.solver_step))
    area = np.asarray(md.area)
    qd = np.zeros(ndays)
    aet_sum = p_sum = 0.0
    d0 = 0
    aborted = False
    while d0 < ndays and not aborted:
        nd = min(chunk_days, ndays - d0)
        mean_e, _, _, qdowns = sim.advance_interval(nd * 1440.0)
        parts = [qdowns[:, outlet_dev].reshape(-1)]
        if water:
            parts += [mean_e["eta"], mean_e["prcp"]]
        host = torch.cat(parts).cpu().numpy()
        n_q = qdowns.shape[0] * outlet.size
        if water:
            eta, prcp = host[n_q:].reshape(2, -1)
            aet_sum += float(eta @ area) * nd
            p_sum += float(prcp @ area) * nd
        qn = host[:n_q].reshape(qdowns.shape[0], outlet.size).sum(axis=1)
        qd[d0 : d0 + nd] = np.abs(qn).reshape(nd, wpd).mean(axis=1)
        d0 += nd
        aborted = bool(nfe_budget_per_day) and (
            sim.bdf.nfe > nfe_budget_per_day * d0)
    # m3/min window samples -> m3/day
    return DailyRun(qd * 1440.0, aet_sum, p_sum, float(area.sum()), d0,
                    aborted)


@dataclasses.dataclass
class Candidate:
    """One run of the objective."""
    x: np.ndarray  # the calibration values
    f: float  # the objective: -(NSE - penalty), or ABORT_PENALTY
    days: int  # simulated days (fewer when aborted)
    nfe: int
    setup_s: float  # FusedSimulation.create, first-use costs included
    run_s: float  # the simulated days, host transfers included
    device_bytes: int | None  # allocated on the card once it is dropped
    aborted: bool


class Objective:
    """-score of a calibration of the loaded project *inp* against the
    observed outlet discharge (*obs_t* [min], *obs_q* [m3/day]), under the
    flags of ``build_parser``: ``obj(z)`` runs the candidate of search
    vector z, ``obj.evaluate(x)`` the calibration values x; each prints
    its ``eval`` line and appends its ``Candidate`` to ``candidates``."""

    def __init__(self, args, inp, obs_t, obs_q):
        self.args = args
        self.inp = inp
        self.names = param_names(args.params)
        self.base_calib = inp.calib
        self.ndays = int(args.days)
        self.obs_daily = daily_obs(obs_t, obs_q, self.ndays)
        self.device = torch.device("cpu" if args.cpu else "cuda")
        self.float_dtype = torch.float32 if args.f32 else torch.float64
        # multiplicative scalars (conductivities etc. span orders of
        # magnitude) are searched in log10 space; additive keys (reference
        # naming `*+`, attribute naming `*_add`) stay linear
        self.log_mask = np.array([not (n.endswith("_add") or n.endswith("+"))
                                  for n in self.names])
        self.fr = None  # forcing/TSR tables reused across candidates
        self.best_seen = -np.inf
        self.candidates: list[Candidate] = []

    def decode(self, z) -> np.ndarray:
        x = np.asarray(z, dtype=float).copy()
        if self.args.log:
            x[self.log_mask] = 10.0 ** x[self.log_mask]
        return x

    def search_space(self):
        """(z0, lo, hi): the start (the base calibration's values, or
        ``--x0``) and box of the search, in the search space."""
        args, names = self.args, self.names
        x0 = np.array([getattr(self.base_calib, _CALIB_KEYS[n.lower()])
                       for n in names], dtype=float)
        if args.x0:
            x0 = np.array([float(s) for s in args.x0.split(",")],
                          dtype=float)
            if x0.shape[0] != len(names):
                raise UsageError(f"--x0 has {x0.shape[0]} values but "
                                 f"--params names {len(names)} keys")
            if not args.log and (np.any(x0 < 0.05) or np.any(x0 > 20.0)):
                print("warning: --x0 outside the linear search bounds "
                      "[0.05, 20]; values will be clipped by CMA-ES "
                      "(use --log for wide-range search)", flush=True)
        if args.log:
            z0 = x0.copy()
            z0[self.log_mask] = np.log10(np.maximum(x0[self.log_mask], 1e-6))
            # multiplicative: 10^[-b, b]; additive: linear [-5, 5]
            b = float(args.log_bound)
            lo = np.where(self.log_mask, -b, -5.0)
            hi = np.where(self.log_mask, b, 5.0)
        else:
            z0 = x0
            lo = np.full(len(names), 0.05)
            hi = np.full(len(names), 20.0)
        lower = [n.lower() for n in names]
        for spec in args.bound:
            key, rng = spec.split("=", 1)
            if key.strip().lower() not in lower:
                raise UsageError(f"--bound key {key!r} not in --params")
            i = lower.index(key.strip().lower())
            blo, bhi = (float(v) for v in rng.split(":"))
            lo[i], hi[i] = blo, bhi
            z0[i] = np.clip(z0[i], blo, bhi)
        return z0, lo, hi

    def __call__(self, z) -> float:
        return self.evaluate(self.decode(z))

    def evaluate(self, x) -> float:
        args = self.args
        t0 = time.perf_counter()
        sim = run_with_calib(
            args.project, args.base,
            calib_from_vector(self.names, x, base=self.base_calib),
            self.ndays, float_dtype=self.float_dtype, inp=self.inp,
            fr=self.fr, device=self.device)
        self.fr = sim.fr
        on_card = self.device.type == "cuda"
        if on_card:  # the set-up's uploads, on the host clock
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        run = run_daily(sim, self.ndays, int(args.chunk_days),
                        water=bool(args.wb_penalty),
                        nfe_budget_per_day=args.nfe_budget_per_day)
        t2 = time.perf_counter()
        nfe = int(sim.bdf.nfe)
        del sim  # before the next candidate is built
        n_eval = len(self.candidates) + 1
        head = f"    eval {n_eval}: " + " ".join(
            f"{n}={v:.3f}" for n, v in zip(self.names, x))
        if run.aborted:
            print(f"{head}  ABORT nfe={nfe} (> {args.nfe_budget_per_day}"
                  f"/day) at day {run.days}", flush=True)
            f = ABORT_PENALTY
        else:
            w0 = int(args.warmup)
            score = nse(run.q[w0:], self.obs_daily[w0:])
            wb_note = ""
            if args.wb_penalty:
                aet_mm = run.aet_sum / self.ndays * 1440e3 / run.area
                p_mm = run.p_sum / self.ndays * 1440e3 / run.area
                pen = args.wb_penalty * max(0.0, (aet_mm - p_mm)
                                            / max(p_mm, 1e-9))
                score -= pen
                wb_note = (f"  AET={aet_mm:.2f} P={p_mm:.2f} mm/d"
                           + (f" pen={pen:.3f}" if pen > 0 else ""))
            print(f"{head}  NSE={score:.4f}{wb_note}", flush=True)
            if args.best_file and score > self.best_seen:
                self.best_seen = score
                with open(args.best_file, "w") as fh:
                    fh.write(f"{score:.6f}," +
                             ",".join(f"{v:.6g}" for v in x) + "\n")
            f = -score
        self.candidates.append(Candidate(
            x=np.array(x, dtype=float), f=float(f), days=run.days, nfe=nfe,
            setup_s=t1 - t0, run_s=t2 - t1,
            device_bytes=(torch.cuda.memory_allocated(self.device)
                          if on_card else None),
            aborted=run.aborted))
        return f


def cost_summary(cands: list[Candidate]) -> str:
    """Set-up and run time of the first candidate (which pays the kernel
    build and first dispatch on the card) apart from the others'."""
    first, rest = cands[0], cands[1:]
    text = (f"first candidate: set-up {first.setup_s:.2f} s, {first.days} "
            f"days in {first.run_s:.2f} s, nfe {first.nfe}")
    if rest:
        days = sum(c.days for c in rest)
        text += (f"; the other {len(rest)}: set-up "
                 f"{np.mean([c.setup_s for c in rest]):.2f} s, "
                 f"{sum(c.run_s for c in rest) / days:.3f} s per simulated "
                 f"day, nfe {np.mean([c.nfe for c in rest]):.0f} (means)")
    return text


@dataclasses.dataclass
class Result:
    x: np.ndarray  # the best calibration values
    score: float  # their NSE, less the water-balance penalty
    candidates: list[Candidate]
    path: str  # the written .cfg.calib.opt


def calibrate(args, inp, obs_t, obs_q) -> Result:
    """The CMA-ES search of ``args`` (``build_parser``'s flags) on the
    loaded project *inp* against the observed outlet discharge; writes the
    best calibration to ``<output>/<prj>.cfg.calib.opt``."""
    obj = Objective(args, inp, obs_t, obs_q)
    z0, lo, hi = obj.search_space()
    t0 = time.time()
    z_best, f_best, _ = cma_es(
        obj, z0, sigma0=args.sigma0, bounds=(lo, hi),
        popsize=args.popsize, max_gen=args.gens, seed=1, verbose=True,
    )
    x_best = obj.decode(z_best)
    print(f"\nbest NSE {-f_best:.4f} after {len(obj.candidates)} runs "
          f"({time.time() - t0:.0f}s):")
    for n, v in zip(obj.names, x_best):
        print(f"  {n} = {v:.4f}")
    if obj.candidates:
        print(cost_summary(obj.candidates))
    gc = calib_from_vector(obj.names, x_best, base=obj.base_calib)
    outdir = args.output or os.path.join(
        os.getcwd(), "output", f"{args.project}.out")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, f"{args.project}.cfg.calib.opt")
    write_calib(gc, out)
    print(f"wrote {out}")
    return Result(x=x_best, score=-f_best, candidates=obj.candidates,
                  path=out)


def main(argv=None) -> Result:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        param_names(args.params)
        inp = load_project(args.project, base=args.base)
        obs_t, obs_q = read_obs(inp, args.project)
        return calibrate(args, inp, obs_t, obs_q)
    except UsageError as e:
        ap.error(str(e))


if __name__ == "__main__":
    main()
