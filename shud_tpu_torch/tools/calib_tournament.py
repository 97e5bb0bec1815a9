"""Final calibration tournament: score candidate vectors at full length.

The counterpart of the JAX package's ``tools/calib_tournament.py``, with
its flags.  The CMA-ES searches (``autocalibrate``) run on a short window
for speed; this tool re-scores the short-window winners over the FULL
record (default 1827 days, warmup excluded) and prints NSE and the basin
water balance, so the published calibration is validated on the whole
period, not the search window.  Each candidate advances ``--chunk-days``
at a time, one host transfer a chunk.  Runs on the card unless ``--cpu``
is given; without a card it raises.

    python -m shud_tpu_torch.tools.calib_tournament ccw --days 1827 \\
        --warmup 60 --cand "label:x1,x2,..." --cand "label2:..." \\
        --params geol_ksath,...

Writes the winner to output/<prj>.out/<prj>.cfg.calib.opt.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from shud_tpu_torch.io.project import Calib, load_project, write_calib
from shud_tpu_torch.tools.autocalibrate import daily_obs, read_obs, run_daily
from shud_tpu_torch.utils.calibrate import calib_from_vector, nse, \
    run_with_calib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m shud_tpu_torch.tools.calib_tournament",
        description="score calibration candidates over the full record")
    ap.add_argument("project")
    ap.add_argument("-b", "--base", default=".")
    ap.add_argument("--days", type=float, default=1827.0)
    ap.add_argument("--warmup", type=float, default=60.0)
    ap.add_argument("--chunk-days", type=int, default=3)
    ap.add_argument("--params", required=True)
    ap.add_argument("--cand", action="append", required=True,
                    help='"label:x1,x2,..." (repeatable)')
    ap.add_argument("--f32", action="store_true", default=True)
    ap.add_argument("--f64", dest="f32", action="store_false")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return ap


@dataclasses.dataclass
class Entry:
    """One candidate's score over the record."""
    label: str
    x: np.ndarray
    calib: Calib
    nse: float  # over days [warmup, days)
    aet_mm: float  # basin means [mm/day]
    p_mm: float
    nfe: int
    wall_s: float  # the simulated days, host transfers included


def tournament(args, inp, obs_t, obs_q, outdir: str):
    """Score each ``--cand`` of ``args`` on the loaded project *inp*
    against the observed outlet discharge; writes the winner to
    ``<outdir>/<prj>.cfg.calib.opt``.  Returns (entries, best first; the
    written path)."""
    names = [s.strip() for s in args.params.split(",") if s.strip()]
    fd = torch.float32 if args.f32 else torch.float64
    device = torch.device("cpu" if args.cpu else "cuda")
    ndays = int(args.days)
    obs_daily = daily_obs(obs_t, obs_q, ndays)
    w0 = int(args.warmup)
    fr = None
    results = []
    for cand in args.cand:
        label, vec = cand.split(":", 1)
        x = np.array([float(s) for s in vec.split(",")])
        gc = calib_from_vector(names, x, base=inp.calib)
        sim = run_with_calib(args.project, args.base, gc, ndays,
                             float_dtype=fd, inp=inp, fr=fr, device=device)
        fr = sim.fr
        t0 = time.time()
        run = run_daily(sim, ndays, int(args.chunk_days), water=True)
        nfe = int(sim.bdf.nfe)
        del sim  # before the next candidate is built
        wall = time.time() - t0
        entry = Entry(label=label, x=x, calib=gc,
                      nse=nse(run.q[w0:], obs_daily[w0:]),
                      aet_mm=run.aet_sum / ndays * 1440e3 / run.area,
                      p_mm=run.p_sum / ndays * 1440e3 / run.area,
                      nfe=nfe, wall_s=wall)
        print(f"{label}: NSE={entry.nse:.4f} over days {w0}..{ndays} "
              f"AET={entry.aet_mm:.2f} P={entry.p_mm:.2f} mm/d "
              f"nfe={nfe} ({nfe/ndays:.0f}/day) wall={wall:.0f}s",
              flush=True)
        results.append(entry)

    results.sort(key=lambda r: -r.nse)
    win = results[0]
    print(f"\nwinner: {win.label} NSE={win.nse:.4f}")
    for n, v in zip(names, win.x):
        print(f"  {n} = {v:.4f}")
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, f"{args.project}.cfg.calib.opt")
    write_calib(win.calib, out)
    print(f"wrote {out}")
    return results, out


def main(argv=None):
    args = build_parser().parse_args(argv)
    inp = load_project(args.project, base=args.base)
    obs_t, obs_q = read_obs(inp, args.project)
    return tournament(args, inp, obs_t, obs_q, os.path.join(
        os.getcwd(), "output", f"{args.project}.out"))


if __name__ == "__main__":
    main()
