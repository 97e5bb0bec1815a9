"""Command-line entry: ``python -m shud_tpu_torch [options] <project>``.

The counterpart of ``shud_tpu/cli.py``, with its flags under the same
names, so that a command line of the JAX package runs unchanged or fails
loudly: every flag is honoured or refused with a message, none is
accepted and then ignored (``-n`` is accepted for parity with the
reference's CLI, as the JAX package accepts it).  Mirrors the reference
CLI (``src/classes/CommandIn.cpp:188-278``): ``./shud <prj>`` reads
``input/<prj>/<prj>.*`` and writes ``output/<prj>.out/``.  Runs on the
card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse

# flags of the JAX CLI the port refuses, with the reason
REFUSED = {
    "shards": "--shards (domain decomposition over devices) is not ported "
              "yet (ROADMAP.md, queue: multi-GPU)",
    "distributed": "--distributed (multi-host runs) is not ported yet "
                   "(ROADMAP.md, queue: multi-GPU)",
    "compile_cache": "--compile-cache: the XLA compilation cache is a TPU "
                     "workaround the port does not carry (ROADMAP.md: TPU "
                     "workarounds are not ported); the CUDA kernels are "
                     "cached under build/",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shud_tpu_torch",
        description="SHUD-class watershed hydrology model on PyTorch/CUDA",
    )
    p.add_argument("project", nargs="?", default=None,
                   help="project name (input/<prj>/<prj>.*)")
    p.add_argument("-0", "--dummy", action="store_true", dest="dummy",
                   help="dummy run: IO pipeline only, no solving")
    p.add_argument("-g", "--split", action="store_true",
                   help="operator-split mode (float64; the five "
                        "sub-solvers of driver/uncoupled.py)")
    p.add_argument("-c", "--calib", default=None,
                   help="calibration file (.cfg.calib)")
    p.add_argument("-o", "--output", default=None, help="output folder")
    p.add_argument("-b", "--base", default=".", help="base directory")
    p.add_argument("-e", "--end-day", type=float, default=None,
                   help="override END day")
    p.add_argument("-p", "--project-file", default=None, metavar="SHUD",
                   help="load paths from a <prj>.SHUD project manifest "
                        "(FileIn::readProject)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose screen output (overrides -q)")
    p.add_argument("-f", "--fflush", action="store_true",
                   help="flush every output record to disk as written")
    p.add_argument("-n", "--num-workers", type=int, default=None,
                   metavar="N",
                   help="reference -n (OpenMP threads / CMA-ES lambda); "
                        "accepted for CLI parity: the port runs on one "
                        "device")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--per-window", action="store_true",
                   help="use the per-window driver instead of the fused "
                        "driver")
    p.add_argument("--f32", action="store_true",
                   help="float32 (the card's fast path)")
    p.add_argument("--pallas", dest="pallas", action="store_true",
                   default=None,
                   help="force the CUDA edge-flux kernels (float32 on the "
                        "card)")
    p.add_argument("--no-pallas", dest="pallas", action="store_false",
                   help="the edge fluxes' plain PyTorch versions")
    p.add_argument("--mega", dest="mega", action="store_true", default=None,
                   help="force the whole-RHS megakernel path (float32, at "
                        "most 32,768 cells)")
    p.add_argument("--no-mega", dest="mega", action="store_false",
                   help="disable the whole-RHS megakernel path")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a full binary checkpoint (.ckpt.npz)")
    p.add_argument("--shards", type=int, default=None, metavar="P",
                   help="multi-device run (not ported: refused)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="the JAX package's XLA cache (refused)")
    p.add_argument("--cmaes-dir", default=None, metavar="DIR",
                   help="external-calibration exchange directory (the "
                        "reference's -e dir_cmaes hook, CommandIn.cpp:"
                        "210-212): read DIR/calib_varnames.txt + "
                        "DIR/calib_x.txt (globalCal::copy vector, "
                        "ModelConfigure.cpp:368-375), run, then write "
                        "DIR/objective.txt (-NSE of daily outlet "
                        "discharge vs tsd.obs) and the applied "
                        "DIR/cfg.calib.out for the external driver")
    p.add_argument("--distributed", nargs="?", const="", default=None,
                   metavar="COORD:PORT,NPROC,RANK",
                   help="multi-host run (not ported: refused)")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    for name, why in REFUSED.items():
        if getattr(args, name) not in (None, False):
            p.error(why)

    import contextlib

    import torch

    device = "cpu" if args.cpu else "cuda"
    float_dtype = torch.float32 if args.f32 else torch.float64
    if args.quiet and args.verbose:
        args.quiet = False
    if args.fflush:
        from shud_tpu_torch.io import output as _out

        _out.FFLUSH_MODE = True
    if args.num_workers is not None and not args.quiet:
        print(f"-n {args.num_workers}: accepted for CLI parity; the port "
              "runs on one device")

    inp = None
    if args.project_file:
        from shud_tpu_torch.io.project import load_project, read_project_file

        paths = read_project_file(args.project_file)
        inp = load_project(paths.project, paths=paths)
        args.project = paths.project
        if args.output is None:
            args.output = paths.outpath
    elif args.project is None:
        p.error("a project name (or -p <file>.SHUD) is required")

    calib = None
    if args.calib:
        from shud_tpu_torch.io.project import read_calib

        calib = read_calib(args.calib)
    if args.cmaes_dir:
        calib = _apply_cmaes_dir(args.cmaes_dir, calib)

    per_window = args.per_window or args.dummy
    if inp is not None and (per_window or args.split):
        p.error("-p is supported with the default (fused) driver only")
    if args.split:
        # flags the JAX package's -g route drops without a word
        dropped = [flag for flag, on in (
            ("--f32", args.f32), ("--mega/--no-mega", args.mega is not None),
            ("--pallas/--no-pallas", args.pallas is not None),
            ("--resume", args.resume), ("-0", args.dummy),
            ("--per-window", args.per_window)) if on]
        if dropped:
            p.error(f"{', '.join(dropped)}: not supported with -g (the "
                    "operator-split driver runs in float64 with its own "
                    "sub-solvers, as the JAX package's does)")
    if per_window and (args.mega is not None or args.resume):
        p.error("--mega/--no-mega and --resume belong to the fused driver; "
                "drop them with --per-window or -0")

    edge_kernel = "auto" if args.pallas is None else args.pallas
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

    from shud_tpu_torch.utils.errors import ShudError

    try:
        with prof:
            if args.split:
                from shud_tpu_torch.driver.uncoupled import run_project_split

                run_project_split(
                    args.project, base=args.base, end_day=args.end_day,
                    verbose=not args.quiet, outpath=args.output,
                    calib=calib, device=device,
                )
            elif per_window:
                from shud_tpu_torch.driver.run import run_project

                run_project(
                    args.project, base=args.base, end_day=args.end_day,
                    verbose=not args.quiet, dummy=args.dummy,
                    outpath=args.output, calib=calib, device=device,
                    float_dtype=float_dtype, edge_kernel=edge_kernel,
                )
            else:
                from shud_tpu_torch.driver.run_fast import run_project_fast

                run_project_fast(
                    args.project, base=args.base, end_day=args.end_day,
                    verbose=not args.quiet, float_dtype=float_dtype,
                    outpath=args.output, calib=calib, resume=args.resume,
                    inp=inp, device=device, edge_kernel=edge_kernel,
                    mega="auto" if args.mega is None else args.mega,
                )
    except ShudError as e:  # reference myexit: typed exit codes
        print(f"FATAL: {e}", flush=True)
        raise SystemExit(e.code)
    if args.profile:
        import os

        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        if not args.quiet:
            print(f"profile: {trace}")
    if args.cmaes_dir:
        _write_cmaes_objective(args.cmaes_dir, args.project, args.base,
                               args.output, calib, quiet=args.quiet)


def _apply_cmaes_dir(dir_cmaes: str, base_calib):
    """Read the external driver's candidate vector
    (DIR/calib_varnames.txt: one calibration key per line;
    DIR/calib_x.txt: whitespace/newline-separated values) and apply it via
    the globalCal::copy semantics (ModelConfigure.cpp:368-375: nx >= nv,
    pairwise push)."""
    import os

    import numpy as np

    from shud_tpu_torch.utils.calibrate import calib_from_vector

    vn_path = os.path.join(dir_cmaes, "calib_varnames.txt")
    x_path = os.path.join(dir_cmaes, "calib_x.txt")
    if not (os.path.exists(vn_path) and os.path.exists(x_path)):
        return base_calib
    with open(vn_path) as fh:
        names = [ln.strip() for ln in fh if ln.strip()
                 and not ln.startswith("#")]
    x = np.loadtxt(x_path).ravel()
    if len(x) < len(names):  # ERRCONSIS in the reference
        raise SystemExit(
            f"--cmaes-dir: {len(names)} varnames but only {len(x)} values")
    return calib_from_vector(names, x[: len(names)], base=base_calib)


def _write_cmaes_objective(dir_cmaes: str, project: str, base: str,
                           outpath, calib, quiet=False):
    """Post-run: objective (-NSE of daily outlet discharge vs tsd.obs) and
    the applied calibration, for the external CMA-ES driver to collect."""
    import os

    from shud_tpu_torch.analysis import Run
    from shud_tpu_torch.io.project import write_calib

    inpath = os.path.join(base, "input", project)
    out = outpath or os.path.join(base, "output", f"{project}.out")
    run = Run(project, inpath=inpath, outpath=out)
    obj = float("nan")
    try:
        obj = -float(run.nse())  # aligned daily outlet-vs-gauge NSE
    except (OSError, KeyError, IndexError, ValueError) as e:
        if not quiet:
            print(f"--cmaes-dir: objective unavailable ({e})")
    os.makedirs(dir_cmaes, exist_ok=True)
    with open(os.path.join(dir_cmaes, "objective.txt"), "w") as fh:
        fh.write(f"{obj:.10e}\n")
    if calib is not None:
        write_calib(calib, os.path.join(dir_cmaes, "cfg.calib.out"))
    if not quiet:
        print(f"--cmaes-dir: objective {obj:.6f} -> "
              f"{os.path.join(dir_cmaes, 'objective.txt')}")


if __name__ == "__main__":
    main()
