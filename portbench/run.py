#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload mega-32k-storm --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``,
``shud_tpu_torch/`` and ``portbench/``.  Set-up (the generated watershed,
the simulation, its interval graph and one warm interval) is followed by
the measured window: the cell's period replayed from the same start state
until ``--seconds`` have passed.  Then the reference runs the same input
and decides ``correct``.  The last line of stdout is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the profiled interval's device busy time and its
breakdown.  Exits nonzero, printing no result, without a CUDA card (or
with fewer than the cell needs), outside such a checkout, or when the
process holds a JAX module once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "shud_tpu_torch").is_dir():
        print("portbench: no shud_tpu_torch/ beside portbench/: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    # one process with few threads: the host's thread pools at one thread,
    # the process on the last two cores it may use
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    # every build and kernel cache at a fixed place inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        result = harness.run_cell(ROOT, spec, args.workload, args.seed,
                                  args.seconds, bool(args.trace), T_START)
    except harness.Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
