"""The reference run at a tenth of the configuration's tolerances:
``reference/driver.py``'s ``simulate`` on a copy of the input whose RELTOL
and ABSTOL are divided by ``TIGHTEN``.

On the card the result is kept under ``CACHE`` (the checkout's
``build/``), keyed by the SHA-256 of the input, the call's arguments,
torch's version and the sources of both reference packages, and read back
by a later call with the same key: every run of a cell solves the same
watershed, and at 2M cells the solve takes minutes.  A key that cannot be
made (an input that does not pickle) solves every time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from portbench.reference import driver as plain
from portbench.reference.driver import (  # noqa: F401
    GraphedRHS, window_forcing)

TIGHTEN = 10.0
HERE = Path(__file__).resolve().parent
CACHE = HERE.parents[1] / "build" / "reference-cache"


def tightened(inp):
    """A copy of *inp* with RELTOL and ABSTOL divided by ``TIGHTEN``."""
    cs = inp.control
    return dataclasses.replace(inp, control=dataclasses.replace(
        cs, reltol=cs.reltol / TIGHTEN, abstol=cs.abstol / TIGHTEN))


def key(inp, interval_min: float, round_inputs) -> str | None:
    """The cache key of one call, or None where *inp* does not pickle."""
    h = hashlib.sha256()
    try:
        h.update(pickle.dumps((inp, float(interval_min), str(round_inputs),
                               torch.__version__), protocol=4))
    except (pickle.PicklingError, TypeError, AttributeError):
        return None
    for pkg in (HERE.parent / "reference", HERE):
        for src in sorted(pkg.glob("*.py")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()


def _load(path: Path) -> list:
    with np.load(path) as z:
        t, y, q, sy = z["t"], z["y"], z["q"], z["sy"]
    return [{"t": float(t[i]), "y": y[i], "sy": sy, "q_riv_down": q[i]}
            for i in range(len(t))]


def _save(path: Path, out: list) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, t=np.array([o["t"] for o in out], np.float64),
             y=np.stack([o["y"] for o in out]),
             q=np.stack([o["q_riv_down"] for o in out]), sy=out[0]["sy"])
    os.replace(tmp, path)


def simulate(inp, interval_min: float, device, round_inputs=None) -> list:
    """``reference/driver.py``'s ``simulate`` of *inp* at a tenth of its
    tolerances: for each output interval the state ``y`` at its end, the
    cells' specific yield ``sy`` and the reaches' mean discharge
    ``q_riv_down``."""
    inp = tightened(inp)
    path = None
    if torch.device(device).type == "cuda":
        k = key(inp, interval_min, round_inputs)
        path = None if k is None else CACHE / f"{k}.npz"
    if path is not None and path.is_file():
        return _load(path)
    out = plain.simulate(inp, interval_min, device, round_inputs)
    if path is not None and out:
        _save(path, out)
    return out
