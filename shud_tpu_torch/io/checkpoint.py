"""Full-state binary checkpoint / resume.

The counterpart of ``shud_tpu/io/checkpoint.py``, with the same ``.npz``
layout: one array per state leaf, keyed by its path (``bdf/y``,
``bdf/quad/et``, ``buckets/snow``, ``cryo/surf/ring``, ...; the
operator-split driver's five solvers under ``bdf/surf/y``, ...), plus
``__t__``.  A checkpoint
written by either package loads into the other, and a resumed run
continues the saved trajectory bit for bit (solver history, step size,
order, counters and quadrature accumulators included).
"""

from __future__ import annotations

import numpy as np
import torch

from shud_tpu_torch.core.cryo import AccTempState, CryoState
from shud_tpu_torch.core.landsurface import BucketState
from shud_tpu_torch.core.mega import unblock_tpu_state
from shud_tpu_torch.solver.bdf import BDFState, np_dtype

_INT_FIELDS = ("order", "nfe", "nsteps", "nfails", "nnifails", "size",
               "head", "n_day")


def _solver_states(sim) -> dict:
    """Key prefix -> ``BDFState``: ``bdf`` for one solver; ``bdf/<part>``
    for each solver of the operator-split driver, whose shim holds a dict
    of them (``None`` for an absent lake)."""
    if isinstance(sim.bdf, dict):
        return {f"bdf/{part}": st for part, st in sim.bdf.items()
                if st is not None}
    return {"bdf": sim.bdf}


def _np_dtype(sim):
    """The numpy scalar type of the solver state."""
    return np_dtype(next(iter(_solver_states(sim).values())).y.dtype)


def _leaves(sim) -> dict:
    """Path -> value of every state leaf (tensors, host scalars)."""
    out = {}
    for prefix, st in _solver_states(sim).items():
        for name, v in st._asdict().items():
            if v is None:
                continue
            if name == "quad":
                for k, q in v.items():
                    out[f"{prefix}/quad/{k}"] = q
            else:
                out[f"{prefix}/{name}"] = v
    for name, v in sim.buckets._asdict().items():
        out[f"buckets/{name}"] = v
    if sim.cryo is not None:
        for part, acc in sim.cryo._asdict().items():
            for name, v in acc._asdict().items():
                out[f"cryo/{part}/{name}"] = v
    return out


def save_checkpoint(path: str, sim) -> None:
    """Write the complete simulation state to *path* (``.npz``)."""
    payload = {"__t__": np.asarray(float(sim.t))}
    for key, v in _leaves(sim).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        # the counters as int32, as the JAX package writes them (the
        # solver's are host ints, the cryosphere's 0-d int64 tensors)
        if key.rsplit("/", 1)[-1] in _INT_FIELDS:
            payload[key] = np.asarray(v, dtype=np.int32)
        else:
            payload[key] = np.asarray(v)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_checkpoint(path: str, sim) -> None:
    """Restore state saved by :func:`save_checkpoint` (of either package)
    into *sim*, created for the same project and configuration, whose
    state is the template for dtypes, shapes and devices.

    A JAX run on the TPU megakernel path saves its solver states in the
    kernel's blocked ``[rows, 128]`` layout; those are unblocked into the
    port's flat state.  Any other shape mismatch raises."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    dt = _np_dtype(sim)
    new = {}
    for key, leaf in _leaves(sim).items():
        if key not in data:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        v = data[key]
        if isinstance(leaf, torch.Tensor) and v.shape != tuple(leaf.shape):
            md = getattr(sim, "md", None)  # the split shim has none
            flat = None if md is None else unblock_tpu_state(
                v, md.num_ele, md.num_riv, md.num_lake)
            if flat is None or flat.shape != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {path}: {key} has shape {v.shape}, the "
                    f"simulation's is {tuple(leaf.shape)}")
            v = flat
        if isinstance(leaf, torch.Tensor):
            new[key] = torch.as_tensor(v).to(dtype=leaf.dtype,
                                             device=leaf.device)
        elif isinstance(leaf, int):
            new[key] = int(v)
        else:
            new[key] = dt(v)
    states = {}
    for prefix, st in _solver_states(sim).items():
        bdf = {name: new.get(f"{prefix}/{name}")
               for name in BDFState._fields}
        if st.quad is not None:
            bdf["quad"] = {k: new[f"{prefix}/quad/{k}"] for k in st.quad}
        states[prefix] = BDFState(**bdf)
    if isinstance(sim.bdf, dict):
        sim.bdf = {part: states.get(f"bdf/{part}") for part in sim.bdf}
    else:
        sim.bdf = states["bdf"]
    sim.buckets = BucketState(
        **{name: new[f"buckets/{name}"] for name in BucketState._fields})
    if sim.cryo is not None:
        sim.cryo = CryoState(**{
            part: AccTempState(**{name: new[f"cryo/{part}/{name}"]
                                  for name in AccTempState._fields})
            for part in CryoState._fields})
    sim.t = float(data["__t__"])
