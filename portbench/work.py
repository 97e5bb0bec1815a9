"""The yardstick of the roofline shares: the work of one evaluation of
the right-hand side and of one Jacobian-vector product, from the
generated mesh alone, and the card's peaks.

The work is the reference's (``reference/rhs.py``): every mesh field and
forcing field its right-hand side reads, each counted once at the run's
float width (indices too), plus the state read once and the derivative
written once; a J·v also reads the tangent once.  The operations are the
elementwise arithmetic the reference performs, counted per output element
while it evaluates once.  Nothing here reads the program, so the mega and
edge paths, and whatever later implements them, are held to one count.
"""

from __future__ import annotations

import importlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# published peaks (NVIDIA's data sheet, dense, at the full power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                              "float32_ops_per_s": 67e12},
}
# aten operations that move or select data without arithmetic
_NOT_ARITHMETIC = ("index", "gather", "cat", "stack", "copy", "clone",
                   "view", "expand", "reshape", "slice", "select", "to",
                   "zeros", "ones", "full", "empty", "_to_copy", "lift",
                   "detach", "alias", "t.", "transpose", "unsqueeze",
                   "squeeze", "permute", "new_", "scalar_tensor", "fill",
                   "split", "unbind", "as_strided")


class _Recorder:
    """Records the tensor fields read from an object (to any depth of
    named tuples)."""

    def __init__(self, obj, seen: dict, prefix: str = ""):
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_seen", seen)
        object.__setattr__(self, "_prefix", prefix)

    def __getattr__(self, name):
        v = getattr(self._obj, name)
        key = self._prefix + name
        if isinstance(v, torch.Tensor):
            self._seen[key] = v
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            return _Recorder(v, self._seen, key + ".")
        return v


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__ if hasattr(func, "__name__") else str(func)
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and not any(name.startswith(p) for p in _NOT_ARITHMETIC)):
            self.ops += out.numel()
        return out


def evaluation_work(raw: dict, float_bytes: int, reference=None) -> dict:
    """``{"rhs": (bytes, ops), "jv": (bytes, ops)}`` of one evaluation on
    the mesh of *raw* (``gen.make_raw``), at *float_bytes* an entry, as
    the package *reference* (the cell's reference, ``harness.hooks``; by
    default ``portbench.reference``) evaluates it: its modules
    ``project``, ``mesh``, ``forcing``, ``device``, ``init``,
    ``landsurface``, ``driver`` (``window_forcing``) and ``rhs``
    (``_rhs``)."""
    from portbench import gen

    pkg = "portbench.reference" if reference is None else reference.__name__

    def ref(name):
        return importlib.import_module(f"{pkg}.{name}")

    ls = ref("landsurface")
    inp = gen.to_input(raw, ref("project"), ".")
    md = ref("mesh").build_mesh(inp)
    fr = ref("forcing").build_forcing(inp, md)
    dm = ref("device").to_torch(md, torch.float64, "cpu")
    cal = ls.CalibScalars(*[v.double() for v in fr.cal])
    init = ref("init")
    ic, snow = init.initial_buckets(inp, md)
    fs, _ = ref("driver").window_forcing(
        dm, ls.BucketState(torch.as_tensor(ic), torch.as_tensor(snow)), fr,
        cal, (0, 0, 0), float(inp.control.solver_step), torch.float64, "cpu")
    y = torch.as_tensor(init.initial_state(inp, md))
    seen = {}
    counter = _CountOps()
    with torch.no_grad(), counter:
        ref("rhs")._rhs(_Recorder(dm, seen), _Recorder(fs, seen), y,
                        bool(inp.control.close_boundary))
    fields = sum(v.numel() for v in seen.values())
    n = y.numel()
    rhs_bytes = float_bytes * (fields + 2 * n)
    return {"rhs": (rhs_bytes, counter.ops),
            "jv": (rhs_bytes + float_bytes * n, 2 * counter.ops)}


def bound_seconds(n_bytes: float, n_ops: float, kind: str) -> tuple:
    """(the least time of the work on card *kind*, what bounds it:
    ``"bytes"`` or ``"operations"``)."""
    peak = PEAKS[kind]
    t_bytes = n_bytes / peak["bytes_per_s"]
    t_ops = n_ops / peak["float32_ops_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def roofline_pct(work: tuple, seconds: float, kind: str) -> "float | None":
    """The share of the roofline of *work* done in *seconds*; None for a
    card whose peaks the table lacks."""
    if kind not in PEAKS or not seconds > 0:
        return None
    return 100.0 * bound_seconds(*work, kind)[0] / seconds

