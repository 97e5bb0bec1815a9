"""A solver window replayed from the card: the JAX solver's on-device loop.

The JAX solver integrates a whole window inside one ``lax.while_loop``
with its Newton loop inside another (``shud_tpu/solver/bdf.py:201,389``),
so no host takes part until the window ends.  ``WindowGraph`` does the
same on the card with a CUDA graph:

* the step body of ``solver/bdf.py`` runs over static buffers (the carry,
  the window's forcing, ``tout``) in five pieces: ``head`` (is the window
  still active?), ``begin`` (predictor, coefficients, the first Newton
  iteration), ``newton`` (one more iteration), ``end`` (error test,
  controller, then ``head`` again) and ``tail`` (the scalars packed for
  the host).  Each piece writes what it computes back into buffers that
  exist before it runs (``copy_``), so it can be replayed on the same
  memory;
* each piece is captured once with ``torch.cuda.graph`` after a warm-up
  that runs them eagerly (the kernels' library, their launch state and the
  custom ops' first dispatch);
* ``csrc/graph.cu`` assembles the window from copies of the pieces: head,
  then S steps each inside an IF conditional node on ``active``, Newton
  iterations 2..``newton_iters`` inside nested IF nodes on "the last
  update was above ``newton_tol``", then tail.  PyTorch 2.11 has no API
  for a conditional node in a capture, so the nodes are added with the
  CUDA runtime's graph API around the captured pieces;
* per window: the forcing and ``tout`` are copied into the buffers, the
  graph is launched, and the host reads ``active`` with the scalars in
  one transfer; while the window is still active (more than S steps), it
  launches again.

A WHILE conditional node (``lax.while_loop`` itself, no S and no second
launch) is a follow-up.  On the CPU (``capture=False``) the same pieces
run eagerly, each IF decided by reading its predicate: the replay logic
the tests check where there is no card.
"""

from __future__ import annotations

import ctypes
import time

import torch
from torch.utils import _pytree as pytree

from shud_tpu_torch.core.cuda_build import load_library
from shud_tpu_torch.solver import bdf
from shud_tpu_torch.solver.bdf import (
    COUNTS, STEPS, BDFState, Carry, SolverConfig, active, from_carry,
    functions, newton_iter, scalars, step_begin, step_end, to_carry)

# steps a launch holds: above the 4.3-4.8 steps a storm window takes at
# 32,768 and 131,072 cells (PERF.md section 5), so most windows end in one
N_STEPS = 8
# Newton iterations the warm-ups ran (two a graph: begin's and newton's),
# beside bdf.newton_iters, which counts the solves' own: a kernel's launches
# are the sum's
warmup_newton_iters = 0


def _copy(dst, src) -> None:
    """Each tensor of *src* into its counterpart of *dst* (same pytree)."""
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(s)


def _clone(tree):
    """The tensors of *tree* copied; its other leaves shared."""
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class _Program:
    """The window's pieces over static buffers (the carry *c*, ``tout``,
    the step count at the window's start, ``active``, the packed scalars);
    the parameters the RHS reads are static too (``WindowGraph.params``)."""

    def __init__(self, rhs, lin, cfg: SolverConfig, quad_fn, params,
                 c: Carry):
        self.rhs, self.lin, self.cfg = rhs, lin, cfg
        self.quad_fn, self.params, self.c = quad_fn, params, c
        dev = c.y.device
        self.tout = torch.zeros((), dtype=c.t.dtype, device=dev)
        self.nsteps0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.packed = torch.zeros(len(STEPS) + len(COUNTS) + 1,
                                  dtype=torch.float64, device=dev)
        self.plan = self.nw = None  # made by begin(), kept by a capture

    def head(self):
        self.active.copy_(active(self.c, self.tout, self.nsteps0, self.cfg))

    def begin(self):
        self.plan, self.nw = step_begin(self.rhs, self.lin, self.c,
                                        self.tout, self.cfg)

    def newton(self):
        _copy(self.nw, newton_iter(self.lin, self.plan, self.nw.y,
                                   self.nw.it, self.cfg))

    def end(self):
        _copy(self.c, step_end(self.c, self.plan, self.nw, self.cfg,
                               self.quad_fn, self.params))
        self.head()

    def tail(self):
        self.packed.copy_(torch.cat([scalars(self.c),
                                     self.active.double()[None]]))


_SIDE = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up stream a device: every new stream would get a cuBLAS
    workspace of its own, kept until the process ends."""
    if device.index not in _SIDE:
        _SIDE[device.index] = torch.cuda.Stream(device)
    return _SIDE[device.index]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"the solver window's graph: {what} failed "
                           f"(CUDA error {err})")


class WindowGraph:
    """``solve_to`` for the windows of one simulation, replayed from a
    CUDA graph on the card.

    ``f(t, y, params)``, ``linearize(t, y, params)`` and ``quad_fn(t, y,
    params)`` are ``solve_to``'s; *params* is a pytree of tensors (the
    window's forcing) whose shapes every window keeps: the first window's
    are cloned into static buffers that every later one is copied into.
    *capture*: build and replay the graph (the default on CUDA tensors);
    False runs the same pieces eagerly, each IF decided by reading its
    predicate.  A capture or an instantiation that fails raises: nothing
    falls back to the eager loop.

    A returned ``BDFState`` holds copies of the buffers, never the buffers
    the next window overwrites; handed back unchanged (``state is`` the
    last one returned), it is not uploaded again.

    ``stats``: steps and launches of each window, host syncs, and the
    warm-up, capture and instantiation seconds."""

    def __init__(self, f, linearize, cfg: SolverConfig, quad_fn=None,
                 n_steps: int = N_STEPS, capture: "bool | None" = None):
        self.f, self.linearize, self.cfg = f, linearize, cfg
        self.quad_fn, self.n_steps, self.capture = quad_fn, n_steps, capture
        self.params = self.prog = None
        self._segments = []
        self._graph = self._exec = None
        self._last = None
        self.stats = {"steps": [], "launches": [], "syncs": 0,
                      "warmup_s": None, "warmup_newton_iters": 0,
                      "capture_s": None, "instantiate_s": None}

    def solve(self, state: BDFState, tout, params) -> BDFState:
        """Advance *state* to *tout* under the window's *params*."""
        if self.prog is None:
            self._setup(state, params)
        _copy(self.params, params)
        if self.capture and self._exec is None:
            self._build()
        p = self.prog
        if state is not self._last:
            _copy(p.c, to_carry(state))
        p.tout.fill_(float(tout))
        p.nsteps0.copy_(p.c.nsteps)
        p.c.nni.zero_()
        launches = 0
        while True:
            self._launch()
            launches += 1
            host = p.packed.cpu().numpy()
            bdf.host_syncs += 1
            self.stats["syncs"] += 1
            if not host[-1]:
                break
        c = p.c
        out = from_carry(
            c._replace(y=c.y.clone(), y_prev=c.y_prev.clone(),
                       y_prev2=c.y_prev2.clone(), quad=_clone(c.quad)),
            host[:-1], state.quad is not None)
        bdf.newton_iters += int(host[len(STEPS) + COUNTS.index("nni")])
        self.stats["steps"].append(out.nsteps - state.nsteps)
        self.stats["launches"].append(launches)
        self._last = out
        return out

    # -- set-up ------------------------------------------------------------

    def _setup(self, state: BDFState, params) -> None:
        if self.capture is None:
            self.capture = state.y.is_cuda
        self.params = _clone(params)
        rhs, lin = functions(self.f, self.params, self.linearize)
        self.prog = _Program(rhs, lin, self.cfg, self.quad_fn, self.params,
                             _clone(to_carry(state)))

    def _pieces(self):
        p = self.prog
        return {"head": p.head, "begin": p.begin, "newton": p.newton,
                "end": p.end, "tail": p.tail}

    def _build(self) -> None:
        """Warm up, capture each piece, assemble and instantiate."""
        global warmup_newton_iters
        pieces = self._pieces()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        side = _side_stream(self.prog.c.y.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in pieces.values():
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self._last = None  # the warm-up moved the carry
        self.stats["warmup_newton_iters"] = 2
        warmup_newton_iters += 2
        t1 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        segs = {}
        for name, fn in pieces.items():
            g = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(g, pool=pool):
                    fn()
            except Exception as exc:
                raise RuntimeError(f"capturing the solver window's {name} "
                                   f"piece failed: {exc}") from exc
            segs[name] = g
        self._segments = list(segs.values())  # keep the pool's memory
        t2 = time.perf_counter()
        self._assemble(segs)
        torch.cuda.synchronize()
        self.stats.update(warmup_s=t1 - t0, capture_s=t2 - t1,
                          instantiate_s=time.perf_counter() - t2)

    def _assemble(self, segs: dict) -> None:
        lib = load_library()
        vp = ctypes.c_void_p

        def child(graph, dep, name):
            node = vp()
            _check(lib.shud_graph_add_child(
                graph, dep, vp(segs[name].raw_cuda_graph()),
                ctypes.byref(node)), f"adding the {name} piece")
            return node

        def if_node(graph, dep, pred, what):
            body, node = vp(), vp()
            _check(lib.shud_graph_add_if(graph, dep, vp(pred.data_ptr()),
                                         ctypes.byref(body),
                                         ctypes.byref(node)),
                   f"adding the IF node of {what}")
            return body, node

        def newton_chain(graph, dep, depth):
            # iterations 2..newton_iters, each inside the IF of the last
            if depth == 0:
                return dep
            body, node = if_node(graph, dep, self.prog.nw.more,
                                 "a Newton iteration")
            newton_chain(body, child(body, None, "newton"), depth - 1)
            return node

        graph = vp()
        _check(lib.shud_graph_create(ctypes.byref(graph)), "creating it")
        self._graph = graph
        node = child(graph, None, "head")
        for _ in range(self.n_steps):
            body, node = if_node(graph, node, self.prog.active, "a step")
            n = child(body, None, "begin")
            child(body, newton_chain(body, n, self.cfg.newton_iters - 1),
                  "end")
        child(graph, node, "tail")
        exe = vp()
        _check(lib.shud_graph_instantiate(graph, ctypes.byref(exe)),
               "instantiating it")
        self._exec = exe

    # -- per window ----------------------------------------------------------

    def _launch(self) -> None:
        if self.capture:
            stream = torch.cuda.current_stream(self.prog.c.y.device)
            _check(load_library().shud_graph_launch(
                self._exec, ctypes.c_void_p(stream.cuda_stream)),
                "launching it")
            return
        # the same pieces eagerly: each IF decided on the host
        p = self.prog
        p.head()
        for _ in range(self.n_steps):
            if not bool(p.active):
                break
            p.begin()
            for _ in range(1, self.cfg.newton_iters):
                if not bool(p.nw.more):
                    break
                p.newton()
            p.end()
        p.tail()

    def close(self) -> None:
        """Free the graph (also when the object is dropped)."""
        if self._exec is not None or self._graph is not None:
            lib = load_library()
            if self._exec is not None:
                lib.shud_graph_exec_destroy(self._exec)
            if self._graph is not None:
                lib.shud_graph_destroy(self._graph)
        self._exec = self._graph = None
        self._segments = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to free
            pass
