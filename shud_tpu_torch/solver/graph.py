"""Programs replayed from the card: the JAX drivers' on-device loops.

JAX runs an output interval of the fused driver as one jit: a
``lax.scan`` over the interval's windows (``shud_tpu/driver/fused.py``),
each window's solve a ``lax.while_loop`` over steps with its Newton loop
inside another (``shud_tpu/solver/bdf.py:201,389``), so that the host
takes part only at the interval's boundaries.  This module does the same
on the card with CUDA graphs:

* a ``Program`` is pieces (functions over static buffers, each writing
  what it computes back into buffers that exist before it runs, ``copy_``,
  so that it can be replayed on the same memory) under ``While`` and
  ``If`` nodes, each deciding on a 0-d bool buffer that a piece writes;
* ``Program.build`` runs each piece once eagerly (the warm-up: the
  kernels' library, their launch state, the custom ops' first dispatch,
  the cached constants, every allocation made outside a capture), captures
  each once with ``torch.cuda.graph`` into one pool, and ``csrc/graph.cu``
  assembles the program from copies of the captured pieces with the CUDA
  runtime's WHILE and IF conditional nodes (torch 2.11 has no API for a
  conditional node in a capture); one launch then runs the whole program,
  with no host in its loops;
* on the CPU (``capture=False``) the same pieces run eagerly, each node
  decided by reading its predicate: the replay logic the tests check where
  there is no card;
* a ``Stamp`` node reads the device's clock between two pieces and adds
  the time since the program's previous stamp into a sum on the device
  (``IntervalGraph.phases``: a window's head, solve and tail).

``WindowGraph`` is the solver's window (``solve_to`` on the device):
``head``, WHILE(active) {``begin``, Newton iterations 2..``newton_iters``
under nested IFs on "the last update was above ``newton_tol``", ``end``},
``tail``; one launch and one host read a window.  ``driver/fused.py``'s
``IntervalGraph`` runs the same solve inside a WHILE over an interval's
windows.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from shud_tpu_torch import trace
from shud_tpu_torch.core.cuda_build import load_library
from shud_tpu_torch.solver import bdf, kernels
from shud_tpu_torch.solver.bdf import (
    COUNTS, STEPS, BDFState, Carry, SolverConfig, active, from_carry,
    functions, newton_iter, scalars, step_begin, step_end, to_carry)

# what the warm-ups of solver programs ran, beside bdf.newton_iters, which
# counts the solves' own: a kernel's device count is the sum.  A warm-up
# runs two Newton iterations (begin's and newton's), and an interval's
# also one window tail (its diagnostics)
warmup_newton_iters = 0
warmup_windows = 0


def copy_into(dst, src) -> None:
    """Each tensor of *src* into its counterpart of *dst* (same pytree);
    a tensor that is its own counterpart (the kernel route's in-place
    pieces) is left alone."""
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src)):
        if isinstance(d, torch.Tensor) and d is not s:
            d.copy_(s)


def clone(tree):
    """The tensors of *tree* copied; its other leaves shared."""
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class While(NamedTuple):
    """``while pred(): body``.  *pred* returns the 0-d bool buffer that
    decides (read when the program is assembled, or at each test on the
    CPU); the body's pieces must write it."""

    pred: Callable[[], torch.Tensor]
    body: tuple


class If(NamedTuple):
    """``if pred(): body``."""

    pred: Callable[[], torch.Tensor]
    body: tuple


class Stamp(NamedTuple):
    """A reading of the device's clock (``%globaltimer``, nanoseconds; the
    host's ``perf_counter_ns`` on the CPU): the time since the program's
    previous stamp is added into entry *slot* of the program's stamp
    buffer, whose last entry keeps the reading for the next stamp."""

    slot: int


_SIDE = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up stream a device: every new stream would get a cuBLAS
    workspace of its own, kept until the process ends."""
    if device.index not in _SIDE:
        _SIDE[device.index] = torch.cuda.Stream(device)
    return _SIDE[device.index]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"the program's graph: {what} failed "
                           f"(CUDA error {err})")


class Program:
    """*pieces* (name -> function; warmed up and captured in this order)
    run as *nodes*, a tuple of piece names, ``While`` and ``If`` nodes.
    *capture*: ``build`` makes one CUDA graph of it and ``launch`` replays
    it; False: ``launch`` runs the pieces eagerly, each node decided on
    the host.  A capture, an assembly, an instantiation or a launch that
    fails raises: nothing falls back to the eager form.  *stamps*: the
    int64 buffer of the ``Stamp`` nodes' sums (one more entry than slots,
    the last the previous reading), on the program's device.

    ``stats``: graph launches, and the warm-up, capture and instantiation
    seconds of ``build``."""

    def __init__(self, pieces: dict, nodes: tuple, capture: bool,
                 stamps: "torch.Tensor | None" = None):
        self.pieces, self.nodes, self.capture = pieces, nodes, capture
        self.stamps = stamps
        self._segments = {}
        self._graph = self._exec = None
        self.stats = {"launches": 0, "warmup_s": None, "capture_s": None,
                      "instantiate_s": None}

    @property
    def built(self) -> bool:
        return self._exec is not None

    @trace.spanned("shud.graph.build", always=True)
    def build(self, device: torch.device) -> None:
        """Warm up, capture each piece, assemble and instantiate.  The
        warm-up runs every piece once, so it moves whatever state they
        advance: the caller uploads its state after."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for fn in self.pieces.values():
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        pool = torch.cuda.graph_pool_handle()
        for name, fn in self.pieces.items():
            g = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(g, pool=pool):
                    fn()
            except Exception as exc:
                raise RuntimeError(f"capturing the {name} piece failed: "
                                   f"{exc}") from exc
            self._segments[name] = g  # kept: they hold the pool's memory
        t2 = time.perf_counter_ns()
        self._assemble()
        torch.cuda.synchronize(device)
        t3 = time.perf_counter_ns()
        for name, a, z in (("warmup", t0, t1), ("capture", t1, t2),
                           ("instantiate", t2, t3)):
            trace.record(f"shud.graph.{name}", a, z)
        self.stats.update(warmup_s=(t1 - t0) / 1e9, capture_s=(t2 - t1) / 1e9,
                          instantiate_s=(t3 - t2) / 1e9)

    def _assemble(self) -> None:
        lib = load_library()
        vp = ctypes.c_void_p

        def add(graph, dep, nodes):
            """*nodes* in *graph* after *dep*; returns the last node."""
            for n in nodes:
                node = vp()
                if isinstance(n, str):
                    _check(lib.shud_graph_add_child(
                        graph, dep, vp(self._segments[n].raw_cuda_graph()),
                        ctypes.byref(node)), f"adding the {n} piece")
                elif isinstance(n, Stamp):
                    buf = self.stamps
                    _check(lib.shud_graph_add_stamp(
                        graph, dep, vp(buf.data_ptr()), n.slot,
                        buf.numel() - 1, ctypes.byref(node)),
                        "adding a stamp")
                elif isinstance(n, While):
                    pred, body = vp(n.pred().data_ptr()), vp()
                    handle = ctypes.c_ulonglong()
                    _check(lib.shud_graph_add_while(
                        graph, dep, pred, ctypes.byref(body),
                        ctypes.byref(node), ctypes.byref(handle)),
                        "adding a WHILE node")
                    last = add(body, None, n.body)
                    _check(lib.shud_graph_add_condition(
                        body, last, handle, pred, ctypes.byref(vp())),
                        "closing a WHILE body")
                else:
                    pred, body = vp(n.pred().data_ptr()), vp()
                    _check(lib.shud_graph_add_if(
                        graph, dep, pred, ctypes.byref(body),
                        ctypes.byref(node)), "adding an IF node")
                    add(body, None, n.body)
                dep = node
            return dep

        graph = vp()
        _check(lib.shud_graph_create(ctypes.byref(graph)), "creating it")
        self._graph = graph
        add(graph, None, self.nodes)
        exe = vp()
        _check(lib.shud_graph_instantiate(graph, ctypes.byref(exe)),
               "instantiating it")
        self._exec = exe

    def node_counts(self) -> dict:
        """Each captured piece's nodes by type (``kernel``, ``copy``,
        ``memset``, ``other``): what one replay of the piece runs on the
        device."""
        lib, out = load_library(), {}
        for name, g in self._segments.items():
            n = (ctypes.c_ulonglong * 4)()
            _check(lib.shud_graph_node_types(
                ctypes.c_void_p(g.raw_cuda_graph()), n),
                f"counting the {name} piece's nodes")
            out[name] = dict(zip(("kernel", "copy", "memset", "other"), n))
        return out

    @trace.spanned("shud.interval.launch")
    def launch(self, device: torch.device) -> None:
        """Run the program once: one graph launch on *device*'s current
        stream, or the pieces eagerly."""
        self.stats["launches"] += 1
        if self.capture:
            stream = torch.cuda.current_stream(device)
            _check(load_library().shud_graph_launch(
                self._exec, ctypes.c_void_p(stream.cuda_stream)),
                "launching it")
        else:
            self._run(self.nodes)

    def _run(self, nodes) -> None:
        for n in nodes:
            if isinstance(n, str):
                self.pieces[n]()
            elif isinstance(n, Stamp):
                buf, now = self.stamps, time.perf_counter_ns()
                buf[n.slot] += now - int(buf[-1])
                buf[-1] = now
            elif isinstance(n, While):
                while bool(n.pred()):
                    self._run(n.body)
            elif bool(n.pred()):
                self._run(n.body)

    def close(self) -> None:
        """Free the graph (also when the object is dropped)."""
        if self._exec is not None or self._graph is not None:
            lib = load_library()
            if self._exec is not None:
                lib.shud_graph_exec_destroy(self._exec)
            if self._graph is not None:
                lib.shud_graph_destroy(self._graph)
        self._exec = self._graph = None
        self._segments = {}

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to free
            pass


class SolverPieces:
    """A window's solve over static buffers (the carry *c*, ``tout``, the
    step count at the window's start, ``active``, the packed scalars); the
    parameters the RHS reads are static too.  ``pieces`` and ``nodes``
    are the solve as a ``Program``'s parts: ``head``, WHILE(active)
    {``begin``, Newton iterations 2..``newton_iters`` under nested IFs,
    ``end`` (which writes ``active`` again)}, ``tail``.  *prefix* names
    the pieces (several solvers in one program); *tout* is a 0-d buffer
    that several solvers may share (else one of its own).  *kernel*: the
    step body through the solver kernels (``solver/kernels.py``, their
    plain versions on the CPU) on a scratch of this solver's; False, the
    torch pieces."""

    def __init__(self, rhs, lin, cfg: SolverConfig, quad_fn, params,
                 c: Carry, prefix: str = "", tout=None, kernel: bool = True):
        self.rhs, self.lin, self.cfg = rhs, lin, cfg
        self.quad_fn, self.params, self.c = quad_fn, params, c
        self.prefix = prefix
        self.scratch = kernels.Scratch(c.y, cfg.krylov_m) if kernel else None
        dev = c.y.device
        self.tout = (torch.zeros((), dtype=c.t.dtype, device=dev)
                     if tout is None else tout)
        self.nsteps0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.active = torch.zeros((), dtype=torch.bool, device=dev)
        self.packed = torch.zeros(len(STEPS) + len(COUNTS) + 1,
                                  dtype=torch.float64, device=dev)
        self.plan = self.nw = None  # made by begin(), kept by a capture

    def head(self):
        self.active.copy_(active(self.c, self.tout, self.nsteps0, self.cfg))

    def start(self):
        """A window's resets on the device (the step count at its start,
        the Newton iterations zeroed), then ``head``."""
        self.nsteps0.copy_(self.c.nsteps)
        self.c.nni.zero_()
        self.head()

    def begin(self):
        self.plan, self.nw = step_begin(self.rhs, self.lin, self.c,
                                        self.tout, self.cfg,
                                        scratch=self.scratch)

    def newton(self):
        copy_into(self.nw, newton_iter(self.lin, self.plan, self.nw.y,
                                       self.nw.it, self.cfg,
                                       scratch=self.scratch))

    def end(self):
        if self.scratch is None:
            copy_into(self.c, step_end(self.c, self.plan, self.nw, self.cfg,
                                       self.quad_fn, self.params))
            self.head()
            return
        copy_into(self.c, step_end(
            self.c, self.plan, self.nw, self.cfg, self.quad_fn, self.params,
            scratch=self.scratch, tout=self.tout, nsteps0=self.nsteps0,
            go=self.active))

    def tail(self):
        self.packed.copy_(torch.cat([scalars(self.c),
                                     self.active.double()[None]]))

    def pieces(self) -> dict:
        p = self.prefix
        return {p + "begin": self.begin, p + "newton": self.newton,
                p + "end": self.end}

    def loop(self) -> While:
        """The step loop, the window's ``lax.while_loop``."""

        # iterations 2..newton_iters, each inside the IF of the last
        # (built from the innermost out: no recursive closure, whose cycle
        # would keep these buffers alive after the graph is dropped)
        p = self.prefix
        chain = ()
        for _ in range(self.cfg.newton_iters - 1):
            chain = (If(lambda: self.nw.more, (p + "newton", *chain)),)
        return While(lambda: self.active, (p + "begin", *chain, p + "end"))

    def read(self):
        """The one host read of the packed scalars, which ``tail`` wrote:
        the host waits here until the program has run."""
        with trace.span("shud.interval.wait"):
            host = self.packed.cpu().numpy()
        bdf.host_syncs += 1
        return host

    def result(self, has_quad: bool, host) -> BDFState:
        """The carry as a ``BDFState`` of copies, with the packed scalars
        *host* (``read``); its Newton iterations are added to
        ``bdf.newton_iters``."""
        bdf.newton_iters += int(host[len(STEPS) + COUNTS.index("nni")])
        c = self.c
        return from_carry(
            c._replace(y=c.y.clone(), y_prev=c.y_prev.clone(),
                       y_prev2=c.y_prev2.clone(), quad=clone(c.quad)),
            host[:-1], has_quad)


class WindowGraph:
    """``solve_to`` for the windows of one simulation, one launch of a
    CUDA graph a window on the card.

    ``f(t, y, params)``, ``linearize(t, y, params)`` and ``quad_fn(t, y,
    params)`` are ``solve_to``'s; *params* is a pytree of tensors (the
    window's forcing) whose shapes every window keeps: the first window's
    are cloned into static buffers that every later one is copied into.
    *capture*: build and replay the graph (the default on CUDA tensors);
    False runs the same pieces eagerly, each WHILE and IF decided by
    reading its predicate.  A capture, an instantiation or a launch that
    fails raises: nothing falls back to the eager loop.

    A returned ``BDFState`` holds copies of the buffers, never the buffers
    the next window overwrites; handed back unchanged (``state is`` the
    last one returned), it is not uploaded again.

    ``stats``: steps of each window, host syncs, graph launches, and the
    warm-up, capture and instantiation seconds.  *solver_kernel*: the step
    body through the solver kernels (``SolverPieces``)."""

    def __init__(self, f, linearize, cfg: SolverConfig, quad_fn=None,
                 capture: "bool | None" = None, solver_kernel: bool = True):
        self.f, self.linearize, self.cfg = f, linearize, cfg
        self.quad_fn, self.capture = quad_fn, capture
        self.solver_kernel = solver_kernel
        self.params = self.prog = self.program = None
        self._last = None
        self.stats = {"steps": [], "syncs": 0, "warmup_newton_iters": 0}

    def solve(self, state: BDFState, tout, params) -> BDFState:
        """Advance *state* to *tout* under the window's *params*."""
        global warmup_newton_iters
        if self.prog is None:
            self._setup(state, params)
        copy_into(self.params, params)
        p = self.prog
        if self.capture and not self.program.built:
            self.program.build(p.c.y.device)
            self._last = None  # the warm-up moved the carry
            self.stats["warmup_newton_iters"] = 2
            warmup_newton_iters += 2
        if state is not self._last:
            copy_into(p.c, to_carry(state))
        p.tout.fill_(float(tout))
        p.nsteps0.copy_(p.c.nsteps)
        p.c.nni.zero_()
        self.program.launch(p.c.y.device)
        self.stats["syncs"] += 1
        out = p.result(state.quad is not None, p.read())
        self.stats["steps"].append(out.nsteps - state.nsteps)
        self._last = out
        return out

    def _setup(self, state: BDFState, params) -> None:
        if self.capture is None:
            self.capture = state.y.is_cuda
        self.params = clone(params)
        rhs, lin = functions(self.f, self.params, self.linearize)
        p = self.prog = SolverPieces(rhs, lin, self.cfg, self.quad_fn,
                                     self.params, clone(to_carry(state)),
                                     kernel=self.solver_kernel)
        self.program = Program(
            {"head": p.head, **p.pieces(), "tail": p.tail},
            ("head", p.loop(), "tail"), self.capture)
        self.program.stats.update(self.stats)
        self.stats = self.program.stats  # one dict: the launches too

    def close(self) -> None:
        """Free the graph."""
        if self.program is not None:
            self.program.close()
