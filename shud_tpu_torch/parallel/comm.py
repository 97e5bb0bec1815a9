"""One process per rank: the rank's process group and the three operations
the sharded code needs.

The JAX package runs its domain decomposition inside one ``shard_map``
over a device mesh (``shud_tpu/parallel/sharded.py``).  Here every shard is
a process of its own (``torch.distributed``): NCCL when the rank's device
is a CUDA device, gloo on the CPU.  ``shard_map``'s collectives map onto:

* ``lax.ppermute`` (one round of ``ExchangePlan.perms``): ``ppermute_round``,
  one ``batch_isend_irecv`` of the round's send and receive pair;
* ``lax.psum``: ``psum``, an ``all_gather`` of the per-rank partials and
  their sum in rank order on every rank, so that every rank holds the same
  bits (an ``all_reduce`` may add in another order on each rank, and the
  solver's step and Newton decisions must be the same on every rank, or
  the ranks run different numbers of iterations and a collective is left
  unmatched).

The card's host may have one GPU, and NCCL refuses two ranks on one device,
so the device and backend of each rank are the caller's: ``backend="gloo"``
with CUDA devices stages every payload through host memory, explicitly and
only when asked, never as a fallback from NCCL.  ``spawn`` starts the ranks
of one host (the command line's ``--shards`` and the tests);
``init_distributed`` makes the calling process one rank of a launched job
(``--distributed``).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


class Group:
    """This rank of a group of *size* ranks, on *device*.

    ``size == 1`` needs no process group: every operation is local."""

    def __init__(self, rank: int, size: int, device, backend: str = "gloo"):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        # gloo moves host memory: a CUDA payload goes through the host
        self.staging = backend == "gloo" and self.device.type == "cuda"

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.staging else x

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staging else x

    def ppermute_round(self, send: torch.Tensor, perm) -> torch.Tensor:
        """One ``lax.ppermute`` round: send *send* to the rank this rank
        maps to in *perm* (``[(src, dst), ...]``, each rank at most once a
        source and once a destination), and return what the rank mapping to
        this one sent: a tensor like *send*, zeros where none does."""
        dst = next((d for s, d in perm if s == self.rank), None)
        src = next((s for s, d in perm if d == self.rank), None)
        recv = torch.zeros_like(self._out(send))
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, self._out(send).contiguous(),
                                  dst))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._in(recv)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's *x* (same shape and dtype on every rank), in rank
        order."""
        if self.size == 1:
            return [x]
        xs = self._out(x).contiguous()
        parts = [torch.empty_like(xs) for _ in range(self.size)]
        dist.all_gather(parts, xs)
        return [self._in(t) for t in parts]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of *x* over the ranks, added in rank order on every rank
        (the same bits everywhere, the same from run to run)."""
        if self.size == 1:
            return x
        parts = self.all_gather(x)
        acc = parts[0]
        for t in parts[1:]:
            acc = acc + t
        return acc

    def barrier(self) -> None:
        if self.size > 1:
            self.psum(torch.zeros(1, device=self.device))


def _init(rank: int, size: int, backend: str, device,
          init_method: str) -> Group:
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, rank {rank} has "
                             f"{device}")
        torch.cuda.set_device(device)
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo': {backend!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    group = Group(rank, size, device, backend)
    # every rank takes part in the first collective (NCCL sets up its
    # communicator there; a first batch_isend_irecv must not do it)
    group.barrier()
    return group


def init_distributed(coordinator: "str | None" = None,
                     num_processes: "int | None" = None,
                     process_id: "int | None" = None,
                     device=None) -> Group:
    """Make this process one rank of a launched job (the counterpart of
    ``shud_tpu/parallel/runtime.py:init_distributed``).

    ``coordinator`` ``"host:port"`` with ``num_processes`` and
    ``process_id``; all ``None`` reads ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``).  *device* defaults to the CUDA device of the local
    rank; the backend is NCCL on CUDA and gloo on the CPU."""
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
        size, rank = int(num_processes), int(process_id)
        local = rank
    else:
        init_method = "env://"
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; run with --cpu to take the "
                               "CPU (gloo)")
        device = f"cuda:{local % torch.cuda.device_count()}"
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    return _init(rank, size, backend, device, init_method)


def check_devices(p: int, devices) -> list:
    """The *p* ranks' devices, or a fast failure naming the count (an
    undersized list would fail later, in the first exchange)."""
    devices = [torch.device(d) for d in devices]
    if len(devices) < p:
        raise ValueError(
            f"partition has {p} shards but only {len(devices)} device(s) "
            f"were passed (one rank per shard)")
    return devices[:p]


def cuda_devices(p: int) -> list:
    """One visible CUDA device per rank, or a fast failure naming how many
    are visible (NCCL refuses two ranks on one device)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < p:
        raise ValueError(
            f"--shards {p}: only {n} CUDA device(s) are visible (one rank "
            f"per device under NCCL); run with --cpu for {p} gloo ranks on "
            f"the CPU")
    return [torch.device(f"cuda:{i}") for i in range(p)]


def _rank_main(queue, fn, rank, size, backend, device, init_method, args):
    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        group = _init(rank, size, backend, device, init_method)
        queue.put((rank, True, fn(group, *args)))
    except BaseException:  # reported to the parent, which raises it
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, p: int, backend: str, devices, args=(),
          timeout: float = 3600.0) -> list:
    """Run ``fn(group, *args)`` on *p* new ranks, rank r on ``devices[r]``,
    and return their results in rank order (``fn`` and its arguments and
    result are pickled: ``fn`` is a module-level function, and nothing of
    the calling process reaches the ranks but these).

    The ranks meet at a ``file://`` store in a new temporary directory.  A
    rank that raises ends the run: the others are stopped and its
    traceback is raised here."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    devices = check_devices(p, devices)
    ctx = mp.get_context("spawn")
    tmp = tempfile.TemporaryDirectory(prefix="shud_ranks_")
    store = os.path.join(tmp.name, "store")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(q, fn, r, p, backend, str(devices[r]),
                               f"file://{store}", args))
             for r in range(p)]
    for proc in procs:
        proc.start()
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < p and failure is None:
            try:
                rank, ok, out = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, proc in enumerate(procs) if r not in results
                        and proc.exitcode is not None]
                if dead and q.empty():
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                results[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for proc in procs:
            if failure is not None:
                proc.terminate()
            proc.join()
        tmp.cleanup()
    if failure is not None:
        raise RuntimeError(failure)
    return [results[r] for r in range(p)]
