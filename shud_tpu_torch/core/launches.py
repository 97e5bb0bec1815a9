"""Launch counts of the CUDA kernels, on the host and on the device.

Each kernel wrapper adds one to its host count where it launches its
kernel (``host``), and the kernel itself adds one to a device counter
where it runs (``csrc/*.cu``: thread 0 of block 0, ``atomicAdd``).  The
two agree on an eager run.  A kernel captured into a CUDA graph
(``solver/graph.py``) is launched by the host once, at the capture, and
runs once per replay of its node, and not at all inside a conditional
node whose condition is false: there only the device count says how often
it ran.
"""

from __future__ import annotations

import torch


class LaunchCounts:
    """The counts of the kernels *names* of one module."""

    def __init__(self, names):
        self.names = tuple(names)
        self.host = dict.fromkeys(self.names, 0)
        self._device = {}  # device index -> int64 [len(names)]
        self._address = {}  # (name, device index) -> its counter's address

    def pointer(self, name: str, device) -> int:
        """The address of *name*'s device counter on *device* (a CUDA
        device or its index), made at the first launch there, before any
        capture: a graph's warm-up runs every piece eagerly,
        ``solver/graph.Program.build``.  A reset zeroes the counters in
        place, so an address holds for the process."""
        index = device if isinstance(device, int) else device.index
        addr = self._address.get((name, index))
        if addr is None:
            counts = self._device.get(index)
            if counts is None:
                counts = self._device[index] = torch.zeros(
                    len(self.names), dtype=torch.int64,
                    device=torch.device("cuda", index))
            addr = self._address[(name, index)] = (
                counts.data_ptr() + 8 * self.names.index(name))
        return addr

    def reset(self) -> None:
        for k in self.host:
            self.host[k] = 0
        for counts in self._device.values():
            counts.zero_()

    def device(self) -> dict:
        """Runs of each kernel on every device since the last reset (one
        transfer a device)."""
        out = dict.fromkeys(self.names, 0)
        for counts in self._device.values():
            for k, n in zip(self.names, counts.tolist()):
                out[k] += n
        return out
