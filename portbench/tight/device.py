"""The device mesh: ``reference/device.py``'s."""

from portbench.reference.device import (  # noqa: F401
    GatherLists, TorchMesh, gather_sum, to_torch)
