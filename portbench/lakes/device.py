"""The device mesh with the lakes' gather lists: ``reference/device.py``'s."""

from portbench.reference.device import (  # noqa: F401
    GatherLists, TorchMesh, gather_sum, to_torch)
