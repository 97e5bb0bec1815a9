"""The host mesh with its lake sets: ``reference/mesh.py``'s."""

from portbench.reference.mesh import MeshData, build_mesh  # noqa: F401
