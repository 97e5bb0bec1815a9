"""The host mesh: ``reference/mesh.py``'s."""

from portbench.reference.mesh import MeshData, build_mesh  # noqa: F401
