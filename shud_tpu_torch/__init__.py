"""shud_tpu_torch — the PyTorch/CUDA port of shud_tpu.

The same SHUD-class watershed physics, adaptive BDF Newton–Krylov solver
and output files as ``shud_tpu``, on PyTorch tensors.  The package imports
``torch`` and numpy, never JAX: the host-side numpy modules are copies of
``shud_tpu``'s, and the edge-flux stencil runs hand-written CUDA kernels
(``csrc/edge_flux.cu``) on an NVIDIA Hopper GPU.  ``shud_tpu`` stays the
reference the port is tested against.
"""

__version__ = "0.1.0"
