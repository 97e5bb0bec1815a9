"""The port's user tools, each runnable as ``python -m
shud_tpu_torch.tools.<name>`` on a host without JAX: ``autocalibrate``
(CMA-ES against observed outlet discharge) and ``calib_tournament``
(re-scoring a search's winners over the full record)."""
