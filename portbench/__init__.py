"""The benchmark of shud_tpu_torch, the PyTorch and CUDA port: one cell
(a configuration under a traffic mix) run once by ``run.py``."""
