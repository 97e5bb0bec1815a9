"""The land surface (no ground heat or transpiration on lake cells):
``reference/landsurface.py``'s."""

from portbench.reference.landsurface import (  # noqa: F401
    BucketState, CalibScalars, cell_forcing, et_bucket_step)
