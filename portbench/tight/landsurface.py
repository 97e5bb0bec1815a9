"""The land surface: ``reference/landsurface.py``'s."""

from portbench.reference.landsurface import (  # noqa: F401
    BucketState, CalibScalars, cell_forcing, et_bucket_step)
