"""The initial state with the lakes' stages: ``reference/init.py``'s."""

from portbench.reference.init import (  # noqa: F401
    initial_buckets, initial_state)
