"""The initial state: ``reference/init.py``'s."""

from portbench.reference.init import (  # noqa: F401
    initial_buckets, initial_state)
