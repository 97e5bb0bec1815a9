"""The right-hand side: ``reference/rhs.py``'s."""

from portbench.reference.rhs import _rhs, rhs, rhs_full  # noqa: F401
