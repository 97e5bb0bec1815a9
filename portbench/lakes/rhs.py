"""The right-hand side with its lake branches: ``reference/rhs.py``'s."""

from portbench.reference.rhs import _rhs, rhs, rhs_full  # noqa: F401
