"""The forcing tables: ``reference/forcing.py``'s."""

from portbench.reference.forcing import build_forcing  # noqa: F401
