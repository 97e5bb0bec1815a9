"""setup.create_s: seconds the program took to create the simulation
(mesh, tables, forcing, state on the card), its ``shud.setup.create``
span (``portbench/spans.py``)."""

from portbench import spans


def read(probe):
    t = spans.measure(probe)
    return None if t is None else t["create_s"]
