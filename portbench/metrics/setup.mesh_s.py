"""setup.mesh_s: seconds the program's set-up took to check its input
and build the mesh (``check_input`` and ``build_mesh``), the counter
``shud.setup.mesh_ns`` that ``FusedSimulation.create`` states with its
span ``shud.setup.mesh``.  On stderr: that and ``shud.setup.tables_ns``
(the mega tables and the mesh's tensors on the card), for the split of
set-up.  None where the program states no such counter (an older
checkout)."""

import sys


def read(probe):
    try:
        from shud_tpu_torch import trace
    except ImportError:
        return None
    got = trace.counters()
    ns = got.get("shud.setup.mesh_ns")
    if ns is None:
        return None
    setup = {k: v for k, v in got.items() if k.startswith("shud.setup.")}
    print(f"set-up counters: {setup!r}", file=sys.stderr)
    return ns / 1e9
