"""The plain reference of a basin with lakes: SHUD's fused driver in
PyTorch at float64, as ``portbench/reference/`` runs it, with SHUD's lake
equations on.  It imports nothing of the program and takes nothing the
program made; ``reference/`` stays the yardstick of the lake-free cells.

The modules that the harness and ``work.py`` read (``project``, ``mesh``,
``forcing``, ``device``, ``init``, ``landsurface``, ``rhs``) are
``reference/``'s, whose frozen copies of the plain mesh, device tables and
right-hand side already carry the lake branches; ``driver`` is
``reference/driver.py`` with lakes let through.  The lake equations, in
the C++ operation order (``reference/rhs.py`` ``_rhs``):

- lake cells as ``updateLakeElement`` (Element.cpp:373-383): effective
  conductivity the saturated one, no deficit, saturation 1; their
  infiltration, recharge, exfiltration, ET and lateral fluxes zeroed and
  their dY zeroed (MD_f.cpp:146-150), open-water evaporation counted to
  the lake instead;
- the lake-bank edges of a land cell (``lakenabr``, MD_Lake.cpp:138-150):
  the weir law of its surface water against the lake's stage over the
  lake's bottom, and Darcy's law of its groundwater against the same head
  (MD_ElementFlux.cpp:46-53,122), summed per lake without the unfrozen
  fraction;
- reach -> lake routing: a reach whose ``down`` is -4, -5, ... flows into
  lake 1, 2, ... by the zero-depth-gradient Manning law, and PassValue
  skips it (its discharge reaches no reach; MD_RiverFlux.cpp:5-63,
  MD_f.cpp:217-257);
- per lake, the cells' precipitation and potential evaporation over the
  lake's cell count summed in cell order, the evaporation clamped to
  ``max(min(E, P + stage), 0)`` (MD_f.cpp:44-47);
- the bathymetry's stage -> top area, a sequential piecewise-linear scan
  at the absolute stage (Lake.cpp:59-78);
- ``dStage = P - E + (RivIn - RivOut + Qsub + Qsurf) / A_lake``
  (MD_f.cpp:180-191).

Departures from the C++: ``RivOut`` is 0 (the C++ zeroes ``QLakeRivOut``
and never fills it, MD_update.cpp:184), so it is left out of the sum; the
lake's diagnostics are not accumulated (the comparison reads the state
and the reaches' discharge).  The cryosphere and boundary conditions are
still refused.
"""
