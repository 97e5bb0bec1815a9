"""The plain reference at a tenth of the configuration's tolerances:
``portbench/reference/`` (SHUD's fused driver in PyTorch at float64) run
with RELTOL and ABSTOL each divided by ten, for a cell whose reference at
the configuration's own tolerances parts from the truth by as much as the
calibration's control does.

On the 2,097,152-cell storm the reference at 1e-4 lets the flood front
along its 1,024-reach chain drift: against itself at 1e-5 it reads 3.5
``water_wrms`` (weighted at 1e-4), the control 13.1, a sound float32 run
0.41.  At a tenth of the tolerances the reference's own error falls well
under the program's, so the comparison's floor is the program's and the
planted faults stand out of it.  The comparison still weighs the gaps at
the configuration's tolerances (``compare.gaps``).

Everything but the driver is ``reference/``'s (the modules that the
harness and ``work.py`` read: ``project``, ``mesh``, ``forcing``,
``device``, ``init``, ``landsurface``, ``rhs``), so the rooflines count
the same work.  ``driver.simulate`` keeps its result on the card's
machine, keyed by its input and these sources (``driver.CACHE``): a
later run of the same input in the same checkout reads it back instead of
solving again.
"""
