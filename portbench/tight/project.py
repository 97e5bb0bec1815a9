"""The input dataclasses: ``reference/project.py``'s."""

from portbench.reference.project import (  # noqa: F401
    Calib, Control, FilePaths, ForcingCSV, ProjectInput)
