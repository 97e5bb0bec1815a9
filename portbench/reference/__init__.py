"""The plain reference the benchmark holds the program against: SHUD's
fused driver in PyTorch at float64, frozen copies of the port's plain
modules (mesh, forcing, land surface, the right-hand side in the C++
operation order) and a solver of its own.  It imports nothing of the
program and takes nothing the program made."""
