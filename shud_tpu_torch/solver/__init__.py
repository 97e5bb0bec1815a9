from shud_tpu_torch.solver.bdf import BDFState, SolverConfig, bdf_init, solve_to
