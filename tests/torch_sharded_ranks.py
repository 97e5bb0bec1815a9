"""Rank workers of the port's sharded tests (``comm.spawn`` pickles them
by name).  The module imports no JAX, so the spawned ranks never do."""

import numpy as np
import torch

from shud_tpu_torch.parallel.partition import riv_blocks, shard_state
from shud_tpu_torch.parallel.sharded import ShardRHS

CELL_FORCING = ("net_prcp", "prcp", "pot_evap", "pot_tran", "e_ic", "lai",
                "fu_surf", "fu_sub", "ele_ybc", "ele_qbc", "ele_qss")


def cell_blocks(sm, v):
    out = np.zeros((sm.p, sm.np_cells))
    out[sm.old_to_shard, sm.old_to_slot] = v
    return out


def local_forcing(rhs, sm, fs: dict):
    """The rank's ForcingSlice from dense numpy forcing arrays."""
    q = rhs.group.rank

    def t(a):
        return torch.as_tensor(a, device=rhs.device).to(rhs.dtype)

    cell = {k: t(cell_blocks(sm, fs[k])[q]) for k in CELL_FORCING}
    riv = {k: t(riv_blocks(sm, fs[k])[q]) for k in ("riv_ybc", "riv_qbc")}
    return rhs.forcing_slice(cell, riv)


def eval_rank(group, sm, fs, y, v, dtype, close_boundary, edge_kernel):
    """One sharded RHS with its diagnostics, and one hand J·v at *y* along
    *v* (dense host arrays): each rank's local results as numpy."""
    rhs = ShardRHS(sm, group, dtype, close_boundary, edge_kernel)
    ys = rhs.local_state(shard_state(sm, y))
    vs = rhs.local_state(shard_state(sm, v))
    slc = local_forcing(rhs, sm, fs)
    dy, diag = rhs.rhs_full(0.0, ys, slc)
    dy_lin, jvp = rhs.linearize(0.0, ys, slc)
    jv = jvp(vs)

    def h(x):
        return x.detach().cpu().double().numpy()

    return {"dy": h(dy), "dy_lin": h(dy_lin), "jv": h(jv),
            "diag": {k: h(x) for k, x in diag.items()}}


def eval_cases(group, jobs):
    """``eval_rank`` for each (partition, forcing, state, tangent,
    close_boundary) of *jobs*, float64."""
    return [eval_rank(group, sm, fs, y, v, torch.float64, cb, "auto")
            for sm, fs, y, v, cb in jobs]


def windows_rank(group, inp, n_windows, dtype, edge_kernel="auto",
                 diag=True):
    """``ShardedSimulation`` over *n_windows* solver windows: after each,
    the global state (every rank), steps and NFE."""
    from shud_tpu_torch.core.mesh import build_mesh
    from shud_tpu_torch.parallel.runtime import ShardedSimulation

    sim = ShardedSimulation(inp, build_mesh(inp), group, float_dtype=dtype,
                            edge_kernel=edge_kernel)
    out = []
    for _ in range(n_windows):
        acc = sim.acc_zero() if diag else None
        sim.advance_window(sim.t + inp.control.solver_step, acc)
        out.append({"y": sim.y_full(), "nfe": sim.nfe,
                    "nsteps": int(sim.state.nsteps)})
    return out


def kernels_rank(group, sm, fs, y, v):
    """One sharded RHS and one hand J·v with the edge kernels and the same
    on their plain versions (float32 on the rank's CUDA device): each
    rank's local results, and its launch counts of the kernel runs."""
    from shud_tpu_torch.core import edge

    out = {}
    for name, kernel in (("kernel", True), ("plain", False)):
        rhs = ShardRHS(sm, group, torch.float32, True, kernel)
        ys = rhs.local_state(shard_state(sm, y))
        vs = rhs.local_state(shard_state(sm, v))
        slc = local_forcing(rhs, sm, fs)
        edge.reset_launch_counts()
        dy = rhs.rhs(0.0, ys, slc)
        dy_lin, jvp = rhs.linearize(0.0, ys, slc)
        jv = jvp(vs)
        torch.cuda.synchronize()
        out[name] = {"dy": dy.cpu().numpy(), "dy_lin": dy_lin.cpu().numpy(),
                     "jv": jv.cpu().numpy(),
                     "launches": dict(edge.launch_counts)}
    return out


def twin(end_day: float = 0.25):
    """The JAX package's sharded-driver twin project
    (``tests/test_sharded_driver.py:_twin``), from the port's synthetic
    watershed: every output channel at 360 minutes, UGRID mirrors on."""
    import dataclasses

    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=end_day)
    cs = inp.control
    for f in dataclasses.fields(cs):
        if f.name.startswith("dt_") and getattr(cs, f.name):
            setattr(cs, f.name, 360)
    cs.dt_ye_surf = cs.dt_ye_unsat = cs.dt_ye_gw = 360
    cs.dt_qe_et = cs.dt_qe_etp = cs.dt_qe_eta = 360
    cs.dt_Qr_down = cs.dt_yr_stage = cs.dt_Qe_sub = 360
    cs.update_ic_step = 360
    cs.output_mode = "BOTH"
    return inp


def bc_cryo_project():
    """The JAX package's BC + cryosphere project
    (``tests/test_sharding.py:_bc_cryo_project``) from the port's synthetic
    watershed: every BC/SS class active, cold forcing, cryosphere on."""
    from shud_tpu_torch.utils.synthetic import make_synthetic_project

    inp = make_synthetic_project(16, 8, end_day=1.0)
    inp.forc.data[0][:, 1] = -3.0
    inp.att[10, 6] = 1    # element head (Dirichlet) BC, series column 1
    inp.att[40, 6] = -1   # element flux (Neumann) BC, column 1
    inp.att[70, 7] = 1    # element source/sink series, column 1
    inp.riv[2, 5] = 1     # river stage BC
    inp.riv[5, 5] = -1    # river flux BC
    bt = np.array([0.0, 720.0])
    inp.bc = {
        "ele_y": (bt, np.array([[6.0], [6.5]])),
        "ele_q": (bt, np.array([[0.05], [0.02]])),
        "ele_ss": (bt, np.array([[0.03], [0.06]])),
        "riv_y": (bt, np.array([[0.8], [0.6]])),
        "riv_q": (bt, np.array([[0.2], [0.1]])),
    }
    inp.control.cryosphere = 1
    return inp


def driver_rank(group, runs):
    """``run_project_sharded`` once per (project, keywords) of *runs*, in
    order, on the same ranks: rank 0's final state and counters of each."""
    from shud_tpu_torch.parallel.runtime import run_project_sharded

    out = []
    for inp, kw in runs:
        sim = run_project_sharded("synthetic", group=group, inp=inp,
                                  verbose=False, **kw)
        out.append({"y": sim.y_full(), "nfe": sim.nfe, "t": sim.t})
    return out


def _cli(argv):
    """The command line with ``load_project`` answering the twin project
    (the synthetic watershed exists only in memory)."""
    from shud_tpu_torch import cli
    from shud_tpu_torch.io import project

    project.load_project = lambda *a, **k: twin()
    torch.set_num_threads(1)
    cli.main(argv)


if __name__ == "__main__":
    import sys

    _cli(sys.argv[1:])
