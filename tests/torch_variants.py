"""Shared inputs for the port-vs-reference tests (tests/test_torch_*.py).

Each variant is a synthetic watershed built the same way by both packages'
``make_synthetic_project``: plain, with a lake, with open boundaries, with
a shuffled then RCM-localised cell numbering (no structured-mesh shortcut
applies to it), and with a branched river network.  Random states and
forcing are made with numpy from a seed and handed to both packages.  The
module imports neither package at its top, so the GPU tests can use it
without JAX.
"""

import dataclasses

import numpy as np

VARIANTS = ("plain", "lake", "open", "rcm")


def branch_rivers(inp, nx: int):
    """Add a tributary reach joining the chain at reach 5, with three
    segments of its own, one of them on a cell that already has one: a
    confluence, a reach with several segments and a cell with two."""
    riv = np.asarray(inp.riv, np.float64)
    nr = riv.shape[0]
    trib = riv[4].copy()
    trib[0], trib[1] = nr + 1, 5
    inp.riv = np.vstack([riv, trib])
    seg = np.asarray(inp.rivseg, np.float64)
    ns = seg.shape[0]
    # two cells of the second row (upper triangles, 1-based ids) and the
    # bottom-row cell of reach 5
    cells = [2 * (nx + 4) + 2, 2 * (nx + 5) + 2, 2 * 4 + 1]
    extra = np.array([[ns + k + 1, nr + 1, c, 100.0]
                      for k, c in enumerate(cells)])
    inp.rivseg = np.vstack([seg, extra])
    return inp


def make_project(pkg: str, variant: str, nx: int = 12, ny: int = 8,
                 end_day: float = 2.0):
    """The *variant* project from package *pkg* ("jax" or "torch");
    "branched" is the plain one with ``branch_rivers``."""
    if pkg == "jax":
        from shud_tpu.utils import reorder, synthetic
    else:
        from shud_tpu_torch.utils import reorder, synthetic
    inp = synthetic.make_synthetic_project(
        nx, ny, end_day=end_day, with_lake=(variant == "lake"))
    if variant == "branched":
        inp = branch_rivers(inp, nx)
    if variant == "open":
        inp.control.close_boundary = 0
    if variant == "rcm":
        ne = inp.tri.shape[0]
        perm = np.random.default_rng(7).permutation(ne)
        inp, _ = reorder.localize_project(reorder.permute_project(inp, perm))
    return inp


def meshes(variant: str, nx: int = 12, ny: int = 8):
    """(jax MeshData, torch MeshData, close_boundary) for *variant*."""
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu_torch.core.mesh import build_mesh as torch_build

    jinp = make_project("jax", variant, nx, ny)
    tinp = make_project("torch", variant, nx, ny)
    return (jax_build(jinp), torch_build(tinp),
            bool(jinp.control.close_boundary))


def random_inputs(md, seed: int = 0, dry_every: int = 0):
    """(forcing-slice dict, state) as float64 numpy arrays.  States stay off
    the tie points of the flux laws unless *dry_every* > 0, which sets every
    dry_every-th surface depth to exactly 0."""
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(seed)
    fs = dict(
        net_prcp=rng.uniform(0, 2e-5, ne), prcp=rng.uniform(0, 2e-5, ne),
        pot_evap=rng.uniform(0, 1e-6, ne), pot_tran=rng.uniform(0, 1e-6, ne),
        e_ic=rng.uniform(0, 1e-7, ne), lai=np.full(ne, 2.0),
        fu_surf=np.ones(ne), fu_sub=np.ones(ne), ele_ybc=np.zeros(ne),
        ele_qbc=np.zeros(ne), ele_qss=np.zeros(ne), riv_ybc=np.zeros(nr),
        riv_qbc=np.zeros(nr),
    )
    sf = rng.uniform(1e-4, 0.05, ne)
    if dry_every:
        sf[::dry_every] = 0.0
    y = np.concatenate([sf, rng.uniform(0.05, 1.0, ne),
                        rng.uniform(0.05, 8.0, ne), rng.uniform(0.05, 1.0, nr),
                        rng.uniform(0.5, 2.0, nl)])
    return fs, y


def scaled_err(a, b) -> float:
    """max |a - b| / max |a| (0 for empty arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    scale = float(np.abs(a).max()) or 1.0
    return float(np.abs(a - b).max()) / scale


def with_bc(md):
    """Head and flux BCs, source terms and river BCs on a mesh
    (tests/test_pallas_mega.py:41-50)."""
    i_bc = np.asarray(md.i_bc).copy()
    i_ss = np.asarray(md.i_ss).copy()
    riv_bc = np.asarray(md.riv_bc).copy()
    i_bc[::31] = 1
    i_bc[5::37] = -1
    i_ss[3::29] = 1
    i_ss[7::41] = -1
    riv_bc[::13] = 1
    riv_bc[1::17] = -1
    return dataclasses.replace(md, i_bc=i_bc, i_ss=i_ss, riv_bc=riv_bc)


def widen_lists(dm, names, k: int = 130):
    """The device mesh *dm* with each gather list of *names* padded to *k*
    columns with the index of its appended zero: the same sums, wider than
    the order the RHS kernels keep (``edge.sum_in_order``)."""
    import torch

    pads = {"seg_to_ele": dm.num_seg, "seg_to_riv": dm.num_seg,
            "riv_to_down": dm.num_riv}
    lists = dm.lists
    for name in names:
        t = getattr(lists, name)
        pad = t.new_full((t.shape[0], k - t.shape[1]), pads[name])
        lists = lists._replace(**{name: torch.cat([t, pad], dim=1)})
    return dataclasses.replace(dm, lists=lists)


def mega_inputs(md, seed: int):
    """(forcing dict, state, tangent) as float32 numpy for the megakernel
    tests: non-unit fu_surf/fu_sub, BC values, and a state with exact ties
    (dry cells, empty unsaturated layers, water tables at the surface,
    empty reaches), as tests/test_pallas_mega.py makes them."""
    ne, nr, nl = md.num_ele, md.num_riv, md.num_lake
    rng = np.random.default_rng(seed)

    def rpos(scale, n=ne):
        return np.abs(rng.normal(0.0, scale, n))

    fs = dict(
        net_prcp=rpos(2e-5), prcp=rpos(2e-5), pot_evap=rpos(5e-6),
        pot_tran=rpos(5e-6), e_ic=rpos(2e-6), lai=rpos(2.0),
        fu_surf=rng.uniform(0.3, 1.0, ne), fu_sub=rng.uniform(0.3, 1.0, ne),
        ele_ybc=rpos(1.0), ele_qbc=rng.normal(0, 1e-3, ne),
        ele_qss=rng.normal(0, 1e-3, ne), riv_ybc=rpos(0.5, nr),
        riv_qbc=rpos(1e-2, nr))
    sf = np.abs(rng.normal(0.005, 0.01, ne))
    sf[::7] = 0.0
    us = np.abs(rng.normal(0.1, 0.1, ne))
    us[::11] = 0.0
    gw = np.abs(rng.normal(1.5, 1.0, ne))
    gw[::13] = np.asarray(md.aq_depth)[::13] + 0.01
    riv = np.abs(rng.normal(0.3, 0.2, nr))
    riv[::5] = 0.0
    lake = np.abs(rng.normal(5.0, 2.0, nl)) + 1.0
    y = np.concatenate([sf, us, gw, riv, lake]).astype(np.float32)
    fs = {k: v.astype(np.float32) for k, v in fs.items()}
    v = rng.normal(0.0, 1.0, y.shape[0]).astype(np.float32)
    return fs, y, v


# lakes in place of the lakes-32k basin's one: (share of the lake cells,
# centre as a fraction of the grid) each
THREE_LAKES = ((0.8, (0.5, 0.46)), (0.1, (0.17, 0.83)), (0.1, (0.85, 0.16)))
SEVEN_LAKES = ((0.4, (0.5, 0.5)), (0.1, (0.12, 0.15)), (0.1, (0.12, 0.85)),
               (0.1, (0.88, 0.15)), (0.1, (0.88, 0.85)), (0.1, (0.5, 0.1)),
               (0.1, (0.5, 0.9)))

# Lake basins for the mega kernels' stage C, which gathers a lake's lists
# 128 entries a round (core/mega.py STAGE_C_CHUNK): name -> (lake_basin's
# arguments, lakes, widest bank-edge list, gather rounds).  Lakes of
# unequal widths in one launch; more lakes (7) than the 16 x 12 basin's
# grid has blocks (5); the widest list inside one round (127), on a
# round's boundary (128, 129), across two (the benchmark's lakes-32k at
# its full size) and across three (a larger lake whose 105 outlets flow
# into it).
STAGE_C_BASINS = {
    "three": (dict(lakes=THREE_LAKES), 3, 20, 1),
    "seven": (dict(lakes=SEVEN_LAKES), 7, 18, 1),
    "k127": (dict(nx=64, ny=64, share=0.18), 1, 127, 1),
    "k128": (dict(nx=64, ny=48, share=0.26), 1, 128, 1),
    "k129": (dict(nx=64, ny=48, share=0.2525), 1, 129, 2),
    "full": (dict(nx=128, ny=128), 1, 229, 2),
    "wide": (dict(nx=128, ny=128, share=0.3, routed=True), 1, 267, 3),
}


def lake_basin(nx: int = 16, ny: int = 12, lakes=None,
               share: "float | None" = None, routed: bool = False):
    """The benchmark's ``lakes-32k`` basin (``portbench/generators/
    lakebasin.py``; no JAX) at *nx* x *ny* quads, with *lakes* in place of
    its one (``None``: its own), *share* of its cells in lakes where given,
    and with *routed* its outlets flowing into the first lake (``down``
    -4): the raw project, its configuration and the storm traffic."""
    import json
    from pathlib import Path

    from portbench import gen, harness

    bench = Path(__file__).resolve().parent.parent / "portbench"
    cfg = dict(json.loads((bench / "configs/lakes-32k.json").read_text()),
               nx=nx, ny=ny)
    if lakes is not None:
        lake = cfg["lakes"][0]
        cfg["lakes"] = [dict(lake, share=s, centre=list(c)) for s, c in lakes]
    if share is not None:
        cfg["lake_cell_share"] = share
    traffic = json.loads((bench / "traffic/storm.json").read_text())
    raw = gen.make_raw(cfg, traffic,
                       generator=harness.hooks(harness.OWN, cfg).generator)
    if routed:
        riv = raw["riv"].copy()
        riv[:, 1] = np.where(riv[:, 1] == -3, -4, riv[:, 1])
        raw = dict(raw, riv=riv)
    return raw, cfg, traffic


# the CMFD2 variables: (cfg key, file variable, units)
CMFD_VARS = (("PREC", "prec", "mm/day"), ("TEMP", "temp", "K"),
             ("SHUM", "shum", "kg/kg"), ("SRAD", "srad", "W m-2"),
             ("WIND", "wind", "m s-1"), ("PRES", "pres", "Pa"))
CMFD_PRES = 1.0e5  # [Pa]


def cmfd_table(forc, end_min: float):
    """The first station's forcing table as a CMFD2 product carries it:
    records from minute 0 (a record before the forcing's start holds at
    minute 0, as its step semantics do) to ``end_min`` + one day, each
    column quantised by the product reader's rules (precipitation 1e-4
    mm/day, temperature 0.01 C, humidity 1e-4, wind 0.01 m/s, radiation
    1 W/m2).  Returns (t_min [K], data [K, 5])."""
    from shud_tpu_torch.io.ncforcing import _quantise

    t = np.asarray(forc.t_min[0], np.float64)
    data = np.asarray(forc.data[0], np.float64)
    first = max(int(np.searchsorted(t, 0.0, side="right")) - 1, 0)
    keep = np.arange(len(t)) >= first
    keep &= t <= end_min + 1440.0
    t, data = np.maximum(t[keep], 0.0), data[keep]
    cols = _quantise(*(data[:, j] for j in range(5)))
    return t, np.stack(cols, axis=1)


def write_cmfd_netcdf3(inp, inpath: str, end_min: float):
    """Write *inp*'s forcing (one station) as a CMFD2 NetCDF-3 product
    (``scipy.io.netcdf_file``, one file per variable and month), with its
    ``tsd.forc`` station list and forcing cfg under *inpath*, and switch
    *inp* to it (``FORCING_MODE NETCDF``).  Returns the table the files
    hold (``cmfd_table``)."""
    import datetime
    import os

    from scipy.io import netcdf_file

    forc = inp.forc
    t_min, data = cmfd_table(forc, end_min)
    start = int(forc.start_yyyymmdd)
    day0 = datetime.date(start // 10000, start // 100 % 100, start % 100)
    temp_k = data[:, 1] + 273.15
    shum = (data[:, 2] * 100.0 * np.exp(17.67 * (temp_k - 273.15)
                                        / (temp_k - 29.65))
            / (0.263 * CMFD_PRES))
    values = {"PREC": data[:, 0], "TEMP": temp_k, "SHUM": shum,
              "SRAD": data[:, 4], "WIND": data[:, 3],
              "PRES": np.full(len(t_min), CMFD_PRES)}
    lon, lat = float(forc.lon[0]), float(forc.lat[0])
    os.makedirs(inpath, exist_ok=True)
    months = sorted({(day0 + datetime.timedelta(minutes=float(t)))
                     .strftime("%Y%m") for t in t_min})
    for yyyymm in months:
        first = datetime.date(int(yyyymm[:4]), int(yyyymm[4:]), 1)
        off = (first - day0).days * 1440.0
        nxt = datetime.date(first.year + first.month // 12,
                            first.month % 12 + 1, 1)
        sel = (t_min >= max(off, 0.0)) & (t_min < (nxt - day0).days * 1440.0)
        for key, name, units in CMFD_VARS:
            with netcdf_file(os.path.join(inpath, f"{name}_{yyyymm}.nc"),
                             "w") as f:
                f.createDimension("time", int(sel.sum()))
                f.createDimension("lat", 1)
                f.createDimension("lon", 1)
                tv = f.createVariable("time", "f8", ("time",))
                tv.units = f"hours since {day0.isoformat()} 00:00"
                tv[:] = t_min[sel] / 60.0
                f.createVariable("lat", "f8", ("lat",))[:] = [lat]
                f.createVariable("lon", "f8", ("lon",))[:] = [lon]
                v = f.createVariable(name, "f8", ("time", "lat", "lon"))
                v.units = units
                v[:] = values[key][sel][:, None, None]
    z = float(forc.xyz[0][2])
    prj = inp.paths.project
    with open(os.path.join(inpath, f"{prj}.tsd.forc"), "w") as f:
        f.write(f"1 {start}\n{inpath}\nID Lon Lat X Y Z Filename\n"
                f"1 {lon} {lat} 0 0 {z} netcdf\n")
    with open(os.path.join(inpath, "forcing.cfg"), "w") as f:
        f.write("PRODUCT CMFD2\n"
                f"DATA_ROOT {inpath}\n"
                "LAYOUT_FILE_PATTERN {var_lower}_{yyyymm}.nc\n"
                + "".join(f"NC_VAR_{k} {n}\n" for k, n, _ in CMFD_VARS))
    inp.paths.inpath = inpath
    inp.control.forcing_mode = "NETCDF"
    inp.control.forcing_cfg = "forcing.cfg"
    return t_min, data


def solver_kernel_cases(n: int, dtype, device, seed: int = 0) -> list:
    """One call of each solver kernel (``shud_tpu_torch/solver/kernels``)
    per case, on state-sized inputs made with numpy from *seed*: a list of
    ``SolverCase``.  ``case.prepare(kernel)`` makes fresh inputs and
    returns ``(call, outputs, library)``: ``call()`` runs the wrapper
    (*kernel* True) or its plain version once on them, ``outputs()`` gives
    every output, ``library()`` is one PyTorch call computing the same
    function on the same inputs where there is one (the matvec and
    Gram-Schmidt updates: ``torch.addcmul``), else None;
    ``case.run(kernel)`` calls and returns the outputs.  S1 on orders 1-3 with the
    history predictor on and off, S2 in its three modes, S3's first
    vector, a column, a breakdown column, a zero beta and the last
    column's solve (every m = 1..8; at m = 5 also with a breakdown and
    without the norms), S2 and S3 also on views one entry into their
    allocations (not 16-byte aligned: the one-entry form), S4's Newton
    tail above and below the tolerance and its step end accepted,
    rejected, not converged and at h_min.  "newton_update" runs S2 and S3
    through a whole Newton update (a diagonal J, m = 3).  ``vectors``: the
    state-sized vectors a call reads and writes (each once), ``ops`` its
    operations an entry."""
    import torch

    from shud_tpu_torch.solver import bdf
    from shud_tpu_torch.solver import kernels as K

    def vec(rng, lo=None, hi=None, scale=1.0):
        a = (rng.uniform(lo, hi, n) if lo is not None
             else scale * rng.standard_normal(n))
        return torch.as_tensor(a, device=device).to(dtype)

    def sc(v, dt=None):
        return torch.tensor(v, dtype=dt or dtype, device=device)

    def shifted(t):
        """*t* in a view one entry into a larger allocation: not 16-byte
        aligned, so S2 and S3 take one entry a thread."""
        out = torch.empty(n + 1, dtype=dtype, device=device)[1:]
        out.copy_(t)
        return out

    def carry(rng, order, h=0.73, tout=20.0):
        y = vec(rng, 0.0, 2.0)
        yp = y + vec(rng, scale=1e-3)
        yp2 = yp + vec(rng, scale=1e-3)
        i64 = torch.int64
        c = bdf.Carry(t=sc(700.25), h=sc(h), h_prev=sc(0.5), h_prev2=sc(0.31),
                      order=sc(order, i64), nfe=sc(40, i64),
                      nsteps=sc(9, i64), nfails=sc(1, i64),
                      nnifails=sc(0, i64), nni=sc(18, i64), y=y, y_prev=yp,
                      y_prev2=yp2, quad={})
        return c, sc(700.25 + tout)

    def cfg_of(history=True, max_order=2, m=3):
        return bdf.SolverConfig(max_order=max_order, history_predictor=history,
                                krylov_m=m)

    cases = []

    def begin_case(history, max_order, order, tout):
        def prepare(kernel):
            rng = np.random.default_rng(seed)
            cfg = cfg_of(history, max_order)
            c, t_out = carry(rng, order, tout=tout)
            fy0 = None if K.history(cfg) else vec(rng, scale=1e-3)
            s = K.Scratch(c.y, cfg.krylov_m)
            fn = K.bdf_begin if kernel else K.bdf_begin_plain
            return (lambda: fn(s, c, t_out, cfg, fy0),
                    lambda: {"ewt": s.ewt, "y_pred": s.y_pred, "c0": s.c0,
                             "scal": s.scal, "it": s.it}, None)
        return prepare

    for history, max_order in ((True, 2), (False, 2), (False, 3)):
        for order in range(1, max_order + 1):
            for tout in (20.0, 0.2):
                cases.append(SolverCase(
                    "bdf_begin", f"history={history} max_order={max_order} "
                    f"order={order} tout=+{tout}",
                    begin_case(history, max_order, order, tout),
                    6 if history else 7, 12 if max_order < 3 else 30))

    def axpy_case(mode, offset=False):
        def prepare(kernel):
            rng = np.random.default_rng(seed + 1)
            x, y, z = vec(rng), vec(rng), vec(rng)
            if offset:
                x, y, z = shifted(x), shifted(y), shifted(z)
            k = sc(float(rng.uniform(0.1, 3.0)))
            out = y if mode == K.GRAM_SCHMIDT else torch.empty_like(x)
            fn = K.krylov_axpy if kernel else K.krylov_axpy_plain
            zz = z if mode == K.RESIDUAL else None
            return (lambda: fn(mode, k, x, y, out, zz),
                    lambda: {"out": out},
                    {K.MATVEC: lambda: torch.addcmul(x, k, y, value=-1),
                     K.GRAM_SCHMIDT: lambda: torch.addcmul(y, k, x, value=-1)
                     }.get(mode))
        return prepare

    for mode, label in ((K.RESIDUAL, "residual"), (K.MATVEC, "matvec"),
                        (K.GRAM_SCHMIDT, "gram_schmidt")):
        for offset in (False, True):
            cases.append(SolverCase(
                "krylov_axpy", label + (", offset" if offset else ""),
                axpy_case(mode, offset), 4 if mode == K.RESIDUAL else 3,
                4 if mode == K.RESIDUAL else 3))

    def column_case(mode, j, m, zero_beta=False, breakdown=None,
                    norms=True, offset=False):
        def prepare(kernel):
            rng = np.random.default_rng(seed + 2)
            s = K.Scratch(vec(rng), m)
            s.w.copy_(vec(rng))
            for v in s.vs:
                v.copy_(vec(rng))
            s.ewt.copy_(vec(rng, 10.0, 1e3))
            s.y_pred.copy_(vec(rng, 0.0, 2.0))
            y = vec(rng, 0.0, 2.0)
            if offset:
                s.w, y = shifted(s.w), shifted(y)
                s.vs = [shifted(v) for v in s.vs]
            dots = [0.0 if zero_beta else float(rng.uniform(0.5, 2.0)) ** 2]
            for col in range(m):
                w0 = float(rng.uniform(1.0, 2.0))
                wn = (0.1 * s.tol * w0 if col == breakdown
                      else float(rng.uniform(0.1, 0.9)) * w0)
                dots += ([w0 * w0] + list(rng.standard_normal(col + 1))
                         + [wn * wn])
            dots = [sc(d) for d in dots]
            y_out = shifted(y) if offset else torch.empty_like(y)
            fn = K.krylov_column if kernel else K.krylov_column_plain

            def outputs():
                out = {"vs": torch.stack(s.vs), "scal": s.scal}
                if mode == K.LAST:
                    out.update(y_out=y_out, sq0=s.sq[0], sq1=s.sq[1])
                return out
            return (lambda: fn(s, mode, j, dots, y, y_out, norms), outputs,
                    None)
        return prepare

    last = 2 * 3 + 10  # the last column's x, y + dy and the norms' terms
    cases += [
        SolverCase("krylov_column", "first", column_case(K.FIRST, 0, 3), 2,
                   1),
        SolverCase("krylov_column", "first, beta 0",
                   column_case(K.FIRST, 0, 3, zero_beta=True), 2, 1),
        SolverCase("krylov_column", "column 1", column_case(K.COLUMN, 1, 3),
                   2, 1),
        SolverCase("krylov_column", "column 0, breakdown",
                   column_case(K.COLUMN, 0, 3, breakdown=0), 2, 1),
        SolverCase("krylov_column", "last, m 3", column_case(K.LAST, 2, 3),
                   3 + 6, last),
        SolverCase("krylov_column", "last, m 5, breakdown at 3",
                   column_case(K.LAST, 4, 5, breakdown=3), 5 + 6, last + 4),
        SolverCase("krylov_column", "last, m 5, no norms",
                   column_case(K.LAST, 4, 5, norms=False), 5 + 2, 10),
        SolverCase("krylov_column", "last, beta 0",
                   column_case(K.LAST, 2, 3, zero_beta=True), 3 + 6, last),
        SolverCase("krylov_column", "first, offset",
                   column_case(K.FIRST, 0, 3, offset=True), 2, 1),
        SolverCase("krylov_column", "column 1, offset",
                   column_case(K.COLUMN, 1, 3, offset=True), 2, 1),
        SolverCase("krylov_column", "last, m 3, offset",
                   column_case(K.LAST, 2, 3, offset=True), 3 + 6, last),
    ]
    # the last column of every Krylov dimension the kernel instantiates
    cases += [SolverCase("krylov_column", f"last, m {m}",
                         column_case(K.LAST, m - 1, m), m + 6, 2 * m + 10)
              for m in range(1, K.MAX_KRYLOV + 1) if m != 3]

    def finish_case(mode, dnorm, err, h=0.73, it=2):
        def prepare(kernel):
            rng = np.random.default_rng(seed + 3)
            cfg = cfg_of()
            c, tout = carry(rng, 2, h=h)
            s = K.Scratch(c.y, cfg.krylov_m)
            s.y.copy_(c.y + vec(rng, scale=1e-3))
            s.h.fill_(h)
            s.t_new.copy_(c.t + s.h)
            s.dnorm.fill_(dnorm)
            s.it.fill_(it)
            total = sc((2.0 * err) ** 2 * n)
            go = torch.ones((), dtype=torch.bool, device=device)
            nsteps0 = sc(3, torch.int64)
            fn = K.bdf_finish if kernel else K.bdf_finish_plain
            return (lambda: fn(s, mode, cfg, total, c, tout, nsteps0, go),
                    lambda: {"scal": s.scal, "it": s.it, "more": s.more,
                             "accept": s.accept, "active": go,
                             **{k: getattr(c, k)
                                for k in bdf.STEPS + bdf.COUNTS},
                             "y": c.y, "y_prev": c.y_prev,
                             "y_prev2": c.y_prev2}, None)
        return prepare

    cases += [
        SolverCase("bdf_finish", "newton, above the tolerance",
                   finish_case(K.NEWTON, 0.0, 0.83), 0, 0),
        SolverCase("bdf_finish", "newton, below",
                   finish_case(K.NEWTON, 0.0, 0.07), 0, 0),
        SolverCase("bdf_finish", "step, accepted",
                   finish_case(K.STEP, 0.1, 0.37), 7, 3),
        SolverCase("bdf_finish", "step, rejected",
                   finish_case(K.STEP, 0.1, 3.7), 7, 3),
        SolverCase("bdf_finish", "step, not converged",
                   finish_case(K.STEP, 0.9, 0.37, it=3), 7, 3),
        SolverCase("bdf_finish", "step, at h_min",
                   finish_case(K.STEP, 0.1, 37.0, h=1e-6), 7, 3),
    ]

    def update_case(kernel):
        rng = np.random.default_rng(seed + 4)
        s = K.Scratch(vec(rng), 3)
        d = vec(rng, 0.5, 2.0)
        y, fy, c0 = vec(rng, 0.0, 2.0), vec(rng, scale=1e-3), vec(rng, 0, 2)
        s.ewt.copy_(vec(rng, 10.0, 1e3))
        s.y_pred.copy_(c0)
        return (lambda: K.newton_update(s, lambda v: d * v, y, fy, c0,
                                        sc(0.37), s.y, plain=not kernel),
                lambda: {"vs": torch.stack(s.vs), "w": s.w, "y": s.y,
                         "sq0": s.sq[0], "sq1": s.sq[1], "scal": s.scal},
                None)

    cases.append(SolverCase("newton_update", "diagonal J, m 3", update_case,
                            0, 0))
    return cases


@dataclasses.dataclass
class SolverCase:
    """A case of ``solver_kernel_cases``."""

    name: str
    label: str
    prepare: object
    vectors: int
    ops: int

    def run(self, kernel: bool) -> dict:
        call, outputs, _ = self.prepare(kernel)
        call()
        return outputs()
