"""The port's NetCDF layer against the JAX package's.

Forcing: the CMFD2, ERA5 and GLDAS round trips of tests/test_netcdf.py
(NetCDF-4 through h5py) and a CMFD2 set in NetCDF-3 (scipy): the port's
``load_netcdf_forcing`` equals JAX's bitwise on the same files, and the
project loader's ``_read_forc_netcdf`` returns the table the files were
written from; a fused run on it equals the run on that table as CSV.
A NetCDF-4 file without h5py raises a message that names it.
Output: a 6x4 fused run with ``OUTPUT_MODE BOTH`` (a lake mesh, a CRS WKT)
writes ``.ele.nc``/``.riv.nc``/``.lak.nc`` whose datasets equal JAX's
within rtol 1e-9 (f64); without h5py ``OUTPUT_MODE NETCDF`` is refused
before anything is solved or written.
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

torch.set_num_threads(1)

from shud_tpu.io import ncforcing as JNC  # noqa: E402
from shud_tpu.io import project as JP  # noqa: E402
from shud_tpu_torch.io import ncforcing as TNC  # noqa: E402
from shud_tpu_torch.io import project as TP  # noqa: E402
from torch_variants import make_project, write_cmfd_netcdf3  # noqa: E402

LAT = np.linspace(39.0, 40.0, 3)
LON = np.linspace(-123.0, -122.0, 4)


def _scales(f, t_hours, lat, lon):
    t = f.create_dataset("time", data=np.asarray(t_hours, dtype="f8"))
    t.attrs["units"] = "hours since 2000-01-01 00:00"
    t.make_scale("time")
    la = f.create_dataset("lat", data=lat)
    la.make_scale("lat")
    lo = f.create_dataset("lon", data=lon)
    lo.make_scale("lon")
    return t, la, lo


def _var(f, scales, name, data, units=None):
    v = f.create_dataset(name, data=data)
    if units:
        v.attrs["units"] = units
    for d, s in enumerate(scales[:data.ndim]):
        v.dims[d].attach_scale(s)


def _cfg(tmp_path, product, pattern, names):
    cfg = tmp_path / "input" / "prj" / "forcing.cfg"
    cfg.parent.mkdir(parents=True, exist_ok=True)
    cfg.write_text(f"PRODUCT {product}\nDATA_ROOT {tmp_path}\n"
                   f"LAYOUT_FILE_PATTERN {pattern}\n"
                   + "".join(f"NC_VAR_{k} {v}\n" for k, v in names.items()))
    return str(cfg)


def _cmfd(tmp_path):
    rng = np.random.default_rng(0)
    shape = (8, 3, 4)
    fields = {
        "prec": (rng.uniform(0, 2e-4, shape), "kg m-2 s-1"),
        "temp": (rng.uniform(270, 290, shape), "K"),
        "shum": (rng.uniform(0.001, 0.01, shape), "kg/kg"),
        "srad": (rng.uniform(0, 600, shape), "W m-2"),
        "wind": (rng.uniform(0, 8, shape), "m s-1"),
        "pres": (rng.uniform(8e4, 1e5, shape), "Pa"),
    }
    for name, (data, units) in fields.items():
        with h5py.File(tmp_path / f"{name}_200001.nc", "w") as f:
            _var(f, _scales(f, np.arange(8) * 3.0, LAT, LON), name, data,
                 units)
    return _cfg(tmp_path, "CMFD2", "{var_lower}_{yyyymm}.nc",
                {k.upper(): k for k in fields}), [[-122.4, 39.4, 100.0]]


def _era5(tmp_path):
    nt = 24
    rng = np.random.default_rng(1)
    ones = np.ones((1, 2, 2))
    fields = {
        "t2m": np.full((nt, 2, 2), 283.15), "d2m": np.full((nt, 2, 2), 278.15),
        "u10": np.full((nt, 2, 2), 3.0), "v10": np.full((nt, 2, 2), 4.0),
        "tp": np.cumsum(rng.uniform(0, 2e-4, nt))[:, None, None] * ones,
        "ssr": np.cumsum(rng.uniform(0, 2e6, nt))[:, None, None] * ones,
    }
    with h5py.File(tmp_path / "era5_20000101.nc", "w") as f:
        scales = _scales(f, np.arange(nt, dtype=float), np.array([39.0, 40.0]),
                         np.array([-123.0, -122.0]))
        for name, data in fields.items():
            _var(f, scales[:1], name, data)
    return _cfg(tmp_path, "ERA5", "era5_{yyyymmdd}.nc",
                {k.upper(): k for k in fields}), [[-122.5, 39.5, -9999.0]]


def _gldas(tmp_path):
    rng = np.random.default_rng(2)
    names = {"PREC": "Rainf_f_tavg", "TEMP": "Tair_f_inst",
             "SHUM": "Qair_f_inst", "SRAD": "SWdown_f_tavg",
             "WIND": "Wind_f_inst", "PRES": "Psurf_f_inst"}
    lo_hi = {"PREC": (0, 2e-4), "TEMP": (260, 290), "SHUM": (0.001, 0.01),
             "SRAD": (0, 900), "WIND": (0, 9), "PRES": (8e4, 1e5)}
    (tmp_path / "2000" / "001").mkdir(parents=True)
    for step in range(8):
        path = (tmp_path / "2000" / "001"
                / f"GLDAS_NOAH025_3H.A20000101.{step * 3:02d}00.021.nc4")
        with h5py.File(path, "w") as f:
            scales = _scales(f, [step * 3.0], LAT, LON)
            for key, name in names.items():
                _var(f, scales, name, rng.uniform(*lo_hi[key], (1, 3, 4)))
    return _cfg(tmp_path, "GLDAS",
                "{year}/{doy}/GLDAS_NOAH025_3H.A{yyyymmdd}.{hhmm}.021.nc4",
                names), [[-122.4, 39.4, 100.0], [-122.9, 39.9, 450.0]]


def _cmfd3(tmp_path):
    """A CMFD2 set in NetCDF-3 (scipy), precipitation in mm/hr."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(3)
    names = {"PREC": "prec", "TEMP": "temp", "SHUM": "shum", "SRAD": "srad",
             "WIND": "wind", "PRES": "pres"}
    lo_hi = {"PREC": (0, 5), "TEMP": (270, 290), "SHUM": (0.001, 0.01),
             "SRAD": (0, 600), "WIND": (0, 8), "PRES": (8e4, 1e5)}
    for key, name in names.items():
        with netcdf_file(str(tmp_path / f"{name}_200001.nc"), "w") as f:
            for d, n in (("time", 8), ("lat", 3), ("lon", 4)):
                f.createDimension(d, n)
            t = f.createVariable("time", "f8", ("time",))
            t.units = "hours since 2000-01-01 00:00"
            t[:] = np.arange(8) * 3.0
            f.createVariable("lat", "f8", ("lat",))[:] = LAT
            f.createVariable("lon", "f8", ("lon",))[:] = LON
            v = f.createVariable(name, "f8", ("time", "lat", "lon"))
            v.units = "mm/hr" if key == "PREC" else "1"
            v[:] = rng.uniform(*lo_hi[key], (8, 3, 4))
    return _cfg(tmp_path, "CMFD2", "{var_lower}_{yyyymm}.nc",
                names), [[-122.4, 39.4, 100.0], [-122.9, 39.9, 450.0]]


def _same(a, b):
    """Two ForcingCSVs bitwise equal."""
    assert a.num_stations == b.num_stations
    assert a.start_yyyymmdd == b.start_yyyymmdd
    assert a.filenames == b.filenames
    for k in ("lon", "lat", "xyz"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert len(a.t_min) == len(b.t_min) == a.num_stations
    for x, y in zip(a.t_min + a.data, b.t_min + b.data):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("product", ("cmfd", "era5", "gldas", "cmfd3"))
def test_forcing_matches_jax_bitwise(tmp_path, product):
    cfg, stations = {"cmfd": _cmfd, "era5": _era5, "gldas": _gldas,
                     "cmfd3": _cmfd3}[product](tmp_path)
    args = (np.asarray(stations), 20000101, 0.0, 1440.0)
    fj = JNC.load_netcdf_forcing(cfg, *args)
    ft = TNC.load_netcdf_forcing(cfg, *args)
    _same(fj, ft)
    assert len(ft.t_min[0]) == {"era5": 24}.get(product, 8)
    assert np.isfinite(ft.data[0]).all() and ft.data[0].shape[1] == 5
    if product == "cmfd3":
        # mm/hr x 24 -> mm/day, quantised to 1e-4
        np.testing.assert_allclose(ft.t_min[0], np.arange(8) * 180.0)
        assert (ft.data[0][:, 0] >= 0).all() and ft.data[0][:, 0].max() > 1.0


def test_netcdf4_without_h5py_names_it(tmp_path, monkeypatch):
    from shud_tpu_torch.io.netcdf import NcDataset

    cfg, stations = _cmfd(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        NcDataset(str(tmp_path / "prec_200001.nc"))
    with pytest.raises(ImportError, match="h5py"):
        TNC.load_netcdf_forcing(cfg, np.asarray(stations), 20000101, 0.0,
                                1440.0)


def test_project_forcing_round_trip_and_run(tmp_path):
    """A synthetic project's forcing as a CMFD2 NetCDF-3 set: the project
    loader's _read_forc_netcdf (both packages) returns the table the files
    hold, and a fused f64 run forced from it is bitwise the run forced by
    that table as CSV."""
    from shud_tpu_torch.driver.fused import FusedSimulation

    inp = make_project("torch", "plain", 6, 4, 1.0)
    inp.forc.t_min = [t - 720.0 for t in inp.forc.t_min]
    t_min, data = write_cmfd_netcdf3(inp, str(tmp_path / "input"), 1440.0)
    assert t_min[0] == 0.0 and data[:, 0].max() > 0  # the storm is in it
    got = TP._read_forc_netcdf(inp.paths, inp.control)
    _same(JP._read_forc_netcdf(inp.paths, inp.control), got)
    np.testing.assert_array_equal(got.t_min[0], t_min)
    np.testing.assert_array_equal(got.data[0], data)

    csv = copy.deepcopy(inp)
    csv.forc.t_min, csv.forc.data = [t_min], [data]
    csv.control.forcing_mode = "CSV"
    nc = copy.deepcopy(inp)
    nc.forc = got
    sims = []
    for p in (csv, nc):
        p.control.day_start = 0.5
        sim = FusedSimulation.create("synthetic", inp=p, device="cpu")
        sim.advance_interval(30.0)
        sims.append(sim)
    a, b = sims
    assert a.bdf.nfe == b.bdf.nfe > 0
    assert torch.equal(a.bdf.y, b.bdf.y)
    assert float(a.bdf.y[:a.md.num_ele].max()) > 0  # the surface wetted


def _nc_project(pkg, tmp_path, mode):
    inp = make_project(pkg, "lake", 6, 4, 1.0)
    cs = inp.control
    for f in dataclasses.fields(cs):
        if f.name.startswith("dt_"):
            setattr(cs, f.name, 360)
    cs.output_mode = mode
    (tmp_path / "epsg.wkt").write_text('PROJCS["WGS 84 / UTM zone 10N"]')
    (tmp_path / "nc.cfg").write_text("CRS_WKT epsg.wkt\n")
    cs.ncoutput_cfg = str(tmp_path / "nc.cfg")
    return inp


def test_ugrid_output_matches_jax(tmp_path):
    from shud_tpu.driver.run_fast import run_project_fast as jax_run
    from shud_tpu_torch.driver.run_fast import run_project_fast as torch_run

    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_run("synthetic", inp=_nc_project("jax", tmp_path, "BOTH"),
            end_day=0.5, verbose=False, outpath=out_j)
    torch_run("synthetic", inp=_nc_project("torch", tmp_path, "BOTH"),
              end_day=0.5, verbose=False, outpath=out_t, device="cpu")
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t))
    ncs = [f for f in files if f.endswith(".nc")]
    assert ncs == ["synthetic.ele.nc", "synthetic.lak.nc", "synthetic.riv.nc"]
    assert any(f.endswith(".dat") for f in files)  # BOTH keeps the binaries
    for name in ncs:
        with h5py.File(os.path.join(out_j, name)) as fj, \
                h5py.File(os.path.join(out_t, name)) as ft:
            assert sorted(fj.keys()) == sorted(ft.keys()), name
            assert dict(fj.attrs) == dict(ft.attrs), name
            for k in fj.keys():
                a, b = fj[k][()], ft[k][()]
                assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
                assert dict(fj[k].attrs).keys() == dict(ft[k].attrs).keys()
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-15,
                                               err_msg=f"{name}:{k}")
                else:
                    np.testing.assert_array_equal(b, a, err_msg=k)
            assert ft["crs"].attrs["crs_wkt"].startswith("PROJCS")
        with h5py.File(os.path.join(out_t, name)) as ft:
            data = [k for k in ft.keys() if ft[k].ndim == 2
                    and k not in ("mesh_face_nodes",)]
            assert data and all(ft[k].shape[0] == 2 for k in data), name


def test_netcdf_output_without_h5py_refused(tmp_path, monkeypatch):
    from shud_tpu_torch.driver.run_fast import run_project_fast

    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="h5py"):
        run_project_fast("synthetic",
                         inp=_nc_project("torch", tmp_path, "NETCDF"),
                         end_day=0.5, verbose=False, outpath=str(out),
                         device="cpu")
    assert not out.exists()
