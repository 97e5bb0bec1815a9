"""Host-side modules of the port against the JAX package's.

The port carries its own copies of the numpy host modules (mesh builder,
project I/O, forcing tables), because the GPU host has no JAX; these tests
pin the copies to the originals, and check that the port imports and runs
with JAX made unimportable.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
torch.set_num_threads(1)

from torch_variants import VARIANTS, make_project, meshes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return tuple(a) == tuple(b)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_build_mesh_matches(variant):
    import dataclasses

    md_j, md_t, _ = meshes(variant)
    names_j = [f.name for f in dataclasses.fields(md_j)]
    names_t = [f.name for f in dataclasses.fields(md_t)]
    assert names_j == names_t
    for name in names_j:
        assert _equal(getattr(md_j, name), getattr(md_t, name)), name


@pytest.mark.parametrize("variant", ("plain", "rcm"))
def test_build_forcing_matches(variant):
    from shud_tpu.core.mesh import build_mesh as jax_build
    from shud_tpu.driver.forcing import build_forcing as jax_forcing
    from shud_tpu_torch.core.mesh import build_mesh as torch_build
    from shud_tpu_torch.driver.forcing import build_forcing as torch_forcing

    jinp = make_project("jax", variant)
    tinp = make_project("torch", variant)
    fj = jax_forcing(jinp, jax_build(jinp))
    ft = torch_forcing(tinp, torch_build(tinp))
    for name in ("t_axis", "fvals", "lai_t", "lai_vals", "mf_t", "mf_vals",
                 "station_z"):
        np.testing.assert_array_equal(np.asarray(getattr(fj, name)),
                                      np.asarray(getattr(ft, name)), name)
    # solar samples: numpy on the host vs jnp on the CPU device
    for name in ("tsr_sx", "tsr_sy", "tsr_sz", "tsr_wdt", "tsr_den"):
        np.testing.assert_allclose(np.asarray(getattr(ft, name)),
                                   np.asarray(getattr(fj, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    for a, b in zip(fj.cal, ft.cal):
        assert float(a) == float(b.item())
    for name in ("terrain_radiation", "swnet_mode", "rad_factor_cap",
                 "rad_cosz_min", "et_mode"):
        assert getattr(fj, name) == getattr(ft, name), name


def test_port_runs_without_jax():
    """Every module of shud_tpu_torch imports with ``jax`` unimportable and
    without loading shud_tpu, and one RHS evaluation runs."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import torch
        import shud_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            shud_tpu_torch.__path__, "shud_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not any(k == "shud_tpu" or k.startswith("shud_tpu.")
                       for k in sys.modules), "shud_tpu was imported"
        from shud_tpu_torch.core.device import to_torch
        from shud_tpu_torch.core.mesh import build_mesh
        from shud_tpu_torch.core.rhs import rhs
        from shud_tpu_torch.core.state import ForcingSlice
        from shud_tpu_torch.driver.init import initial_state
        from shud_tpu_torch.utils.synthetic import make_synthetic_project
        inp = make_synthetic_project(6, 4)
        md = build_mesh(inp)
        dm = to_torch(md, torch.float64, "cpu")
        ne, nr = md.num_ele, md.num_riv
        z = torch.zeros(ne, dtype=torch.float64)
        fs = ForcingSlice(z, z, z, z, z, z + 2.0, z + 1.0, z + 1.0, z, z, z,
                          torch.zeros(nr, dtype=torch.float64),
                          torch.zeros(nr, dtype=torch.float64))
        y = torch.tensor(initial_state(inp, md), dtype=torch.float64)
        dy = rhs(dm, fs, 0.0, y)
        assert dy.shape == y.shape and bool(torch.isfinite(dy).all())
        print("modules", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "modules" in out.stdout


def test_port_sources_import_no_jax():
    """No source file of the port names jax or the JAX package in an
    import statement."""
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import shud_tpu\b(?!_torch)"
                     r"|from shud_tpu\.)", re.M)
    root = os.path.join(REPO, "shud_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert not pat.search(fh.read()), os.path.join(d, f)


def test_netcdf_forcing_refused(tmp_path, monkeypatch):
    """NetCDF forcing is read since it was ported (tests/test_torch_netcdf.py
    holds it against the JAX package's); what it cannot read is refused: a
    project without its station list, and a NetCDF-4 file where h5py is
    absent, with a message that names h5py."""
    from shud_tpu_torch.io.project import FilePaths, _read_forc_netcdf

    paths = FilePaths(project="x", inpath=str(tmp_path),
                      outpath=str(tmp_path))
    cs = make_project("torch", "plain").control
    cs.forcing_cfg = "forcing.cfg"
    with pytest.raises(FileNotFoundError):
        _read_forc_netcdf(paths, cs)
    (tmp_path / "x.tsd.forc").write_text(
        "1 20000101\n\nID Lon Lat X Y Z\n1 -122.4 39.4 0 0 100 netcdf\n")
    (tmp_path / "forcing.cfg").write_text(
        f"PRODUCT CMFD2\nDATA_ROOT {tmp_path}\n"
        "LAYOUT_FILE_PATTERN {var_lower}_{yyyymm}.nc\n"
        + "".join(f"NC_VAR_{k} {k.lower()}\n"
                  for k in ("PREC", "TEMP", "SHUM", "SRAD", "WIND", "PRES")))
    (tmp_path / "prec_200001.nc").write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        _read_forc_netcdf(paths, cs)
