# Copied verbatim from shud_tpu/io/netcdf.py; only the package imports differ.
"""Minimal NetCDF reading layer.

Handles both NetCDF-4 (HDF5-based, via h5py) and classic NetCDF-3 (via
scipy.io.netcdf_file), with CF conventions the forcing products use:
``scale_factor``/``add_offset`` unpacking, ``_FillValue``/``missing_value``
masking, and ``<unit> since <date>`` time parsing.  (The reference links
netcdf-c; neither netCDF4-python nor xarray is available in this image.)
"""

from __future__ import annotations

import datetime
import glob as globmod
import os

import numpy as np


class NcVar:
    def __init__(self, data: np.ndarray, attrs: dict, dims: tuple):
        self.attrs = attrs
        self.dims = dims
        self._raw = data

    def __getitem__(self, key):
        raw = np.asarray(self._raw[key])
        out = raw.astype(np.float64) if raw.dtype.kind in "iuf" else raw
        fill = self.attrs.get("_FillValue", self.attrs.get("missing_value"))
        if fill is not None and out.dtype.kind == "f":
            out = np.where(raw == np.asarray(fill).ravel()[0], np.nan, out)
        scale = self.attrs.get("scale_factor")
        offset = self.attrs.get("add_offset")
        if scale is not None:
            out = out * np.asarray(scale).ravel()[0]
        if offset is not None:
            out = out + np.asarray(offset).ravel()[0]
        return out


class NcDataset:
    """Uniform {variables, dimensions} view over h5py / scipy backends."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic.startswith(b"\x89HDF"):
            import h5py

            self._h5 = h5py.File(path, "r")
            self._sp = None
        elif magic.startswith(b"CDF"):
            from scipy.io import netcdf_file

            self._sp = netcdf_file(path, "r", mmap=False)
            self._h5 = None
        else:
            raise ValueError(f"Not a NetCDF file: {path}")

    def variables(self):
        if self._h5 is not None:
            return list(self._h5.keys())
        return list(self._sp.variables.keys())

    def var(self, name: str) -> NcVar:
        if self._h5 is not None:
            ds = self._h5[name]
            attrs = {}
            for k, v in ds.attrs.items():
                if isinstance(v, bytes):
                    v = v.decode("utf-8", "ignore")
                attrs[k] = v
            dims = tuple(
                (d.label or f"dim{i}") for i, d in enumerate(ds.dims)
            )
            return NcVar(ds, attrs, dims)
        v = self._sp.variables[name]
        attrs = {}
        for k in dir(v):
            if k.startswith("_") and k != "_FillValue":
                continue
        attrs = {
            k: (vv.decode() if isinstance(vv, bytes) else vv)
            for k, vv in v._attributes.items()
        }
        return NcVar(v.data, attrs, tuple(v.dimensions))

    def close(self):
        if self._h5 is not None:
            self._h5.close()
        if self._sp is not None:
            self._sp.close()


_UNIT_MINUTES = {
    "days": 1440.0, "day": 1440.0, "d": 1440.0,
    "hours": 60.0, "hour": 60.0, "hr": 60.0, "h": 60.0,
    "minutes": 1.0, "minute": 1.0, "min": 1.0,
    "seconds": 1.0 / 60.0, "second": 1.0, "sec": 1.0 / 60.0,
    "s": 1.0 / 60.0,
}


def parse_time_units(units: str):
    """'<unit> since YYYY-MM-DD[ HH:MM[:SS]]' -> (base minutes since
    1970-01-01, factor to minutes).  Mirrors NetcdfForcingProvider.cpp:
    225-275."""
    u = units.strip()
    lo = u.lower()
    pos = lo.find("since")
    if pos < 0:
        raise ValueError(f"time units missing 'since': {units!r}")
    unit = lo[:pos].strip()
    base = u[pos + 5 :].strip()
    if unit not in _UNIT_MINUTES:
        raise ValueError(f"unsupported time unit {unit!r}")
    parts = base.split()
    ymd = parts[0]
    y, m, d = (int(x) for x in ymd.split("-")[:3])
    hh = mm = 0
    ss = 0.0
    if len(parts) > 1:
        tparts = parts[1].split(":")
        hh = int(tparts[0])
        if len(tparts) > 1:
            mm = int(tparts[1])
        if len(tparts) > 2:
            ss = float(tparts[2])
    epoch = datetime.datetime(1970, 1, 1)
    dt = datetime.datetime(y, m, d, hh, mm) - epoch
    base_min = dt.total_seconds() / 60.0 + ss / 60.0
    return base_min, _UNIT_MINUTES[unit]


def yyyymmdd_to_epoch_minutes(yyyymmdd: int) -> float:
    y, m, d = yyyymmdd // 10000, (yyyymmdd // 100) % 100, yyyymmdd % 100
    dt = datetime.datetime(y, m, d) - datetime.datetime(1970, 1, 1)
    return dt.total_seconds() / 60.0


def resolve_single_glob(pattern: str) -> str:
    if any(c in pattern for c in "*?["):
        hits = sorted(globmod.glob(pattern))
        if len(hits) != 1:
            raise FileNotFoundError(
                f"glob {pattern!r} matched {len(hits)} files (need exactly 1)"
            )
        return hits[0]
    if not os.path.exists(pattern):
        raise FileNotFoundError(pattern)
    return pattern
