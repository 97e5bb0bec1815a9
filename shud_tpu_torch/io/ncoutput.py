# Copied verbatim from shud_tpu/io/ncoutput.py; only the package imports differ.
"""NetCDF (UGRID) output sinks.

Equivalent of the reference's NetcdfOutputContext
(``src/classes/NetcdfOutputContext.cpp``): each Print_Ctrl channel can
mirror its records into a CF/UGRID-style NetCDF-4 file with dims
``time | mesh_face | mesh_node``, the mesh topology variables and per-record
appends.  Written through h5py using HDF5 dimension scales (the NetCDF-4
storage layer); enabled by ``OUTPUT_MODE NETCDF|BOTH``.
"""

from __future__ import annotations

import os

import numpy as np


def read_ncoutput_cfg(path: str) -> dict:
    """Key-value nc-output config (NetcdfOutputContext.cpp:1093-1125):
    recognised keys SCHEMA, OUT_DIR, CRS_WKT (path to a WKT text file,
    resolved relative to the directory holding the cfg)."""
    out = {}
    if not path or not os.path.exists(path):
        return out
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            out[parts[0].upper()] = parts[1].strip()
    wkt_path = out.get("CRS_WKT")
    if wkt_path:
        if not os.path.isabs(wkt_path):
            wkt_path = os.path.join(base, wkt_path)
        if os.path.exists(wkt_path):
            with open(wkt_path) as fh:
                out["CRS_WKT_TEXT"] = fh.read().strip()
    return out


class UgridSink:
    def __init__(self, path: str, md, kind: str, node_xyz=None,
                 face_nodes=None, start_yyyymmdd: int = 0,
                 crs_wkt: str = ""):
        import h5py

        self.f = h5py.File(path, "w")
        f = self.f
        f.attrs["Conventions"] = "CF-1.8 UGRID-1.0"
        f.attrs["source"] = "shud_tpu"
        f.attrs["start_yyyymmdd"] = start_yyyymmdd
        # CRS variable (NetcdfOutputContext.cpp:446-460): a scalar int
        # carrying the WKT as spatial_ref/crs_wkt attributes
        self.has_crs = bool(crs_wkt)
        if crs_wkt:
            crs = f.create_dataset("crs", data=np.int32(0))
            crs.attrs["long_name"] = "coordinate reference system"
            crs.attrs["spatial_ref"] = crs_wkt
            crs.attrs["crs_wkt"] = crs_wkt
        self.kind = kind
        n = {"ele": md.num_ele, "riv": md.num_riv,
             "lake": md.num_lake}[kind]
        self.n = n

        # dimensions (as HDF5 dimension scales)
        self.time_ds = f.create_dataset(
            "time", shape=(0,), maxshape=(None,), dtype="f8"
        )
        self.time_ds.attrs["units"] = "minutes since simulation start"
        self.time_ds.make_scale("time")

        dimname = {"ele": "mesh_face", "riv": "river_reach",
                   "lake": "lake"}[kind]
        self.entity = f.create_dataset(dimname, data=np.arange(n, dtype="i4"))
        self.entity.make_scale(dimname)

        if kind == "ele" and node_xyz is not None and face_nodes is not None:
            topo = f.create_dataset("mesh", data=np.int32(0))
            topo.attrs["cf_role"] = "mesh_topology"
            topo.attrs["topology_dimension"] = 2
            topo.attrs["node_coordinates"] = "mesh_node_x mesh_node_y"
            topo.attrs["face_node_connectivity"] = "mesh_face_nodes"
            f.create_dataset("mesh_node_x", data=node_xyz[:, 0])
            f.create_dataset("mesh_node_y", data=node_xyz[:, 1])
            f.create_dataset("mesh_node_z", data=node_xyz[:, 2])
            fn = f.create_dataset(
                "mesh_face_nodes", data=face_nodes.astype("i4")
            )
            fn.attrs["start_index"] = 1
            f.create_dataset("mesh_face_x", data=md.x)
            f.create_dataset("mesh_face_y", data=md.y)

        self.vars = {}

    def add_channel(self, name: str, units: str = ""):
        import h5py

        v = self.f.create_dataset(
            name, shape=(0, self.n), maxshape=(None, self.n), dtype="f8",
            chunks=(64, self.n),
        )
        if units:
            v.attrs["units"] = units
        if self.has_crs:
            v.attrs["grid_mapping"] = "crs"
        v.dims[0].attach_scale(self.time_ds)
        v.dims[1].attach_scale(self.entity)
        self.vars[name] = v
        return v

    def write(self, name: str, t: float, values: np.ndarray):
        v = self.vars[name]
        k = v.shape[0]
        if len(self.time_ds) <= k:
            self.time_ds.resize((k + 1,))
            self.time_ds[k] = t
        v.resize((k + 1, self.n))
        v[k] = values

    def close(self):
        self.f.close()
