# Copied verbatim from shud_tpu/native/__init__.py; only the package imports differ.
"""ctypes bindings for the native preprocessing library (native/shudc.cpp).

Falls back to pure-Python implementations when the shared library has not
been built (``tools/build_native.sh``); the native path is required in
practice for 1M+-cell meshes where the sequential preprocessing passes
dominate setup time.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        path = os.path.join(os.path.dirname(__file__), "libshudc.so")
        if os.path.exists(path):
            lib = ctypes.CDLL(path)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.shud_rm_sinks.argtypes = [
                ctypes.c_int64, i64p, i64p, f64p, f64p, f64p,
            ]
            lib.shud_nabr_to_me.argtypes = [ctypes.c_int64, i64p, i64p]
            _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def rm_sinks(nabr: np.ndarray, riv_id: np.ndarray, aq_depth: np.ndarray,
             z_surf: np.ndarray, z_bottom: np.ndarray) -> None:
    """In-place sequential sink removal."""
    lib = _lib()
    ne = len(z_surf)
    if lib is not None:
        lib.shud_rm_sinks(
            ne,
            np.ascontiguousarray(nabr, np.int64),
            np.ascontiguousarray(riv_id, np.int64),
            np.ascontiguousarray(aq_depth, np.float64),
            z_surf, z_bottom,
        )
        return
    for i in range(ne):
        zmin_nb = np.inf
        for j in range(3):
            nb = nabr[i, j]
            if nb >= 0:
                zmin_nb = min(zmin_nb, z_surf[nb])
        if np.isfinite(zmin_nb) and zmin_nb > z_surf[i] and riv_id[i] <= 0:
            z_surf[i] = zmin_nb
            z_bottom[i] = zmin_nb - aq_depth[i]


def nabr_to_me(nabr: np.ndarray) -> np.ndarray:
    lib = _lib()
    ne = nabr.shape[0]
    if lib is not None:
        out = np.empty((ne, 3), dtype=np.int64)
        lib.shud_nabr_to_me(ne, np.ascontiguousarray(nabr, np.int64), out)
        return out
    out = np.full((ne, 3), -1, dtype=np.int64)
    for i in range(ne):
        for j in range(3):
            nb = nabr[i, j]
            if nb >= 0:
                for k in range(3):
                    if nabr[nb, k] == i:
                        out[i, j] = k
    return out
