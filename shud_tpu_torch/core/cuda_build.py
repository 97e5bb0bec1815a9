"""Build and load the port's CUDA kernels (``shud_tpu_torch/csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), and the objects are linked into one shared library
under ``build/``, named by the hash of all the sources and the flags, so
an unchanged tree reuses it.  The library has a plain C interface and is
loaded with ctypes with the argument types of every entry point set
(``load_library``).  Nothing here runs when a module is imported.
Processes that load it at once (the ranks of a sharded run) take turns
under a file lock, so one builds and the others find the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# --fmad=false: no multiply-add is fused, so each product and sum rounds
# as it does in the plain PyTorch versions (one CUDA kernel per operation)
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None
# path, seconds and ptxas report (registers, spills) of the last build
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def _run(cmd, what):
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"nvcc not found: {cmd[0]} ({what})") from exc


def _wait(proc, cmd) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(map(str, cmd))}\n{out}")
    return out


def _build(out: Path) -> str:
    """Compile every source in parallel, link, and move the library to
    *out*; returns nvcc's combined report."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, _run(cmd, src.name), obj))
        log = "".join(_wait(p, cmd) for cmd, p, _ in jobs)
        lib = Path(tmp) / out.name
        cmd = [_nvcc(), *_NVCC_FLAGS[:2], "-shared", "-o", str(lib),
               *(str(o) for *_, o in jobs)]
        log += _wait(_run(cmd, "link"), cmd)
        os.replace(lib, out)
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (once per source
    hash).  Raises with nvcc's output if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + src.read_bytes())
    out = _BUILD_DIR / f"libshud_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        log = "" if out.exists() else _build(out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.shud_edge_flux.argtypes = [p] * 16 + [i, i, p]
    lib.shud_edge_coeff.argtypes = [p] * 22 + [i, i, p]
    lib.shud_edge_apply.argtypes = [p] * 12 + [i, p]
    pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for name in ("shud_mega_rhs", "shud_mega_jvp", "shud_mega_diag"):
        getattr(lib, name).argtypes = [pp, ip, p]
    lib.shud_mega_occupancy.argtypes = [i, ip]
    lib.shud_mega_barrier_probe.argtypes = [i, i, p]
    for fn in (lib.shud_edge_flux, lib.shud_edge_coeff, lib.shud_edge_apply,
               lib.shud_mega_rhs, lib.shud_mega_jvp, lib.shud_mega_diag,
               lib.shud_mega_occupancy, lib.shud_mega_barrier_probe):
        fn.restype = ctypes.c_int
    lib.shud_mega_scratch_floats.argtypes = [i, i, i, i]
    lib.shud_mega_scratch_floats.restype = ctypes.c_longlong
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas=log)
    _LIB = lib
    return lib
