# Copied verbatim from shud_tpu/io/output.py; only the package imports differ.
"""Output engine: the reference's Print_Ctrl contract.

Writes the legacy binary ``.dat`` format the rSHUD R toolchain reads
(``src/classes/Model_Control.cpp:664-962``):

* 1024-byte text header, then ``StartTime``, ``NumVar``, the 1-based column
  ids (all as f64), then records ``[t, v_0..v_{n-1}]`` as f64;
* interval-mean semantics: each ``push`` accumulates the live values; at
  ``floor(t + eps) % interval == 0`` the mean is scaled by ``tau``
  (1440 for fluxes -> per-day units, 1 for states) and written with a
  **left-endpoint** timestamp ``t_floor - interval``;
* optional ASCII ``.csv`` mirror.

Also the restart writer (``PrintInit``, MD_update.cpp:268-299), the flood
alert log (FloodAlert.cpp) and the ``time.csv`` progress log.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

OUTPUT_TRIGGER_EPSILON = 0.001


# -f CLI flag (reference global_fflush_mode, CommandIn.cpp:31-33): flush
# every output record to disk as it is written (crash-durable outputs)
FFLUSH_MODE = False


class PrintCtrl:
    def __init__(
        self,
        path_base: str,
        start_yyyymmdd: int,
        interval: int,
        is_flux: bool,
        num_all: int,
        selected: np.ndarray | None = None,
        binary: bool = True,
        ascii_: bool = False,
        header_note: str = "",
    ):
        self.interval = int(interval)
        self.tau = 1440.0 if is_flux else 1.0
        if selected is None:
            selected = np.arange(num_all)
        self.selected = np.asarray(selected, dtype=np.int64)
        self.nvar = len(self.selected)
        self.buffer = np.zeros(self.nvar)
        self.num_update = 0
        self.binary = binary
        self.ascii = ascii_
        self.fb = None
        self.fa = None
        self.path_base = path_base
        os.makedirs(os.path.dirname(path_base), exist_ok=True)
        if binary:
            self.fb = open(path_base + ".dat", "wb")
            header = (
                "# SHUD output\n" + header_note
            ).encode()[:1024]
            self.fb.write(header + b"\x00" * (1024 - len(header)))
            self.fb.write(struct.pack("<d", float(start_yyyymmdd)))
            self.fb.write(struct.pack("<d", float(self.nvar)))
            self.fb.write(
                np.asarray(self.selected + 1, dtype=np.float64).tobytes()
            )
        if ascii_:
            self.fa = open(path_base + ".csv", "w")
            self.fa.write("# Timestamp semantics: left endpoint (t-Interval)\n")
            self.fa.write(f"0\t {self.nvar}\t {start_yyyymmdd}\n")
            self.fa.write(
                "Time_min"
                + "".join(f" \tX{i+1}" for i in range(self.nvar))
                + "\n"
            )

    def push(self, t: float, values: np.ndarray) -> None:
        """Accumulate and possibly emit (Print_Ctrl::PrintData)."""
        self.num_update += 1
        self.buffer += np.asarray(values)[self.selected]
        t_floor = int(math.floor(t + OUTPUT_TRIGGER_EPSILON))
        if t_floor % self.interval == 0:
            out = self.buffer * (self.tau / self.num_update)
            t_q = float(t_floor - self.interval)
            if self.fb is not None:
                self.fb.write(struct.pack("<d", t_q))
                self.fb.write(out.astype(np.float64).tobytes())
            if self.fa is not None:
                self.fa.write(
                    f"{t_q:.1f}\t"
                    + "\t".join(f"{v:e}" for v in out)
                    + "\t\n"
                )
            if FFLUSH_MODE:
                if self.fb is not None:
                    self.fb.flush()
                if self.fa is not None:
                    self.fa.flush()
            self.buffer[:] = 0.0
            self.num_update = 0

    def close(self):
        if self.fb is not None:
            self.fb.close()
            self.fb = None
        if self.fa is not None:
            self.fa.close()
            self.fa = None


def read_dat(path: str):
    """Read a legacy .dat file -> (start_yyyymmdd, col_ids, t[*], data[*, n])."""
    with open(path, "rb") as f:
        f.seek(1024)
        start = struct.unpack("<d", f.read(8))[0]
        nvar = int(struct.unpack("<d", f.read(8))[0])
        cols = np.frombuffer(f.read(8 * nvar), dtype=np.float64)
        rest = np.frombuffer(f.read(), dtype=np.float64)
    nrec = len(rest) // (nvar + 1)
    rest = rest[: nrec * (nvar + 1)].reshape(nrec, nvar + 1)
    return int(start), cols.astype(int), rest[:, 0], rest[:, 1:]


def write_restart(
    path: str,
    t: float,
    canopy: np.ndarray,
    snow: np.ndarray,
    surf: np.ndarray,
    unsat: np.ndarray,
    gw: np.ndarray,
    riv_stage: np.ndarray,
    lake_stage: np.ndarray | None = None,
) -> None:
    """Restart snapshot in the reference's .cfg.ic format (PrintInit)."""
    ne = len(canopy)
    nr = len(riv_stage)
    with open(path, "w") as f:
        f.write(f"{ne}\t {6} \t{t:f}\n")
        f.write("Index\tCanopy\tSnow\tSurface\tUnsat\tGW\n")
        for i in range(ne):
            f.write(
                f"{i+1}\t{canopy[i]:f}\t{snow[i]:f}\t{surf[i]:f}"
                f"\t{unsat[i]:f}\t{gw[i]:f}\n"
            )
        f.write(f"{nr}\t{2}\n")
        f.write("Index\tStage\n")
        for i in range(nr):
            f.write(f"{i+1}\t{riv_stage[i]:f}\n")
        if lake_stage is not None and len(lake_stage) > 0:
            f.write(f"{len(lake_stage)}\t{2}\n")
            f.write("Index\tLakeStage\n")
            for i in range(len(lake_stage)):
                f.write(f"{i+1}\t{lake_stage[i]:f}\n")


class FloodAlert:
    """Stage-over-bankfull event log (FloodAlert.cpp:115-131)."""

    def __init__(self, path: str, bankfull_depth: np.ndarray):
        self.path = path
        self.depth = np.asarray(bankfull_depth)
        self.fp = open(path, "w")
        self.fp.write("Time_min,RivID,Type,Stage,Bankfull,Qdown\n")

    def check(self, t: float, stage: np.ndarray, qdown: np.ndarray,
              riv_type: np.ndarray | None = None):
        over = np.where(stage > self.depth)[0]
        for i in over:
            ty = int(riv_type[i]) if riv_type is not None else 0
            self.fp.write(
                f"{t:.1f},{i+1},{ty},{stage[i]:.4f},{self.depth[i]:.4f},"
                f"{qdown[i]:.4f}\n"
            )

    def close(self):
        self.fp.close()


class TimeLog:
    """Progress log (prj.time.csv; IO.cpp:193-197)."""

    def __init__(self, path: str):
        self.fp = open(path, "w")
        self.fp.write(
            "time_Minutes \t Time_Days \t Task_perc \t CPUTime_s \t "
            "WallTime_s \t Num_fcall \n"
        )

    def write(self, t, perc, cpu_s, wall_s, nfcall):
        self.fp.write(
            f"{t:.1f}\t{t/1440.0:.3f}\t{perc:.2f}\t{cpu_s:.2f}\t"
            f"{wall_s:.2f}\t{int(nfcall)}\n"
        )
        self.fp.flush()

    def close(self):
        self.fp.close()
