# Copied verbatim from shud_tpu/io/project.py; only the package imports differ.
"""Project file registry, run-control config and calibration parsing.

Mirrors the reference's input conventions:
* path registry — ``src/classes/IO.cpp:51-92`` (``input/<prj>/<prj>.*`` →
  ``output/<prj>.out/``);
* ``.cfg.para`` keyword file — ``src/classes/Model_Control.cpp:141-671``;
* ``.cfg.calib`` global calibration scalars — ``src/classes/ModelConfigure.cpp``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from shud_tpu_torch.io.tables import read_table, read_tables

NA = -9999


# ---------------------------------------------------------------------------
# File path registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FilePaths:
    project: str
    inpath: str
    outpath: str
    # explicit per-file path overrides keyed by suffix ("sp.mesh", ...),
    # populated by read_project_file (-p; FileIn::readProject IO.cpp:208-292)
    overrides: dict = dataclasses.field(default_factory=dict)

    def infile(self, suffix: str) -> str:
        if suffix in self.overrides:
            return self.overrides[suffix]
        return os.path.join(self.inpath, f"{self.project}.{suffix}")

    def outfile(self, name: str) -> str:
        return os.path.join(self.outpath, f"{self.project}.{name}")

    @classmethod
    def from_project(cls, project: str, base: str = ".", outpath: str | None = None):
        inpath = os.path.join(base, "input", project)
        if outpath is None:
            outpath = os.path.join(base, "output", f"{project}.out")
        return cls(project=project, inpath=inpath, outpath=outpath)

    def save_project_file(self) -> str:
        """Write ``<prj>.SHUD`` — the run-provenance manifest listing every
        resolved input path (``FileIn::saveProject``, IO.cpp:3-45)."""
        os.makedirs(self.outpath, exist_ok=True)
        fn = os.path.join(self.outpath, f"{self.project}.SHUD")
        rows = [("PRJ", self.project), ("INPATH", self.inpath),
                ("OUTPATH", self.outpath),
                ("MESH", self.infile("sp.mesh")), ("ATT", self.infile("sp.att")),
                ("LAKE", self.infile("lake.bathy")),
                ("RIV", self.infile("sp.riv")),
                ("RIVSEG", self.infile("sp.rivseg")),
                ("CALIB", self.infile("cfg.calib")),
                ("PARA", self.infile("cfg.para")),
                ("INIT", self.infile("cfg.ic")),
                ("LC", self.infile("para.lc")),
                ("SOIL", self.infile("para.soil")),
                ("GEOL", self.infile("para.geol")),
                ("FORC", self.infile("tsd.forc")),
                ("LAI", self.infile("tsd.lai")), ("MF", self.infile("tsd.mf")),
                ("EleBC1", self.infile("tsd.ebc1")),
                ("EleBC2", self.infile("tsd.ebc2")),
                ("RivBC1", self.infile("tsd.rbc1")),
                ("RivBC2", self.infile("tsd.rbc2")),
                ("LakeBC1", self.infile("tsd.lbc1")),
                ("LakeBC2", self.infile("tsd.lbc2"))]
        with open(fn, "w") as f:
            for k, v in rows:
                f.write(f"{k} \t {v}\n")
        return fn


# .SHUD manifest key -> input-file suffix (FileIn::readProject IO.cpp:208)
_PROJECT_FILE_KEYS = {
    "MESH": "sp.mesh", "ATT": "sp.att", "LAKE": "lake.bathy",
    "RIV": "sp.riv", "RIVSEG": "sp.rivseg", "CALIB": "cfg.calib",
    "PARA": "cfg.para", "INIT": "cfg.ic", "LC": "para.lc",
    "SOIL": "para.soil", "GEOL": "para.geol", "FORC": "tsd.forc",
    "LAI": "tsd.lai", "MF": "tsd.mf", "ELEBC1": "tsd.ebc1",
    "ELEBC2": "tsd.ebc2", "RIVBC1": "tsd.rbc1", "RIVBC2": "tsd.rbc2",
    "LAKEBC1": "tsd.lbc1", "LAKEBC2": "tsd.lbc2",
}


def read_project_file(fn: str) -> FilePaths:
    """Parse a ``<prj>.SHUD`` project manifest (the ``-p`` CLI flag;
    ``FileIn::readProject`` IO.cpp:208-292): key/value lines naming the
    project, in/out paths, and optional explicit per-file paths."""
    project, inpath, outpath = None, None, None
    overrides: dict = {}
    with open(fn) as f:
        for ln in f:
            if not ln.strip() or ln[0] in "# ":
                continue
            parts = ln.split()
            if len(parts) < 2:
                continue
            key, val = parts[0].upper(), parts[1]
            if key == "PRJ":
                project = val
                inpath = inpath or os.path.join("input", val)
                outpath = outpath or os.path.join("output", f"{val}.out")
            elif key == "INPATH":
                inpath = val
            elif key == "OUTPATH":
                outpath = val
            elif key in _PROJECT_FILE_KEYS:
                overrides[_PROJECT_FILE_KEYS[key]] = val
    if project is None:
        raise ValueError(f"{fn}: no PRJ key")
    fp = FilePaths(project=project, inpath=inpath, outpath=outpath,
                   overrides=overrides)
    # drop overrides that just restate the naming convention
    fp.overrides = {
        s: p for s, p in overrides.items()
        if os.path.normpath(p) != os.path.normpath(
            os.path.join(inpath, f"{project}.{s}"))
    }
    return fp


# ---------------------------------------------------------------------------
# Run control (.cfg.para)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Control:
    """Defaults follow ``src/classes/Model_Control.hpp:154-219``."""

    verbose: int = 0
    close_boundary: int = 1
    ascii: int = 0
    binary: int = 1
    spinup: int = 0
    screen_intv: int = 1440
    num_threads: int = 0
    init_type: int = 3
    cryosphere: int = 0
    abstol: float = 1.0e-4
    reltol: float = 1.0e-3
    init_step: float = 1.0e-2  # [min]
    max_step: float = 30.0  # [min]
    update_ic_step: int = 1440
    et_step: float = 60.0  # [min]
    et_mode: int = 0
    exfiltration: int = 0
    day_start: float = 0.0
    day_end: float = 10.0
    forcing_mode: str = "CSV"  # CSV | NETCDF
    forcing_cfg: str = ""
    output_mode: str = "LEGACY"  # LEGACY | NETCDF | BOTH
    ncoutput_cfg: str = ""
    radiation_input_mode: int = 0  # 0 SWDOWN, 1 SWNET
    radiation_input_mode_user_set: bool = False
    solar_lonlat_mode: int = 0  # 0 FORCING_FIRST, 1 FORCING_MEAN, 2 FIXED
    solar_lon_deg_fixed: float = NA
    solar_lat_deg_fixed: float = NA
    solar_lon_deg: float = NA  # resolved at forcing load
    solar_lat_deg: float = NA
    terrain_radiation: int = 1
    rad_factor_cap: float = 5.0
    rad_cosz_min: float = 0.05
    tsr_integration_step_min: int = 60
    # per-variable output intervals [min]; default: only prcp & lake daily
    dt_ye_ic: int = 0
    dt_ye_snow: int = 0
    dt_ye_surf: int = 0
    dt_ye_unsat: int = 0
    dt_ye_gw: int = 0
    dt_qe_prcp: int = 1440
    dt_qe_infil: int = 0
    dt_qe_et: int = 0
    dt_qe_rech: int = 0
    dt_qe_etp: int = 0
    dt_qe_eta: int = 0
    dt_Qe_sub: int = 0
    dt_Qe_subx: int = 0
    dt_Qe_surf: int = 0
    dt_Qe_surfx: int = 0
    dt_Qe_rsub: int = 0
    dt_Qe_rsurf: int = 0
    dt_yr_stage: int = 0
    dt_Qr_up: int = 0
    dt_Qr_down: int = 0
    dt_Qr_sub: int = 0
    dt_Qr_surf: int = 0
    dt_lake: int = 1440

    # derived
    @property
    def start_time(self) -> float:
        return self.day_start * 1440.0

    @property
    def end_time(self) -> float:
        return self.day_end * 1440.0

    @property
    def solver_step(self) -> float:
        # reference: SolverStep = MaxStep (Model_Control.cpp:502)
        return self.max_step

    @property
    def num_steps(self) -> int:
        return int((self.end_time - self.start_time) / self.solver_step)


_MODE_MAPS = {
    "forcing_mode": {"CSV": "CSV", "NETCDF": "NETCDF", "0": "CSV", "1": "NETCDF"},
    "output_mode": {
        "LEGACY": "LEGACY",
        "NETCDF": "NETCDF",
        "BOTH": "BOTH",
        "0": "LEGACY",
        "1": "NETCDF",
        "2": "BOTH",
    },
}

# keyword (lowercased) -> (attr, converter)
_PARA_KEYS = {
    "verbose": ("verbose", int),
    "ascii_output": ("ascii", int),
    "binary_output": ("binary", int),
    "spinupday": ("spinup", int),
    "scr_intv": ("screen_intv", int),
    "closeboundary": ("close_boundary", int),
    "init_mode": ("init_type", int),
    "num_openmp": ("num_threads", int),
    "abstol": ("abstol", float),
    "reltol": ("reltol", float),
    "init_solver_step": ("init_step", float),
    "max_solver_step": ("max_step", float),
    "update_ic_step": ("update_ic_step", int),
    "et_mode": ("et_mode", int),
    "et_step": ("et_step", float),
    "lsm_step": ("et_step", float),
    "start": ("day_start", float),
    "end": ("day_end", float),
    "exfiltration": ("exfiltration", int),
    "cryosphere": ("cryosphere", int),
    "solar_lon_deg": ("solar_lon_deg_fixed", float),
    "solar_lat_deg": ("solar_lat_deg_fixed", float),
    "terrain_radiation": ("terrain_radiation", int),
    "rad_factor_cap": ("rad_factor_cap", float),
    "rad_cosz_min": ("rad_cosz_min", float),
    "tsr_integration_step_min": ("tsr_integration_step_min", int),
    "solar_update_interval": ("tsr_integration_step_min", int),  # deprecated alias
    "dt_ye_ic": ("dt_ye_ic", int),
    "dt_ye_snow": ("dt_ye_snow", int),
    "dt_ye_surf": ("dt_ye_surf", int),
    "dt_ye_unsat": ("dt_ye_unsat", int),
    "dt_ye_gw": ("dt_ye_gw", int),
    "dt_qe_prcp": ("dt_qe_prcp", int),
    "dt_qe_rech": ("dt_qe_rech", int),
    "dt_qe_infil": ("dt_qe_infil", int),
    "dt_qe_sub": ("dt_Qe_sub", int),
    "dt_qe_subx": ("dt_Qe_subx", int),
    "dt_qe_surf": ("dt_Qe_surf", int),
    "dt_qe_surfx": ("dt_Qe_surfx", int),
    "dt_qe_rsub": ("dt_Qe_rsub", int),
    "dt_qe_rsurf": ("dt_Qe_rsurf", int),
    "dt_yr_stage": ("dt_yr_stage", int),
    "dt_qr_surf": ("dt_Qr_surf", int),
    "dt_qr_sub": ("dt_Qr_sub", int),
    "dt_qr_down": ("dt_Qr_down", int),
    "dt_qr_up": ("dt_Qr_up", int),
    "dt_lake": ("dt_lake", int),
}


def read_control(path: str) -> Control:
    cs = Control()
    with open(path) as f:
        for line in f:
            if not line.strip() or line[0] in "# \n":
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            key, sval = parts[0], parts[1]
            lk = key.lower()
            if lk in _PARA_KEYS:
                attr, conv = _PARA_KEYS[lk]
                setattr(cs, attr, conv(float(sval)))
            elif lk == "dt_qe_et":
                v = int(float(sval))
                cs.dt_qe_et = v
                cs.dt_qe_etp = v
                cs.dt_qe_eta = v
            elif lk == "forcing_mode":
                cs.forcing_mode = _MODE_MAPS["forcing_mode"].get(sval.upper(), "CSV")
            elif lk == "forcing_cfg":
                cs.forcing_cfg = sval
            elif lk == "output_mode":
                cs.output_mode = _MODE_MAPS["output_mode"].get(sval.upper(), "LEGACY")
            elif lk == "ncoutput_cfg":
                cs.ncoutput_cfg = sval
            elif lk == "radiation_input_mode":
                m = {"SWDOWN": 0, "SWNET": 1, "0": 0, "1": 1}.get(sval.upper())
                if m is not None:
                    cs.radiation_input_mode = m
                    cs.radiation_input_mode_user_set = True
            elif lk == "solar_lonlat_mode":
                m = {"FORCING_FIRST": 0, "FORCING_MEAN": 1, "FIXED": 2,
                     "0": 0, "1": 1, "2": 2}.get(sval.upper())
                if m is not None:
                    cs.solar_lonlat_mode = m
            elif lk == "tsr_factor_mode":
                pass  # deprecated; forcing-interval factor always used
            else:
                print(f"Warning: unrecognised .cfg.para key {key!r}")
    return cs


# ---------------------------------------------------------------------------
# Calibration (.cfg.calib)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Calib:
    """Global calibration scalars (reference ``ModelConfigure.hpp:107-140``).

    Multiplicative unless the key carries a ``+`` suffix (additive).
    """

    # geol
    geol_ksath: float = 1.0
    geol_ksatv: float = 1.0
    geol_kmacsath: float = 1.0
    geol_dmac: float = 1.0
    geol_thetas: float = 1.0
    geol_thetar: float = 1.0
    geol_macvf: float = 1.0
    # soil
    soil_kinf: float = 1.0
    soil_kmacsatv: float = 1.0
    soil_dinf: float = 1.0
    soil_alpha: float = 1.0
    soil_beta: float = 1.0
    soil_machf: float = 1.0
    # landcover
    lc_vegfrac: float = 1.0
    lc_albedo: float = 1.0
    lc_rough: float = 1.0
    lc_ismax: float = 1.0
    lc_droot: float = 1.0
    lc_soildgd: float = 1.0
    lc_impaf: float = 1.0
    # aquifer / forcing / ET
    aq_depth_add: float = 0.0
    ts_prcp: float = 1.0
    ts_sfctmp_add: float = 0.0
    ts_lai: float = 1.0
    ts_mf: float = 1.0
    et_ic: float = 1.0
    et_tr: float = 1.0
    et_soil: float = 1.0
    et_etp: float = 1.0
    # river
    riv_rough: float = 1.0
    riv_kh: float = 1.0
    riv_cwr: float = 1.0
    riv_dpth_add: float = 0.0
    riv_wdth_add: float = 0.0
    riv_bslope_add: float = 0.0
    riv_sinu: float = 1.0
    riv_bedthick: float = 1.0
    # frozen soil
    fzn_submax: float = -3.0
    fzn_submin: float = -10.0
    fzn_subday: float = 28.0
    fzn_surfmax: float = -1.0
    fzn_surfmin: float = -5.0
    fzn_surfday: float = 7.0
    # initial condition
    ic_gw_add: float = 0.0
    ic_riv_add: float = 0.0


_CALIB_KEYS = {
    "geol_ksath": "geol_ksath",
    "geol_ksatv": "geol_ksatv",
    "geol_kmacsath": "geol_kmacsath",
    "geol_dmac": "geol_dmac",
    "geol_thetas": "geol_thetas",
    "geol_thetar": "geol_thetar",
    "geol_macvf": "geol_macvf",
    "soil_kinf": "soil_kinf",
    "soil_kmacsatv": "soil_kmacsatv",
    "soil_dinf": "soil_dinf",
    "soil_alpha": "soil_alpha",
    "soil_beta": "soil_beta",
    "soil_machf": "soil_machf",
    "lc_vegfrac": "lc_vegfrac",
    "lc_albedo": "lc_albedo",
    "lc_rough": "lc_rough",
    "lc_ismax": "lc_ismax",
    "lc_droot": "lc_droot",
    "lc_soildgd": "lc_soildgd",
    "lc_impaf": "lc_impaf",
    "aq_depth+": "aq_depth_add",
    "ts_prcp": "ts_prcp",
    "ts_sfctmp+": "ts_sfctmp_add",
    "ts_lai": "ts_lai",
    "ts_mf": "ts_mf",
    "et_ic": "et_ic",
    "et_tr": "et_tr",
    "et_soil": "et_soil",
    "et_etp": "et_etp",
    "riv_rough": "riv_rough",
    "riv_kh": "riv_kh",
    "riv_cwr": "riv_cwr",
    "riv_dpth+": "riv_dpth_add",
    "riv_wdth+": "riv_wdth_add",
    "riv_bslope+": "riv_bslope_add",
    "riv_sinu": "riv_sinu",
    "riv_bedthick": "riv_bedthick",
    "fzn_submax": "fzn_submax",
    "fzn_submin": "fzn_submin",
    "fzn_subday": "fzn_subday",
    "fzn_surfmax": "fzn_surfmax",
    "fzn_surfmin": "fzn_surfmin",
    "fzn_surfday": "fzn_surfday",
    "ic_gw+": "ic_gw_add",
    "ic_riv+": "ic_riv_add",
}


def read_calib(path: str) -> Calib:
    gc = Calib()
    if not os.path.exists(path):
        return gc
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            if len(parts) < 2:
                continue
            key = parts[0].lower()
            if key in _CALIB_KEYS:
                setattr(gc, _CALIB_KEYS[key], float(parts[1]))
            else:
                raise ValueError(f"Unknown calibration key {parts[0]!r} in {path}")
    return gc


def write_calib(gc: Calib, path: str) -> None:
    inv = [(k, a) for k, a in _CALIB_KEYS.items()]
    with open(path, "w") as f:
        for key, attr in inv:
            f.write(f"{key.upper()}\t{getattr(gc, attr):g}\n")


# ---------------------------------------------------------------------------
# Raw project inputs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ForcingCSV:
    num_stations: int
    start_yyyymmdd: int
    lon: np.ndarray  # [S]
    lat: np.ndarray
    xyz: np.ndarray  # [S, 3]
    filenames: list[str]
    # per-station time series: t_min[K], data[K, 5] (prcp mm/d, temp C, rh, wind, rn)
    t_min: list[np.ndarray] = dataclasses.field(default_factory=list)
    data: list[np.ndarray] = dataclasses.field(default_factory=list)


def read_tsd_csv(path: str) -> tuple[int, np.ndarray, np.ndarray]:
    """Read a time-series CSV (time in days -> minutes).

    Returns (start_yyyymmdd, t_min[K], data[K, ncol-1]).
    """
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split()
    ncol = int(head[1])
    start = int(head[2]) if len(head) > 2 else 0
    rows = []
    for line in lines[2:]:
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        vals = [float(x) for x in s.split()[:ncol]]
        if len(vals) < ncol:
            vals += [0.0] * (ncol - len(vals))
        rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64)
    t_min = arr[:, 0] * 1440.0
    if np.any(np.diff(t_min) < -1e-12):
        raise ValueError(f"Time column not monotonic in {path}")
    return start, t_min, arr[:, 1:]


def read_forc_csv(path: str, inpath: str) -> ForcingCSV:
    with open(path) as f:
        lines = f.read().splitlines()
    head = lines[0].split()
    num, start = int(head[0]), int(head[1])
    base = lines[1].strip() if len(lines) > 1 else ""
    lon, lat, xyz, fns = [], [], [], []
    i = 3
    got = 0
    while got < num and i <= len(lines):
        s = lines[i - 1 + 0] if False else lines[i]
        i += 1
        s2 = s.strip()
        if not s2 or s2.startswith("#"):
            continue
        parts = s2.split()
        lon.append(float(parts[1]))
        lat.append(float(parts[2]))
        xyz.append([float(parts[3]), float(parts[4]), float(parts[5])])
        fns.append(parts[6])
        got += 1
    fc = ForcingCSV(
        num_stations=num,
        start_yyyymmdd=start,
        lon=np.asarray(lon),
        lat=np.asarray(lat),
        xyz=np.asarray(xyz),
        filenames=fns,
    )
    for fn in fns:
        if base:
            # reference resolves relative to CWD; we try CWD-style path first,
            # then relative to the project input dir.
            cand = os.path.join(base, fn)
            if not os.path.exists(cand):
                cand = os.path.join(inpath, fn)
        else:
            cand = os.path.join(inpath, fn)
        start_i, t_min, data = read_tsd_csv(cand)
        if start_i != start:
            raise ValueError(
                f"Forcing start {start_i} != ForcStartTime {start} in {cand}"
            )
        fc.t_min.append(t_min)
        fc.data.append(data)
    return fc


@dataclasses.dataclass
class ProjectInput:
    paths: FilePaths
    control: Control
    calib: Calib
    # mesh tables
    tri: np.ndarray  # [Ne, >=7]: id, node0..2, nabr0..2 (1-based)
    nodes: np.ndarray  # [Nn, 5]: id, x, y, AqD, zmax
    att: np.ndarray  # [Ne, 9]
    riv: np.ndarray  # [Nr, 6]: id, down, type, slope, length, BC
    rivtype: np.ndarray  # [Nt, 9]
    rivseg: np.ndarray  # [Ns, 4]: id, iRiv, iEle, length
    soil: np.ndarray  # [Nsoil, 9]
    geol: np.ndarray  # [Ngeol, 8]
    lc: np.ndarray  # [Nlc, 7+]
    forc: ForcingCSV
    lai_t: np.ndarray
    lai: np.ndarray
    mf_t: np.ndarray
    mf: np.ndarray
    ic: dict | None  # {"ele": [Ne,5], "riv": [Nr], "lake": [Nl]} or None
    lake_bathy: list[np.ndarray] | None  # per lake [k, 3] (idx, yi, ai)
    # boundary-condition time series (optional)
    bc: dict = dataclasses.field(default_factory=dict)


def load_project(project: str, base: str = ".", outpath: str | None = None,
                 calib_file: str | None = None,
                 paths: FilePaths | None = None) -> ProjectInput:
    if paths is None:
        paths = FilePaths.from_project(project, base, outpath)
    cs = read_control(paths.infile("cfg.para"))
    gc = read_calib(calib_file or paths.infile("cfg.calib"))

    mesh_tabs = read_tables(paths.infile("sp.mesh"), 2)
    tri, nodes = mesh_tabs[0][0], mesh_tabs[1][0]
    att = read_table(paths.infile("sp.att"))
    riv_tabs = read_tables(paths.infile("sp.riv"), 2)
    riv, rivtype = riv_tabs[0][0], riv_tabs[1][0]
    rivseg = read_table(paths.infile("sp.rivseg"))
    soil = read_table(paths.infile("para.soil"))
    geol = read_table(paths.infile("para.geol"))
    lc = read_table(paths.infile("para.lc"))

    if cs.forcing_mode == "NETCDF":
        forc = _read_forc_netcdf(paths, cs)
    else:
        forc = read_forc_csv(paths.infile("tsd.forc"), paths.inpath)
    _, lai_t, lai = read_tsd_csv(paths.infile("tsd.lai"))
    _, mf_t, mf = read_tsd_csv(paths.infile("tsd.mf"))

    ic = None
    if cs.init_type >= 3:
        n_lake = _count_lakes(att)
        ic_tabs = read_tables(paths.infile("cfg.ic"), 3 if n_lake else 2)
        ele_ic = ic_tabs[0][0][:, 1:6]
        riv_ic = ic_tabs[1][0][:, 1]
        lake_ic = ic_tabs[2][0][:, 1] if len(ic_tabs) > 2 else np.zeros(0)
        ic = {"ele": ele_ic, "riv": riv_ic, "lake": lake_ic}

    lake_bathy = None
    n_lake = _count_lakes(att)
    if n_lake > 0:
        bathy_path = paths.infile("lake.bathy")
        if os.path.exists(bathy_path):
            tabs = read_tables(bathy_path, n_lake)
            lake_bathy = [t[0] for t in tabs]

    # element/river boundary-condition time series
    bc = {}
    iBC = att[:, 6].astype(int)
    iSS = att[:, 7].astype(int)
    rivBC = riv[:, 5].astype(int)
    if np.any(iBC > 0):
        bc["ele_y"] = read_tsd_csv(paths.infile("tsd.ebc1"))[1:]
    if np.any(iBC < 0):
        bc["ele_q"] = read_tsd_csv(paths.infile("tsd.ebc2"))[1:]
    if np.any(rivBC > 0):
        bc["riv_y"] = read_tsd_csv(paths.infile("tsd.rbc1"))[1:]
    if np.any(rivBC < 0):
        bc["riv_q"] = read_tsd_csv(paths.infile("tsd.rbc2"))[1:]
    if np.any(iSS != 0):
        ss_path = paths.infile("tsd.ebcss")
        if os.path.exists(ss_path):
            bc["ele_ss"] = read_tsd_csv(ss_path)[1:]

    return ProjectInput(
        paths=paths, control=cs, calib=gc, tri=tri, nodes=nodes, att=att,
        riv=riv, rivtype=rivtype, rivseg=rivseg, soil=soil, geol=geol, lc=lc,
        forc=forc, lai_t=lai_t, lai=lai, mf_t=mf_t, mf=mf, ic=ic,
        lake_bathy=lake_bathy, bc=bc,
    )


def _read_forc_netcdf(paths: FilePaths, cs: Control) -> ForcingCSV:
    """NetCDF forcing: station metadata from tsd.forc, data via the product
    adapters (reference: read_forc_netcdf, MD_readin.cpp:384-545)."""
    from shud_tpu_torch.io.ncforcing import load_netcdf_forcing

    with open(paths.infile("tsd.forc")) as f:
        lines = f.read().splitlines()
    head = lines[0].split()
    num, start = int(head[0]), int(head[1])
    stations = []
    got = 0
    i = 3
    while got < num and i <= len(lines):
        s = lines[i]
        i += 1
        s2 = s.strip()
        if not s2 or s2.startswith("#"):
            continue
        parts = s2.split()
        stations.append([float(parts[1]), float(parts[2]), float(parts[5])])
        got += 1
    cfg = cs.forcing_cfg
    if not os.path.isabs(cfg):
        cfg = os.path.join(paths.inpath, cfg)
    return load_netcdf_forcing(
        cfg, np.asarray(stations), start, cs.start_time, cs.end_time
    )


def _count_lakes(att: np.ndarray) -> int:
    ilake = att[:, 8].astype(int)
    return len(np.unique(ilake[ilake > 0]))
