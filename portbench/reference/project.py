# A frozen copy of shud_tpu_torch/io/project.py,
# its imports rewritten to this package; the input dataclasses only,
# no readers.
"""Project file registry, run-control config and calibration parsing.

Mirrors the reference's input conventions:
* path registry — ``src/classes/IO.cpp:51-92`` (``input/<prj>/<prj>.*`` →
  ``output/<prj>.out/``);
* ``.cfg.para`` keyword file — ``src/classes/Model_Control.cpp:141-671``;
* ``.cfg.calib`` global calibration scalars — ``src/classes/ModelConfigure.cpp``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


