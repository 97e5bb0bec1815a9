# Copied verbatim from shud_tpu/io/validate.py; only the package imports differ.
"""Input validation — fail-fast checks mirroring the reference
(``MD_CheckInputData.cpp``, ``ModelConfigure.cpp:89-133`` checkValue,
``MD_readin.cpp:797-937`` forcing time coverage)."""

from __future__ import annotations

import numpy as np

from shud_tpu_torch.io.project import ProjectInput


class InputError(ValueError):
    pass


def _range(arr, lo, hi, what, where):
    arr = np.asarray(arr)
    bad = np.where((arr < lo) | (arr > hi))[0]
    if len(bad):
        i = bad[0]
        raise InputError(
            f"{what}[{i + 1}] = {arr[i]} out of range ({lo}, {hi}) in {where}"
        )


def check_input(inp: ProjectInput, warn=print) -> None:
    att = inp.att
    n_soil, n_geol, n_lc = len(inp.soil), len(inp.geol), len(inp.lc)
    n_forc = inp.forc.num_stations
    n_mf = inp.mf.shape[1]

    # attribute index ranges (CheckInput_att)
    _range(att[:, 1], 1, n_soil, "iSoil", ".sp.att")
    _range(att[:, 2], 1, n_geol, "iGeol", ".sp.att")
    _range(att[:, 3], 1, n_lc, "iLC", ".sp.att")
    _range(att[:, 4], 1, n_forc, "iForc", ".sp.att")
    _range(att[:, 5], 1, n_mf, "iMF", ".sp.att")

    # physical ranges (raw table units, pre-conversion)
    _range(inp.soil[:, 5], 0.05, 20.0, "Alpha", ".para.soil")
    _range(inp.soil[:, 6], 1.0, 10.0, "Beta", ".para.soil")
    _range(inp.soil[:, 1], 0.0, 1.0e3, "infKsatV", ".para.soil")
    _range(inp.soil[:, 4], 0.0, 10.0, "infD", ".para.soil")
    _range(inp.soil[:, 2], 0.001, 1.0, "ThetaS", ".para.soil")
    _range(inp.geol[:, 1], 0.0, 1.0e3, "KsatH", ".para.geol")
    _range(inp.geol[:, 2], 0.0, 1.0e3, "KsatV", ".para.geol")
    _range(inp.geol[:, 3], 0.0, 1.0, "geo_ThetaS", ".para.geol")
    _range(inp.geol[:, 7], 0.0, 10.0, "macD", ".para.geol")
    _range(inp.lc[:, 1], 0.0, 1.0, "Albedo", ".para.lc")
    _range(inp.lc[:, 2], 0.0, 1.0, "VegFrac", ".para.lc")
    _range(inp.lc[:, 3], 0.0, 1.0, "Rough", ".para.lc")
    _range(inp.lc[:, 4], 0.0, 10.0, "RzD", ".para.lc")

    # forcing plausibility bands (CheckInput_forc; warnings, not fatal)
    bands = [(0, 0.0, 400.0, "Prcp"), (1, -70.0, 50.0, "Temp"),
             (2, 0.0, 1.0, "RH"), (3, 0.0, 50.0, "Wind"),
             (4, 0.0, 1360.0, "Radiation")]
    for s in range(inp.forc.num_stations):
        data = inp.forc.data[s]
        for col, lo, hi, name in bands:
            v = data[:, col]
            bad = np.where((v < lo) | (v > hi))[0]
            if len(bad):
                warn(
                    f"Warning: {name}(t={inp.forc.t_min[s][bad[0]]:g} min) ="
                    f" {v[bad[0]]:g} out of range ({lo}, {hi})"
                )

    # forcing must cover the simulation period (validateTimeStamps)
    cs = inp.control
    for s in range(inp.forc.num_stations):
        t = inp.forc.t_min[s]
        t_cov = t[-1] + (t[-1] - t[-2] if len(t) > 1 else cs.solver_step)
        if t[0] - cs.start_time > 1e-6 or cs.end_time - t_cov > 1e-6:
            raise InputError(
                f"Forcing station {s + 1} covers [{t[0]:.1f}, {t_cov:.1f}] "
                f"min but simulation needs [{cs.start_time:.1f}, "
                f"{cs.end_time:.1f}]"
            )


def read_output_masks(inp: ProjectInput, num_ele: int, num_riv: int,
                      num_lake: int):
    """Per-entity output on/off masks from ``.cfg.output``
    (``read_cfgout``, MD_readin.cpp:25-105).  Missing file -> all on.
    Each table: header value = default, rows (index, on/off) override."""
    import os

    from shud_tpu_torch.io.tables import read_tables

    path = inp.paths.infile("cfg.output")
    masks = {
        "ele": np.ones(num_ele, dtype=bool),
        "riv": np.ones(num_riv, dtype=bool),
        "lake": np.ones(max(num_lake, 0), dtype=bool),
    }
    if not os.path.exists(path):
        return masks
    tabs = read_tables(path)
    order = ["ele", "riv", "lake"]
    counts = [num_ele, num_riv, num_lake]
    for k, (tab, header, _extra) in enumerate(tabs):
        if k >= len(order) or counts[k] == 0:
            break
        key = order[k]
        default = bool(int(float(header.split()[0]))) if header.split() else True
        masks[key][:] = default
        for row in tab:
            idx = int(row[0]) - 1
            if 0 <= idx < counts[k]:
                masks[key][idx] = row[1] > 0
    return masks
