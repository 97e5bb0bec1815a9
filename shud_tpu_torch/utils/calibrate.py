"""Calibration interface — the reference's autocalibration hooks.

The reference exposes ``globalCal::copy(varname[], x[])`` for CMA-ES-style
optimisers (``ModelConfigure.cpp:368-375``; CLI hook ``-e dir_cmaes``).
Equivalent here: build a Calib from (names, values), run a short simulation,
and score it against observations.  The counterpart of
``shud_tpu/utils/calibrate.py``; a candidate run reuses the loaded project
and its forcing tables, since only the calibration scalars change."""

from __future__ import annotations

import numpy as np

from shud_tpu_torch.io.project import Calib, _CALIB_KEYS


def calib_from_vector(names: list[str], x: np.ndarray,
                      base: Calib | None = None) -> Calib:
    """globalCal::copy equivalent: apply (name, value) pairs onto a Calib."""
    import dataclasses

    gc = dataclasses.replace(base) if base is not None else Calib()
    for name, val in zip(names, x):
        key = name.lower()
        if key not in _CALIB_KEYS:
            raise KeyError(f"unknown calibration key {name!r}")
        setattr(gc, _CALIB_KEYS[key], float(val))
    return gc


def run_with_calib(project: str, base_dir: str, gc: Calib, end_day: float,
                   float_dtype=None, inp=None, fr=None,
                   device: "str | torch.device" = "cuda"):
    """Build a simulation with the given calibration on *device* (the card
    unless the caller asks for the CPU); returns the FusedSimulation (daily
    outlet discharge in the caller's hands via advance_interval).  Pass
    ``inp``/``fr`` from a previous call to reuse the loaded project and
    forcing/TSR tables across candidates."""
    import torch

    from shud_tpu_torch.driver.fused import FusedSimulation

    if float_dtype is None:
        float_dtype = torch.float64
    return FusedSimulation.create(project, base=base_dir, calib=gc,
                                  float_dtype=float_dtype, day_end=end_day,
                                  inp=inp, fr=fr, device=device)


def cma_es(objective, x0, sigma0=0.3, bounds=None, popsize=None,
           max_gen=20, seed=0, verbose=False):
    """Minimal (mu/mu_w, lambda)-CMA-ES (Hansen 2016 tutorial equations).

    The reference integrates an EXTERNAL CMA-ES through the ``-e`` CLI
    hook and the ``globalCal::copy`` vector API (CommandIn.cpp:210-212,
    ModelConfigure.cpp:368-375); here the optimiser is built in so
    autocalibration runs self-contained.

    ``objective(x) -> float`` is MINIMISED (pass -NSE for calibration).
    Returns (x_best, f_best, history)."""
    x0 = np.asarray(x0, dtype=float)
    n = len(x0)
    lam = popsize or 4 + int(3 * np.log(n))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mu_eff = 1.0 / np.sum(w**2)
    cc = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    cs = (mu_eff + 2) / (n + mu_eff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0, np.sqrt((mu_eff - 1) / (n + 1)) - 1) + cs
    chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

    rng = np.random.default_rng(seed)
    mean = x0.copy()
    sigma = float(sigma0)
    pc = np.zeros(n)
    ps = np.zeros(n)
    C = np.eye(n)
    x_best, f_best = x0.copy(), np.inf
    hist = []
    for gen in range(max_gen):
        evals, xs = [], []
        B, D2, _ = np.linalg.svd(C)
        D = np.sqrt(np.maximum(D2, 1e-20))
        for _ in range(lam):
            z = rng.standard_normal(n)
            x = mean + sigma * (B @ (D * z))
            if bounds is not None:
                x = np.clip(x, bounds[0], bounds[1])
            xs.append(x)
            evals.append(objective(x))
        order = np.argsort(evals)
        if evals[order[0]] < f_best:
            f_best = float(evals[order[0]])
            x_best = xs[order[0]].copy()
        hist.append(f_best)
        if verbose:
            print(f"  gen {gen}: best {f_best:.4f} sigma {sigma:.3f}")
        sel = np.array([xs[i] for i in order[:mu]])
        mean_new = w @ sel
        y = (mean_new - mean) / sigma
        inv_sqrt_c = B @ np.diag(1.0 / D) @ B.T
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * (inv_sqrt_c @ y)
        hsig = (np.linalg.norm(ps)
                / np.sqrt(1 - (1 - cs) ** (2 * (gen + 1))) / chi_n
                < 1.4 + 2 / (n + 1))
        pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mu_eff) * y
        arts = (sel - mean) / sigma
        C = ((1 - c1 - cmu) * C
             + c1 * (np.outer(pc, pc) + (not hsig) * cc * (2 - cc) * C)
             + cmu * (arts.T * w) @ arts)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chi_n - 1))
        mean = mean_new
    return x_best, f_best, hist


def nse(sim_q: np.ndarray, obs_q: np.ndarray) -> float:
    """Nash-Sutcliffe efficiency (the rSHUD objective)."""
    obs = np.asarray(obs_q, dtype=float)
    sim = np.asarray(sim_q, dtype=float)
    m = np.isfinite(obs) & np.isfinite(sim)
    obs, sim = obs[m], sim[m]
    denom = np.sum((obs - obs.mean()) ** 2)
    if denom <= 0:
        return -np.inf
    return 1.0 - np.sum((sim - obs) ** 2) / denom
