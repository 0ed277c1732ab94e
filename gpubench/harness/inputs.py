"""The benchmark's inputs, made from the seed: a frozen copy of the port's
fixture makers (profiles/fixtures.py), so that a change to the program
cannot move the yardstick.

`make_model_dir` writes a NanoSim genome model directory (length KDEs,
error-length mixtures, error-type Markov chain, match-length ECDFs, base
quality parameters, homopolymer and chimeric parameters) with ONT-like
numbers.  One departure from the port's copy: the aligned and unaligned
length KDE points are moved to the stated mean and sd exactly, so that
every seed gives the same mean read length and the same work (the seed
still draws each point).  `make_reference_fasta` writes random bases, the
same bytes as the port's maker, formatted in bulk.
"""

from __future__ import annotations

import os

import numpy as np

from ..reference import ecdf, error_model, kde


def _standard(x: np.ndarray, mean: float, sd: float) -> np.ndarray:
    """Points of x moved and scaled to the sample mean `mean` and sd `sd`."""
    return mean + (x - x.mean()) * (sd / x.std())


def _lengths_hist_cum(rng, mean, n=150, shape=2.0):
    """Cumulative probs of a discretized gamma-ish length histogram on [0, n)."""
    xs = np.arange(n, dtype=np.float64)
    pdf = np.power(xs + 1, shape - 1) * np.exp(-(xs + 1) / (mean / shape))
    pdf[0] = 0.0  # no zero-length first matches
    pdf = pdf / pdf.sum()
    return np.cumsum(pdf)


def make_model_dir(
    prefix: str,
    seed: int = 0,
    mean_read_len: float = 2000.0,
    sd_read_len: float = 900.0,
    mean_match: float = 20.0,
    aligned_rate: float = 9.0,
    strandness: float = 0.5,
    n_kde_points: int = 400,
    segment_mean: float = 1.25,
) -> None:
    """Write a full synthetic model directory under `prefix`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    error_model.write_strandness(prefix + "_strandness_rate", strandness)
    error_model.write_alignment_rate(prefix + "_reads_alignment_rate", aligned_rate)

    # Mixture parameters: plausible ONT-like error-length models.
    mix = error_model.MixtureParams(
        mis=np.array([0.3, 0.0, 0.25, 0.5]),
        ins=np.array([0.9, 0.6, 0.3, 0.4]),
        dele=np.array([1.0, 0.65, 0.3, 0.4]),
    )
    error_model.write_model_profile(prefix + "_model_profile", mix)

    # Error-type Markov transitions: rows sum to 1.
    base = np.array(
        [
            [0.55, 0.25, 0.20],  # start
            [0.50, 0.25, 0.25],  # mis
            [0.45, 0.35, 0.20],  # ins
            [0.45, 0.20, 0.35],  # del
            [0.60, 0.20, 0.20],  # mis0
            [0.40, 0.40, 0.20],  # ins0
            [0.40, 0.20, 0.40],  # del0
        ]
    )
    error_model.write_error_markov(prefix + "_error_markov_model", base)

    # First-match ECDF over 0..149 (single 0-50000 bin).
    fm = _lengths_hist_cum(rng, mean_match)
    ecdf.write_ecdf_file(prefix + "_first_match.hist", [(0, 50000)], fm[:, None], first_token="bin")

    # Match markov: 15 prev-match bins, each with its own decay scale.
    bin_edges = [0, 3, 6, 9, 12, 16, 20, 25, 30, 36, 43, 52, 64, 80, 110, 150]
    bounds = [(bin_edges[i], bin_edges[i + 1]) for i in range(15)]
    lanes = []
    for i in range(15):
        lane_mean = max(3.0, mean_match * (0.5 + 0.08 * i))
        lanes.append(_lengths_hist_cum(rng, lane_mean))
    ecdf.write_ecdf_file(prefix + "_match_markov_model", bounds, np.stack(lanes, axis=1))

    # Raw error histograms (fitting inputs / informational).
    for name, lam in (("_mis.hist", 0.4), ("_ins.hist", 0.9), ("_del.hist", 1.0)):
        xs = np.arange(1, 30)
        counts = np.round(2000 * np.exp(-xs / (1 + lam))).astype(int)
        dense = np.zeros(30, dtype=np.int64)
        dense[1:30] = counts
        error_model.write_histogram(prefix + name, dense, name[1:4].capitalize() + ":")
    error_model.write_error_rates(prefix + "_error_rate.tsv", 100000, 5000, 4000, 4500)

    # Length KDEs.
    aligned = np.maximum(50, _standard(rng.normal(mean_read_len, sd_read_len, n_kde_points),
                                       mean_read_len, sd_read_len))
    kde.save_kde(prefix + "_aligned_region.pkl", aligned, 10.0)
    kde.save_kde(prefix + "_aligned_reads.pkl", aligned * 1.05 + 40, 10.0)
    ht = np.abs(rng.normal(1.2, 0.5, n_kde_points))  # log10(ht+1)
    kde.save_kde(prefix + "_ht_length.pkl", ht, 0.01)
    ratio = np.clip(rng.beta(2, 2, n_kde_points), 0.01, 0.99)
    kde.save_kde(prefix + "_ht_ratio.pkl", ratio, 0.01)
    unaligned = np.maximum(30, _standard(rng.normal(mean_read_len * 0.4, sd_read_len * 0.5,
                                                    n_kde_points),
                                         mean_read_len * 0.4, sd_read_len * 0.5))
    kde.save_kde(prefix + "_unaligned_length.pkl", unaligned, 10.0)
    gap = np.abs(rng.normal(1.5, 0.6, n_kde_points))  # log10(gap+1)
    kde.save_kde(prefix + "_gap_length.pkl", gap, 0.01)
    error_model.write_chimeric_info(prefix + "_chimeric_info", segment_mean, 0.2)

    # Base-quality lognormal parameters (per-class medians ~ {14, 8, 7, 5, 6}).
    quals = {
        "match": {"sd": 0.45, "loc": 0.0, "mu": float(np.log(14.0))},
        "mis": {"sd": 0.5, "loc": 0.0, "mu": float(np.log(8.0))},
        "ins": {"sd": 0.5, "loc": 0.0, "mu": float(np.log(7.0))},
        "ht": {"sd": 0.55, "loc": 0.0, "mu": float(np.log(5.0))},
        "unmapped": {"sd": 0.55, "loc": 0.0, "mu": float(np.log(6.0))},
    }
    error_model.write_base_quality_params(prefix + "_base_qualities_model_parameters.tsv", quals)

    # Homopolymer model: slight contraction with spread growing with length.
    hp = error_model.HomopolymerParams(
        mis_rate=0.02,
        pw={
            "AT": {"const": 0.35, "alpha1": 0.93, "beta1": -0.10, "breakpoint1": 12.0},
            "CG": {"const": 0.40, "alpha1": 0.95, "beta1": -0.12, "breakpoint1": 10.0},
        },
        lr={
            "AT": {"intercept": 0.0, "slope": 0.16},
            "CG": {"intercept": 0.0, "slope": 0.18},
        },
    )
    error_model.write_homopolymer_params(prefix + "_hp_lengths_model_parameters.tsv", hp)

    # Intron retention Markov model.
    ir = np.array([[0.9, 0.1], [0.85, 0.15], [0.5, 0.5]])
    error_model.write_ir_markov(prefix + "_IR_markov_model", ir)


BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_reference_fasta(path: str, chroms, seed: int, line_width: int = 70) -> None:
    """Random uppercase bases, one record per (name, length) of `chroms`,
    `line_width` bases a line."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for name, ln in chroms:
            seq = BASES[rng.integers(0, 4, ln)]
            f.write(f">{name}\n".encode())
            full = ln // line_width * line_width
            lines = np.empty((ln // line_width, line_width + 1), np.uint8)
            lines[:, :line_width] = seq[:full].reshape(-1, line_width)
            lines[:, line_width] = ord("\n")
            f.write(lines.tobytes())
            if full < ln:
                f.write(seq[full:].tobytes() + b"\n")
