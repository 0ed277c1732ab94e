"""Homopolymer length model fitting (model_homopolymer_lengths.py).

From MAF alignments: per-run reference-vs-read homopolymer lengths (one
substitution tolerated when measuring the read run, as the reference's fuzzy
`{s<=1}` regex does), in-run mismatch rate, then a 1-breakpoint piecewise
regression of the mean and a no-intercept linear regression of the std,
AT/CG pooled -> `_hp_lengths_model_parameters.tsv` + `_hp_lengths.tsv`.

The piecewise fit replaces the `piecewise_regression` dependency with a
breakpoint grid + least squares (same model family: mu = const + alpha1*x +
beta1*max(x - breakpoint1, 0)).
"""

from __future__ import annotations

import re
import sys
from time import strftime

import numpy as np

from ..io.fastx import gzopen


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def _read_run_length(read_homopolymer: str, base: str) -> int:
    """Longest run of `base` in the read segment allowing one substitution,
    trimmed at mismatching ends (analyze_homopolymers,
    model_homopolymer_lengths.py:88-106)."""
    best = 0
    n = len(read_homopolymer)
    i = 0
    while i < n:
        if read_homopolymer[i] != base:
            i += 1
            continue
        # extend with at most one substitution
        subs = 0
        j = i
        last_good = i
        while j < n:
            if read_homopolymer[j] == base:
                last_good = j
                j += 1
            elif subs == 0 and j + 1 < n and read_homopolymer[j + 1] == base:
                subs += 1
                j += 1
            else:
                break
        best = max(best, last_good - i + 1)
        i = max(i + 1, j)
    return best


def analyze_homopolymers(maf_path: str, min_hp_len: int, prefix: str):
    """Returns ({"AT"/"CG": {ref_len: [read_lens]}}, [[ref_seq, read_seq,
    base]]) and writes `_hp_lengths.tsv`
    (model_homopolymer_lengths.py:36-139)."""
    hp_lengths_rows = []
    per_base = {"AT": {}, "CG": {}}
    hp_alnms = []
    k = str(min_hp_len)
    pattern = re.compile(
        "A{" + k + ",}|C{" + k + ",}|G{" + k + ",}|T{" + k + ",}"
    )
    gapped = re.compile(
        "(-*A-*){" + k + ",}|(-*C-*){" + k + ",}|(-*G-*){" + k + ",}|(-*T-*){" + k + ",}"
    )

    with gzopen(maf_path) as f:
        for line in f:
            ref_info = line.split()
            ref_name, ref_start0, ref_seq = ref_info[1], int(ref_info[2]), ref_info[6]
            read_seq = next(f).split()[6]

            ref_nodash = ref_seq.replace("-", "")
            ref_coords = [
                (m.group()[0], ref_start0 + m.start(), ref_start0 + m.end())
                for m in pattern.finditer(ref_nodash)
            ]
            aligned_coords = [(m.start(), m.end()) for m in gapped.finditer(ref_seq)]

            for (base, rs, re_), (a_s, a_e) in zip(ref_coords, aligned_coords):
                ref_hp_len = len(ref_seq[a_s:a_e].replace("-", ""))
                read_hp = read_seq[a_s:a_e].replace("-", "")
                read_hp_len = _read_run_length(read_hp, base)
                hp_alnms.append([ref_seq[a_s:a_e], read_seq[a_s:a_e], base])
                hp_lengths_rows.append(
                    (f"{ref_name}:{rs + 1}-{re_ + 1}", base, ref_hp_len, read_hp_len)
                )
                key = "AT" if base in "AT" else "CG"
                per_base[key].setdefault(ref_hp_len, []).append(read_hp_len)

    uniq, counts = np.unique(np.asarray(hp_lengths_rows, dtype=object), axis=0, return_counts=True) if hp_lengths_rows else (np.zeros((0, 4), object), np.zeros(0, int))
    with open(prefix + "_hp_lengths.tsv", "w") as f:
        f.write("Chrom:Ref pos\tType\tRef length\tRead length\tCount\n")
        for row, c in zip(uniq, counts):
            f.write("\t".join(str(x) for x in row) + f"\t{c}\n")
    return per_base, hp_alnms


def calc_homopolymer_mis_rate(hp_alnms) -> float:
    """model_homopolymer_lengths.py:9-33."""
    err = {"ins": 0, "del": 0, "mis": 0, "match": 0}
    for ref_seq, read_seq, _base in hp_alnms:
        err["ins"] += ref_seq.count("-")
        err["del"] += read_seq.count("-")
        for a, b in zip(ref_seq, read_seq):
            if a != "-" and b != "-":
                if a != b:
                    err["mis"] += 1
                else:
                    err["match"] += 1
    denom = err["del"] + err["mis"] + err["match"]
    return err["mis"] / denom if denom else 0.0


def fit_piecewise_1bp(x: np.ndarray, y: np.ndarray):
    """Least-squares 1-breakpoint segmented regression: grid over candidate
    breakpoints + OLS per segment model.  Returns (const, alpha1, beta1,
    breakpoint1)."""
    best = None
    lo, hi = float(x.min()), float(x.max())
    for bp in np.linspace(lo + 0.5, hi - 0.5, max(3, len(np.unique(x)) * 2)):
        A = np.stack([np.ones_like(x), x, np.maximum(x - bp, 0.0)], axis=1)
        coef, res, *_ = np.linalg.lstsq(A, y, rcond=None)
        pred = A @ coef
        sse = float(((pred - y) ** 2).sum())
        if best is None or sse < best[0]:
            best = (sse, coef, bp)
    _, coef, bp = best
    return float(coef[0]), float(coef[1]), float(coef[2]), float(bp)


def model_homopolymer_lengths(maf_path: str, min_hp_len, prefix: str):
    """Top-level entry (model_homopolymer_lengths.py:212-243)."""
    _log("Parsing alignment file for homopolymers")
    per_base, hp_alnms = analyze_homopolymers(maf_path, int(min_hp_len), prefix)
    _log("Calculating mismatch rates in homopolymers")
    mis_rate = calc_homopolymer_mis_rate(hp_alnms)
    _log("Estimating model parameters")

    from ..profiles import error_model

    pw, lr = {}, {}
    for key in ("AT", "CG"):
        data = per_base[key]
        if len(data) < 3:
            raise ValueError(
                "Too few homopolymer observations for "
                + key
                + "; consider more reads or turning off homopolymer modeling."
            )
        xs = np.array(sorted(data), np.float64)
        means = np.array([np.mean(data[int(v)]) for v in xs])
        stds = np.array([np.std(data[int(v)]) for v in xs])
        const, a1, b1, bp = fit_piecewise_1bp(xs, means)
        pw[key] = {"const": const, "alpha1": a1, "beta1": b1, "breakpoint1": bp}
        # no-intercept linear regression of the std (fit_lr,
        # model_homopolymer_lengths.py:189-201)
        slope = float((xs * stds).sum() / (xs * xs).sum())
        lr[key] = {"intercept": 0.0, "slope": slope}

    params = error_model.HomopolymerParams(mis_rate=mis_rate, pw=pw, lr=lr)
    error_model.write_homopolymer_params(prefix + "_hp_lengths_model_parameters.tsv", params)
    return params
