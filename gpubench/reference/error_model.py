"""Readers/writers for the tsv-style model files.

Covers: `_model_profile`, `_error_markov_model`, `_IR_markov_model`,
`_base_qualities_model_parameters.tsv`, `_hp_lengths_model_parameters.tsv`,
`_strandness_rate`, `_reads_alignment_rate`, `_chimeric_info`,
`_error_rate.tsv`, and the raw `*.hist` histograms.

Formats are byte-compatible with the reference (load sites:
simulator.py:473-591; write sites: besthit_to_histogram.py:366-422,
model_fitting.py:108-217, model_base_qualities.py:82-96,
model_homopolymer_lengths.py:236-243, read_analysis.py:833-851,
get_primary_sam.py:464-476, model_intron_retention.py:186-205).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

ERROR_STATES = ("start", "mis", "ins", "del", "mis0", "ins0", "del0")
ERROR_TYPES = ("mis", "ins", "del")
QUAL_TYPES = ("match", "mis", "ins", "ht", "unmapped")


# ---------------------------------------------------------------------------
# _model_profile — mixture parameters (lambda, k, prob, weight) per error type
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MixtureParams:
    """Poisson-Geometric (mis) / Weibull-Geometric (ins, del) parameters.

    Row layout after the type name is [lambda, k, prob, weight]
    (model_fitting.py:136, 169, 203; read site simulator.py:473-484).
    The mismatch row stores k=0 (unused by the Poisson-Geometric mixture).
    """

    mis: np.ndarray  # [4]
    ins: np.ndarray  # [4]
    dele: np.ndarray  # [4]

    def by_type(self, t: str) -> np.ndarray:
        return {"mis": self.mis, "ins": self.ins, "del": self.dele}[t]


def read_model_profile(path: str) -> MixtureParams:
    vals = {}
    with open(path) as f:
        f.readline()
        for line in f:
            parts = line.strip().split("\t")
            if not parts or parts == [""]:
                continue
            nums = np.array([float(x) for x in parts[1:]], dtype=np.float64)
            if "mismatch" in line:
                vals["mis"] = nums
            elif "insertion" in line:
                vals["ins"] = nums
            else:
                vals["del"] = nums
    return MixtureParams(mis=vals["mis"], ins=vals["ins"], dele=vals["del"])


def write_model_profile(path: str, params: MixtureParams) -> None:
    with open(path, "w") as f:
        f.write("Type\tlambda\tk\tprob\tweight\n")
        m = [float(x) for x in params.mis]
        f.write(f"mismatch\t{m[0]!r}\t0\t{m[2]!r}\t{m[3]!r}\n")
        i = [float(x) for x in params.ins]
        f.write(f"insertion\t{i[0]!r}\t{i[1]!r}\t{i[2]!r}\t{i[3]!r}\n")
        d = [float(x) for x in params.dele]
        f.write(f"deletion\t{d[0]!r}\t{d[1]!r}\t{d[2]!r}\t{d[3]!r}\n")


# ---------------------------------------------------------------------------
# _error_markov_model — error-type transition probabilities
# ---------------------------------------------------------------------------

def read_error_markov(path: str) -> np.ndarray:
    """Returns [7, 3] probs P(next in {mis, ins, del} | state) in ERROR_STATES
    order.  Read site: simulator.py:486-495 (intervals (0,p1) mis,
    (p1,p1+p2) ins, (1-p3,1) del)."""
    probs = {}
    with open(path) as f:
        f.readline()
        for line in f:
            info = line.strip().split()
            if not info:
                continue
            probs[info[0]] = [float(x) for x in info[1:4]]
    out = np.zeros((len(ERROR_STATES), 3), dtype=np.float64)
    for i, s in enumerate(ERROR_STATES):
        if s in probs:
            out[i] = probs[s]
        elif s == "ins0" and "ins0" not in probs:
            # files always contain all 7 rows, but be safe
            out[i] = [1.0 / 3] * 3
    return out


def write_error_markov(path: str, probs: np.ndarray) -> None:
    """probs: [7, 3] in ERROR_STATES x ERROR_TYPES order
    (writer: besthit_to_histogram.py:410-422)."""
    with open(path, "w") as f:
        f.write("succedent \tmis\tins\tdel\n")
        f.write("start\t" + "\t".join(repr(float(x)) for x in probs[0]))
        for i, s in enumerate(ERROR_STATES[1:], start=1):
            f.write("\n" + s)
            for x in probs[i]:
                xf = float(x)
                f.write("\t" + ("0" if xf == 0 else repr(xf)))


# ---------------------------------------------------------------------------
# _IR_markov_model — intron retention transitions
# ---------------------------------------------------------------------------

IR_STATES = ("start", "no_IR", "IR")


def read_ir_markov(path: str) -> np.ndarray:
    """Returns [3, 2] probs P({no_IR, IR} | state) in IR_STATES order
    (read site simulator.py:413-421)."""
    out = np.zeros((3, 2), dtype=np.float64)
    with open(path) as f:
        f.readline()
        for line in f:
            info = line.strip().split()
            if not info:
                continue
            if info[0] in IR_STATES:
                out[IR_STATES.index(info[0])] = [float(info[1]), float(info[2])]
    return out


def write_ir_markov(path: str, probs: np.ndarray) -> None:
    """Writer format: model_intron_retention.py:186-205."""
    with open(path, "w") as f:
        f.write("succedent\tno_IR\tIR\n")
        for i, s in enumerate(IR_STATES):
            f.write(s + "\t" + repr(float(probs[i][0])) + "\t" + repr(float(probs[i][1])) + "\n")


# ---------------------------------------------------------------------------
# _base_qualities_model_parameters.tsv — truncated-lognormal per class
# ---------------------------------------------------------------------------

def read_base_quality_params(path: str) -> dict:
    """{type: {"sd", "loc", "mu"}} (read site simulator.py:580-591)."""
    out = {}
    with open(path) as f:
        next(f)
        for line in f:
            fields = line.split("\t")
            if len(fields) < 4:
                continue
            out[fields[0]] = {
                "sd": float(fields[1]),
                "loc": float(fields[2]),
                "mu": float(fields[3]),
            }
    return out


def write_base_quality_params(path: str, params: dict) -> None:
    """Writer format: model_base_qualities.py:82-96."""
    with open(path, "w") as f:
        f.write("type\tsd\tloc\tmu\n")
        for t in QUAL_TYPES:
            p = params[t]
            f.write(f"{t}\t{p['sd']}\t{p['loc']}\t{p['mu']}\n")


# ---------------------------------------------------------------------------
# _hp_lengths_model_parameters.tsv — homopolymer piecewise + LR params
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HomopolymerParams:
    mis_rate: float
    # per pooled base class "AT"/"CG": piecewise params (const, alpha1,
    # beta*, breakpoint*) and linear-regression params (intercept, slope)
    pw: dict
    lr: dict

    def mean_std(self, base_class: str, ref_len: float) -> tuple:
        """Normal parameters for a run of ref_len (mutate_homo's get_nd_par /
        predict_piecewise / predict_lr, model_homopolymer_lengths.py:167-209,
        246-260)."""
        pw = self.pw[base_class]
        mu = float(pw["const"]) + float(pw["alpha1"]) * ref_len
        bps = sorted(k for k in pw if "breakpoint" in k)
        betas = sorted(k for k in pw if "beta" in k)
        for bp_k, beta_k in zip(bps, betas):
            mu += float(pw[beta_k]) * max(ref_len - float(pw[bp_k]), 0.0)
        lr = self.lr[base_class]
        sigma = float(lr["intercept"]) + float(lr["slope"]) * ref_len
        return mu, sigma


def read_homopolymer_params(path: str) -> HomopolymerParams:
    """Read site: simulator.py:504-529."""
    with open(path) as f:
        first = next(f)
        mis_rate = float(re.search(r"\d+\.?\d*([eE][+-]?\d+)?", first)[0])
        col_names = next(f).strip().split("\t")
        pw, lr = {}, {}
        for line in f:
            fields = line.strip().split("\t")
            if len(fields) < 2:
                continue
            base = fields[0]
            pw[base] = {}
            lr[base] = {}
            for i, col in enumerate(col_names):
                if i == 0:
                    continue
                if col in ("intercept", "slope"):
                    lr[base][col] = float(fields[i])
                else:
                    pw[base][col] = float(fields[i])
    return HomopolymerParams(mis_rate=mis_rate, pw=pw, lr=lr)


def write_homopolymer_params(path: str, params: HomopolymerParams) -> None:
    """Writer format: model_homopolymer_lengths.py:236-243."""
    pw_cols = list(next(iter(params.pw.values())).keys())
    lr_cols = ["intercept", "slope"]
    with open(path, "w") as f:
        f.write("#Homopolymer mismatch rate: " + str(params.mis_rate) + "\n")
        f.write("base\t" + "\t".join(pw_cols + lr_cols) + "\n")
        for base in params.pw:
            vals = [str(params.pw[base][c]) for c in pw_cols]
            vals += [str(params.lr[base][c]) for c in lr_cols]
            f.write(base + "\t" + "\t".join(vals) + "\n")


# ---------------------------------------------------------------------------
# Small single-value files
# ---------------------------------------------------------------------------

def read_strandness(path: str) -> float:
    with open(path) as f:
        return float(f.readline().split("\t")[1])


def write_strandness(path: str, rate: float) -> None:
    """Writer format: read_analysis.py:833-835."""
    with open(path, "w") as f:
        f.write("strandness:\t" + str(round(rate, 3)))


def read_alignment_rate(path: str):
    """Returns the ratio as float, or None for the '100%' sentinel
    (read site simulator.py:535-542)."""
    with open(path) as f:
        rate = f.readline().strip().split("\t")[1]
    return None if rate == "100%" else float(rate)


def write_alignment_rate(path: str, ratio) -> None:
    """Writer format: read_analysis.py:841-851."""
    with open(path, "w") as f:
        if ratio is None:
            f.write("Aligned / Unaligned ratio:\t100%\n")
        else:
            f.write("Aligned / Unaligned ratio:\t" + str(ratio) + "\n")


def read_chimeric_info(path: str):
    """(segment_mean, abun_inflation_or_None) — read site simulator.py:573-576."""
    with open(path) as f:
        segment_mean = float(f.readline().split("\t")[1])
        line2 = f.readline()
        inflation = float(line2.split("\t")[1]) if line2.strip() else None
    return segment_mean, inflation


def write_chimeric_info(path: str, segment_mean: float, inflation=None) -> None:
    """Writer format: get_primary_sam.py:472-476."""
    with open(path, "w") as f:
        f.write("Mean segments of chimeric reads:\t" + str(segment_mean) + "\n")
        if inflation is not None:
            f.write("Shrinkage constant beta:\t" + str(inflation) + "\n")


# ---------------------------------------------------------------------------
# Histograms (*.hist) and error rates
# ---------------------------------------------------------------------------

def read_histogram(path: str) -> np.ndarray:
    """Dense counts indexed by value (reader: model_fitting.py:27-45)."""
    vals = {}
    with open(path) as f:
        f.readline()
        for line in f:
            info = line.strip().split()
            if len(info) >= 2:
                vals[int(info[0])] = int(info[1])
    if not vals:
        return np.zeros(0, dtype=np.int64)
    out = np.zeros(max(vals) + 1, dtype=np.int64)
    for k, v in vals.items():
        out[k] = v
    return out


def write_histogram(path: str, counts: np.ndarray, title: str) -> None:
    """Writer format: besthit_to_histogram.py:372-394."""
    with open(path, "w") as f:
        f.write("number of bases\t" + title + "\n")
        for k, v in enumerate(counts):
            f.write(f"{k}\t{int(v)}\n")


def write_error_rates(path: str, total_match: int, total_mis: int, total_ins: int, total_del: int) -> None:
    """Writer format: besthit_to_histogram.py:396-402."""
    denom = float(total_mis + total_match + total_del)
    with open(path, "w") as f:
        f.write("Mismatch rate:\t" + str(total_mis * 1.0 / denom) + "\n")
        f.write("Insertion rate:\t" + str(total_ins * 1.0 / denom) + "\n")
        f.write("Deletion rate:\t" + str(total_del * 1.0 / denom) + "\n")
        f.write("Total error rate:\t" + str((total_mis + total_ins + total_del) * 1.0 / denom) + "\n")
