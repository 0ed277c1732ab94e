"""Base-quality model fitting (model_base_qualities.py).

Buckets per-base qualities from cs-tagged primary alignments into
{match, mis, ins, ht, unmapped} and fits a log-normal (floc=0, 500k
subsample) per class; writes `_base_qualities_model_parameters.tsv`.
"""

from __future__ import annotations

import sys
from time import strftime

import numpy as np

from ..profiles import error_model
from . import sam as sam_mod
from .error_hist import _CS_RE


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def expand_cs_per_base(cs_string: str):
    """Per-aligned-base op characters (convert_cs,
    model_base_qualities.py:23-36)."""
    out = []
    for item in _CS_RE.findall(cs_string):
        op = item[0]
        if op == ":":
            out.extend(":" * int(item[1:]))
        elif op == "+":
            out.extend("+" * (len(item) - 1))
        elif op == "*":
            out.append("*")
    return out


def analyze_aligned_base_qualities(primary_sam: str):
    """{class: [quals]} from the aligned portion of each primary alignment
    (model_base_qualities.py:55-79)."""
    per_type = {"mis": [], "ins": [], "match": [], "ht": [], "unmapped": []}
    cs_map = {":": "match", "+": "ins", "*": "mis"}
    for kind, aln in sam_mod.read_sam(primary_sam):
        if kind != "aln" or aln.is_secondary:
            continue
        q = aln.query_qualities()
        if q is None or "cs" not in aln.tags:
            continue
        qs, qe = aln.query_alignment_start, aln.query_alignment_end
        aligned_q = q[qs:qe]
        cs_arr = expand_cs_per_base(aln.tags["cs"])
        for i in range(min(len(aligned_q), len(cs_arr))):
            per_type[cs_map[cs_arr[i]]].append(aligned_q[i])
        if qs > 0:
            per_type["ht"] += q[:qs]
        if qe < len(q):
            per_type["ht"] += q[qe:]
    return per_type


def fit_lognorm(per_type: dict, prefix: str, sample_size: int = 500_000):
    """Per-class lognormal fits -> tsv (model_base_qualities.py:82-96)."""
    from scipy.stats import lognorm

    out = {}
    rng = np.random.default_rng(0)
    for t in error_model.QUAL_TYPES:
        vals = np.asarray(per_type.get(t, []), np.float64)
        if len(vals) == 0:
            out[t] = {"sd": 0.5, "loc": 0.0, "mu": float(np.log(10.0))}
            continue
        if len(vals) > sample_size:
            vals = rng.choice(vals, sample_size)
        sd, loc, scale = lognorm.fit(vals, floc=0)
        out[t] = {"sd": float(sd), "loc": float(loc), "mu": float(np.log(scale))}
    error_model.write_base_quality_params(
        prefix + "_base_qualities_model_parameters.tsv", out
    )
    return out


def model_base_qualities(primary_sam: str, prefix: str, unmapped_base_quals):
    """Top-level entry (model_base_qualities.py:99-117)."""
    _log("Parsing alignment file for base qualities relative to matches and each error type")
    per_type = analyze_aligned_base_qualities(primary_sam)
    per_type["unmapped"] = list(unmapped_base_quals)
    _log("Estimating model parameters")
    return fit_lognorm(per_type, prefix)
