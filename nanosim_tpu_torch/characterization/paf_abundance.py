"""Standalone PAF-based transcript abundance estimator
(nanopore_transcript_abundance.py).

Compatibility = alignments within 95%% of the read's best score sharing its
full-length status; fixed-iteration EM redistributes fractional assignments;
writes `target_id est_count tpm` rows.
"""

from __future__ import annotations

import argparse
import collections
import sys

from ..io.fastx import gzopen


def parse_paf(line: str):
    f = line.rstrip("\n").split("\t")
    return {
        "qname": f[0],
        "qlen": int(f[1]),
        "qstart": int(f[2]),
        "qend": int(f[3]),
        "tname": f[5],
        "tstart": int(f[7]),
        "matches": int(f[9]),
    }


def is_full_length(rec, full_length_min_distance=20) -> bool:
    return rec["tstart"] < full_length_min_distance


def get_compatibility(records, threshold=0.95):
    """{qname: {tname: fraction}} (nanopore_transcript_abundance.py:26-67)."""
    compat = {}
    for qname, alns in records.items():
        best = max(a["matches"] for a in alns)
        any_full = any(is_full_length(a) for a in alns if a["matches"] >= threshold * best)
        ok = [
            a
            for a in alns
            if a["matches"] >= threshold * best
            and (not any_full or is_full_length(a))
        ]
        if not ok:
            continue
        frac = 1.0 / len(ok)
        compat[qname] = {a["tname"]: frac for a in ok}
    return compat


def calculate_abundance(compat):
    abundance = collections.defaultdict(float)
    total = 0.0
    for read, tmap in compat.items():
        for t, f in tmap.items():
            abundance[t] += f
            total += f
    return {t: v / total for t, v in abundance.items()}, total


def update_compatibility(compat, abundance):
    for read, tmap in compat.items():
        total = sum(abundance.get(t, 0.0) for t in tmap)
        if total <= 0:
            continue
        for t in tmap:
            tmap[t] = abundance.get(t, 0.0) / total


def quantify_paf(paf_path: str, out, n_em_iterations: int = 10):
    records = collections.defaultdict(list)
    with gzopen(paf_path) as f:
        for line in f:
            if line.strip():
                rec = parse_paf(line)
                records[rec["qname"]].append(rec)

    compat = get_compatibility(records)
    abundance, total = calculate_abundance(compat)
    for _ in range(n_em_iterations):
        update_compatibility(compat, abundance)
        abundance, total = calculate_abundance(compat)

    out.write("target_id\test_counts\ttpm\n")
    for t, a in sorted(abundance.items()):
        out.write(f"{t}\t{a * total:.2f}\t{a * 1e6:.4f}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="PAF transcript abundance (EM)")
    ap.add_argument("-i", "--input", required=True, help="PAF alignment file")
    ap.add_argument("-o", "--output", default="-", help="output tsv")
    ap.add_argument("-n", "--iterations", type=int, default=10)
    args = ap.parse_args(argv)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    quantify_paf(args.input, out, args.iterations)
    if out is not sys.stdout:
        out.close()


if __name__ == "__main__":
    main()
