"""Synthetic model-directory + reference generator for tests and benchmarks.

Produces a complete, self-consistent model directory in the exact on-disk
formats of SURVEY.md §2.1, plus synthetic reference FASTA files — small enough
for golden tests against the reference implementation, and parameterizable
(mean read length, error rates) for realistic benchmarking.
"""

from __future__ import annotations

import os

import numpy as np

from . import ecdf, error_model, kde


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
    transcriptome: bool = False,
    mean_2d_ref_len: float = 1500.0,
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
    aligned = np.maximum(50, rng.normal(mean_read_len, sd_read_len, n_kde_points))
    kde.save_kde(prefix + "_aligned_region.pkl", aligned, 10.0)
    kde.save_kde(prefix + "_aligned_reads.pkl", aligned * 1.05 + 40, 10.0)
    ht = np.abs(rng.normal(1.2, 0.5, n_kde_points))  # log10(ht+1)
    kde.save_kde(prefix + "_ht_length.pkl", ht, 0.01)
    ratio = np.clip(rng.beta(2, 2, n_kde_points), 0.01, 0.99)
    kde.save_kde(prefix + "_ht_ratio.pkl", ratio, 0.01)
    unaligned = np.maximum(30, rng.normal(mean_read_len * 0.4, sd_read_len * 0.5, n_kde_points))
    kde.save_kde(prefix + "_unaligned_length.pkl", unaligned, 10.0)
    gap = np.abs(rng.normal(1.5, 0.6, n_kde_points))  # log10(gap+1)
    kde.save_kde(prefix + "_gap_length.pkl", gap, 0.01)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.25, 0.2)

    if transcriptome:
        ref_lens = np.maximum(200, rng.normal(mean_2d_ref_len, 500, n_kde_points))
        aligned_2d = np.minimum(ref_lens * rng.uniform(0.5, 0.98, n_kde_points), ref_lens - 10)
        kde.save_kde(
            prefix + "_aligned_region_2d.pkl",
            np.stack([ref_lens, aligned_2d], axis=1),
            float((n_kde_points * (2 + 2) / 4.0) ** (-1.0 / (2 + 4))),
        )

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


def make_reference_fasta(
    path: str,
    chrom_lengths,
    seed: int = 1,
    line_width: int = 70,
    name_prefix: str = "chr",
    with_iupac: bool = False,
    hp_bias: float = 0.0,
) -> None:
    """Write a random FASTA reference.

    hp_bias > 0 inflates homopolymer runs (for -hp tests).
    """
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for ci, ln in enumerate(chrom_lengths):
            seq = BASES[rng.integers(0, 4, ln)].copy()
            if hp_bias > 0:
                # stretch: copy the previous base with probability hp_bias
                stay = rng.random(ln) < hp_bias
                for i in range(1, ln):
                    if stay[i]:
                        seq[i] = seq[i - 1]
            if with_iupac:
                amb_pos = rng.integers(0, ln, max(1, ln // 200))
                seq[amb_pos] = ord("N")
            s = seq.tobytes().decode()
            f.write(f">{name_prefix}{ci + 1}\n")
            for i in range(0, ln, line_width):
                f.write(s[i : i + line_width] + "\n")


def make_transcript_reference(
    path: str,
    n_transcripts: int = 20,
    mean_len: int = 1500,
    seed: int = 2,
) -> list:
    """Random transcriptome FASTA; returns [(name, length)]."""
    rng = np.random.default_rng(seed)
    out = []
    with open(path, "w") as f:
        for i in range(n_transcripts):
            ln = max(200, int(rng.normal(mean_len, mean_len / 3)))
            seq = BASES[rng.integers(0, 4, ln)].tobytes().decode()
            name = f"ENST{i:08d}"
            f.write(f">{name}\n{seq}\n")
            out.append((name, ln))
    return out


def make_expression_tsv(path: str, transcripts, seed: int = 3) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("target_id\test_counts\ttpm\n")
        for name, _ in transcripts:
            tpm = float(rng.gamma(0.8, 60.0))
            f.write(f"{name}\t{tpm * 2:.2f}\t{tpm:.4f}\n")


def make_ir_fixture(dirpath: str, n_transcripts: int = 12, seed: int = 4):
    """Genome + transcripts-with-introns + GFF3 structure fixture.

    Each transcript is the concatenation of 2-4 exon slices of a random
    genome, with introns between them; the GFF (written as
    `<dir>/training_added_intron_final.gff3`) carries transcript_id
    attributes like the GenomeTools pipeline output.

    Returns (genome_fa, trx_fa, gff_path, [(name, spliced_len)]).
    """
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    genome_fa = os.path.join(dirpath, "genome.fa")
    glen = 120000
    make_reference_fasta(genome_fa, [glen], seed=seed + 1)
    from ..io.genome import PackedGenome

    g = PackedGenome.from_fasta(genome_fa)

    trx_fa = os.path.join(dirpath, "transcripts.fa")
    gff = os.path.join(dirpath, "training_added_intron_final.gff3")
    out = []
    cursor = 100
    with open(trx_fa, "w") as tf, open(gff, "w") as gf:
        gf.write("##gff-version 3\n")
        for i in range(n_transcripts):
            name = f"ENSTIR{i:06d}"
            n_exon = int(rng.integers(2, 5))
            feats = []
            pos = cursor
            for e in range(n_exon):
                elen = int(rng.integers(300, 900))
                feats.append(("exon", pos, pos + elen))
                pos += elen
                if e < n_exon - 1:
                    ilen = int(rng.integers(80, 400))
                    feats.append(("intron", pos, pos + ilen))
                    pos += ilen
            cursor = pos + int(rng.integers(200, 500))
            seq = b"".join(
                g.flat[s:e].tobytes() for t, s, e in feats if t == "exon"
            ).decode()
            tf.write(f">{name}\n{seq}\n")
            for t, s, e in feats:
                gf.write(
                    f"chr1\tfix\t{t}\t{s + 1}\t{e}\t.\t+\t.\ttranscript_id={name}\n"
                )
            out.append((name, len(seq)))
    return genome_fa, trx_fa, gff, out
