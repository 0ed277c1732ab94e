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


# --- alignments for the characterization stage's tests and smoke run ---

_COMP = dict(zip("ACGT", "TGCA"))


def _revcomp(s):
    return "".join(_COMP.get(c, c) for c in reversed(s))


def _cs_and_cigar(ref_slice, events):
    """cs tag + CIGAR from ground-truth events (ascending key order)."""
    evs = sorted(events, key=lambda e: (e[0], 0 if e[1] != "ins" else -1))
    cs = []
    cigar = []
    cursor = 0

    def add_cigar(n, op):
        if n <= 0:
            return
        if cigar and cigar[-1][1] == op:
            cigar[-1][0] += n
        else:
            cigar.append([n, op])

    for key, etype, elen, ref_b, seq_b in evs:
        if key > cursor:
            n = key - cursor
            cs.append(f":{n}")
            add_cigar(n, "M")
            cursor = key
        if etype == "mis":
            for rb, sb in zip(ref_b, seq_b):
                cs.append(f"*{rb.lower()}{sb.lower()}")
            add_cigar(elen, "M")
            cursor += elen
        elif etype == "del":
            cs.append("-" + ref_b.lower())
            add_cigar(elen, "D")
            cursor += elen
        else:
            cs.append("+" + seq_b.lower())
            add_cigar(elen, "I")
    if cursor < len(ref_slice):
        n = len(ref_slice) - cursor
        cs.append(f":{n}")
        add_cigar(n, "M")
    return "".join(cs), cigar


def build_sam_from_ground_truth(genome, records, errors, out_path, raw_names=None):
    """SAM text with cs tags reconstructed from simulator ground truth (the
    round trip of tests/test_characterization.py): `records` are the reads
    as (name, seq, qual) with the simulator's names, `errors` the error log's
    rows by read name as (key, type, length, ref bases, seq bases).
    raw_names maps the genome's (mangled) chromosome names to the FASTA's
    own, which an aligner would write."""
    raw = raw_names or {}
    with open(out_path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:unsorted\n")
        for nm, ln in zip(genome.names, genome.lengths):
            f.write(f"@SQ\tSN:{raw.get(nm, nm)}\tLN:{ln}\n")
        for name, seq, qual in records:
            parts = name.split("_")
            if "unaligned" in parts:
                f.write(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual or '*'}\n")
                continue
            chrom, pos = parts[0], int(parts[1])
            strand, head, mref, tail = parts[-4], int(parts[-3]), int(parts[-2]), int(parts[-1])
            pre = _revcomp(seq) if strand == "R" else seq
            pre_q = qual[::-1] if (qual and strand == "R") else qual
            ci = genome.names.index(chrom)
            ref_slice = genome.slice(ci, pos, mref).tobytes().decode()
            cs, cigar = _cs_and_cigar(ref_slice, errors.get(name, []))
            flag = 16 if strand == "R" else 0
            cig = f"{head}S" if head else ""
            cig += "".join(f"{n}{op}" for n, op in cigar)
            if tail:
                cig += f"{tail}S"
            f.write(f"{name}\t{flag}\t{raw.get(chrom, chrom)}\t{pos + 1}\t60\t{cig}\t*\t0\t0\t{pre}\t"
                    f"{pre_q or '*'}\tNM:i:0\tcs:Z:{cs}\n")


def _add_clip(cigar, n, at_start):
    """A CIGAR with n more soft-clipped bases at its start or end."""
    import re

    ops = [[int(k), op] for k, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)]
    i = 0 if at_start else -1
    if ops[i][1] == "S":
        ops[i][0] += n
    elif at_start:
        ops.insert(0, [n, "S"])
    else:
        ops.append([n, "S"])
    return "".join(f"{k}{op}" for k, op in ops)


def add_chimeric_pairs(sam_in, sam_out, n_pairs):
    """Join consecutive forward-strand primary records into chimeric reads:
    the primary alignment is the first segment's, the second segment becomes
    a supplementary record (flag 2048), and both carry SA tags."""
    header, body = [], []
    with open(sam_in) as f:
        for line in f:
            (header if line.startswith("@") else body).append(line.rstrip("\n").split("\t"))
    fwd = [i for i, r in enumerate(body) if r[1] == "0"]
    pairs = [(fwd[2 * k], fwd[2 * k + 1]) for k in range(min(n_pairs, len(fwd) // 2))]
    joined = {}
    for k, (ia, ib) in enumerate(pairs):
        a, b = body[ia], body[ib]
        seq, qual = a[9] + b[9], (a[10] + b[10]) if a[10] != "*" else "*"
        cig_a, cig_b = _add_clip(a[5], len(b[9]), False), _add_clip(b[5], len(a[9]), True)
        name = f"chimera{k}"
        prim = [name, "0", a[2], a[3], "60", cig_a, "*", "0", "0", seq, qual, "NM:i:0",
                a[12], f"SA:Z:{b[2]},{b[3]},+,{cig_b},60,0;"]
        supp = [name, "2048", b[2], b[3], "60", cig_b, "*", "0", "0", seq, qual, "NM:i:0",
                b[12], f"SA:Z:{a[2]},{a[3]},+,{cig_a},60,0;"]
        joined[ia] = [prim, supp]
        joined[ib] = []
    with open(sam_out, "w") as f:
        for line in header:
            f.write("\t".join(line) + "\n")
        for i, r in enumerate(body):
            for rec in joined.get(i, [r]):
                f.write("\t".join(rec) + "\n")


def _ops_to_cigar_cs(ops):
    """(CIGAR, cs) from primitive ops: ("M", ref, read), ("X", ref, read),
    ("I", read), ("D", ref), ("N", length)."""
    cig, cs = [], []

    def add(op, n=1):
        if cig and cig[-1][1] == op:
            cig[-1][0] += n
        else:
            cig.append([n, op])

    for o in ops:
        k = o[0]
        if k in "MX":
            add("M")
            if k == "M":
                if cs and cs[-1][0] == ":":
                    cs[-1] = f":{int(cs[-1][1:]) + 1}"
                else:
                    cs.append(":1")
            else:
                cs.append(f"*{o[1].lower()}{o[2].lower()}")
        elif k in "ID":
            add(k)
            sign = "+" if k == "I" else "-"
            base = o[1].lower()
            if cs and cs[-1][0] == sign:
                cs[-1] += base
            else:
                cs.append(sign + base)
        else:
            add("N", o[1])
            cs.append(f"~gt{o[1]}ag")
    return "".join(f"{n}{op}" for n, op in cig), "".join(cs)


def make_transcriptome_alignments(d, n_reads=360, n_unaligned=24, seed=17):
    """(genome FASTA, transcripts FASTA, annotation, reads FASTQ, genome SAM,
    transcriptome SAM).  Each read covers a stretch of a transcript; an
    intron it spans is retained with probability 0.3 (an `M` stretch in the
    genome alignment, an insertion in the transcriptome one; otherwise `N`);
    mismatches, insertions and deletions of 3, 2 and 2 percent (no deletion
    in a retained intron); soft-clipped
    heads and tails; half the reads reverse; one read in six also aligns,
    as a secondary record, to another transcript."""
    from ..io.genome import PackedGenome
    from .profile import load_transcript_structures

    rs = np.random.default_rng(seed)
    genome_fa, trx_fa, gff, trx = make_ir_fixture(os.path.join(d, "ir"))
    g = PackedGenome.from_fasta(genome_fa)
    flat = g.flat
    structs = load_transcript_structures(gff).by_transcript
    bases = np.array(list("ACGT"))
    names = [t for t, _ in trx]
    reads, g_lines, t_lines = [], [], []

    for r in range(n_reads):
        ti = int(rs.integers(len(trx)))
        tname, tlen = trx[ti]
        feats = structs[tname]
        exons = [(s, e) for ft, _, s, e, _, _ in feats if ft == "exon"]
        # the path: genome positions, intronic flag, transcript position
        span = int(rs.integers(250, min(tlen, 1400)))
        a = int(rs.integers(0, tlen - span + 1))
        gpos, intronic, tpos = [], [], []
        t = 0
        for j, (s, e) in enumerate(exons):
            for p in range(s, e):
                if a <= t < a + span:
                    gpos.append(p)
                    intronic.append(False)
                    tpos.append(t)
                t += 1
            if j + 1 < len(exons) and a < t < a + span and rs.random() < 0.3:
                for p in range(e, exons[j + 1][0]):
                    gpos.append(p)
                    intronic.append(True)
                    tpos.append(-1)
        n = len(gpos)
        ev = []  # per path position: (kind, read bases)
        for i in range(n):
            ref = chr(flat[gpos[i]])
            u = rs.random() if 6 <= i < n - 6 else 1.0
            if u < 0.03:
                alt = bases[(np.nonzero(bases == ref)[0][0] + int(rs.integers(1, 4))) % 4]
                ev.append(("X", ref, str(alt)))
            elif u < 0.05 and not intronic[i]:
                # (a deletion would split the intron's aligned block, and the
                # IR model counts an intron retained only when one read's
                # blocks cover all of it)
                ev.append(("D", ref))
            elif u < 0.07:
                ev.append(("I", str(bases[rs.integers(4)])))
                ev.append(("M", ref, ref))
            else:
                ev.append(("M", ref, ref))
        # genome ops (N across skipped introns) and transcriptome ops
        g_ops, t_ops, mid = [], [], []
        pi = 0  # path index of the op
        for o in ev:
            if o[0] == "I":
                g_ops.append(o)
                t_ops.append(o)
                mid.append(o[1])
                continue
            if pi > 0 and gpos[pi] != gpos[pi - 1] + 1:
                g_ops.append(("N", gpos[pi] - gpos[pi - 1] - 1))
            g_ops.append(o)
            if o[0] in "MX":
                mid.append(o[2])
                t_ops.append(("I", o[2]) if intronic[pi] else o)
            elif not intronic[pi]:
                t_ops.append(o)
            pi += 1
        head = "".join(bases[rs.integers(0, 4, int(rs.integers(0, 40)))])
        tail = "".join(bases[rs.integers(0, 4, int(rs.integers(0, 40)))])
        seq = head + "".join(mid) + tail
        qual = "".join(chr(33 + int(q)) for q in rs.integers(4, 40, len(seq)))
        rev = rs.random() < 0.5
        name = f"tread{r}"
        reads.append((name, _revcomp(seq) if rev else seq, qual[::-1] if rev else qual))
        flag = 16 if rev else 0
        clip = lambda c: (f"{len(head)}S" if head else "") + c + (f"{len(tail)}S" if tail else "")
        gc, gcs = _ops_to_cigar_cs(g_ops)
        tc, tcs = _ops_to_cigar_cs(t_ops)
        t0 = next(x for x in tpos if x >= 0)
        g_lines.append(f"{name}\t{flag}\tchr1\t{gpos[0] + 1}\t60\t{clip(gc)}\t*\t0\t0\t{seq}\t"
                       f"{qual}\tNM:i:0\tcs:Z:{gcs}")
        t_lines.append(f"{name}\t{flag}\t{tname}\t{t0 + 1}\t60\t{clip(tc)}\t*\t0\t0\t{seq}\t"
                       f"{qual}\tNM:i:0\tcs:Z:{tcs}")
        if r % 6 == 0:
            other = names[(ti + 1 + r % 5) % len(names)]
            t_lines.append(f"{name}\t{256 + flag}\t{other}\t1\t0\t{clip(tc)}\t*\t0\t0\t*\t*\t"
                           f"NM:i:0")
    for r in range(n_unaligned):
        seq = "".join(bases[rs.integers(0, 4, int(rs.integers(200, 900)))])
        qual = "".join(chr(33 + int(q)) for q in rs.integers(4, 20, len(seq)))
        name = f"uread{r}"
        reads.append((name, seq, qual))
        for lines in (g_lines, t_lines):
            lines.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}")

    reads_fq = os.path.join(d, "trx_reads.fastq")
    with open(reads_fq, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    g_sam, t_sam = os.path.join(d, "trx_genome.sam"), os.path.join(d, "trx_transcriptome.sam")
    t_ref = PackedGenome.from_fasta(trx_fa)
    with open(g_sam, "w") as f:
        f.write(f"@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:{g.lengths[0]}\n")
        f.write("".join(x + "\n" for x in g_lines))
    with open(t_sam, "w") as f:
        f.write("@HD\tVN:1.6\n")
        f.write("".join(f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in zip(t_ref.names, t_ref.lengths)))
        f.write("".join(x + "\n" for x in t_lines))
    return genome_fa, trx_fa, gff, reads_fq, g_sam, t_sam
