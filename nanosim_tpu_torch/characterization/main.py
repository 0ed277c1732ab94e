"""Characterization orchestration (read_analysis.py main flows).

Each mode consumes reads + references (or pre-computed alignments) and
produces a complete model directory in the reference's on-disk format.
Alignments may be provided as SAM text (`-ga`/`-ta`, cs tags recommended) or
MAF; otherwise minimap2/LAST are orchestrated when available.
"""

from __future__ import annotations

import os
import sys
from time import strftime

import numpy as np

from ..profiles import error_model
from ..profiles.kde import save_kde
from . import align, error_hist, fitting, lengths, primary, quals


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def _finalize_common(
    prefix: str,
    unaligned_len,
    strandness: float,
    num_aligned: int,
    unaligned_bq,
    aligner: str,
    *,
    fastq: bool = False,
    model_fit: bool = True,
    homopolymer=None,
    hp_maf=None,
    error_prefix=None,
):
    """Strandness + alignment-rate files, unaligned KDE, error models,
    fitting, hp + base-quality models (read_analysis.py:832-890)."""
    with open(prefix + "_strandness_rate", "w") as f:
        f.write("strandness:\t" + str(round(strandness, 3)))

    num_unaligned = len(unaligned_len)
    if num_unaligned != 0:
        error_model.write_alignment_rate(prefix + "_reads_alignment_rate", num_aligned * 1.0 / num_unaligned)
        save_kde(prefix + "_unaligned_length.pkl", np.asarray(unaligned_len, np.float64), 10.0)
    else:
        error_model.write_alignment_rate(prefix + "_reads_alignment_rate", None)

    _log("match and error models")
    error_hist.hist(error_prefix or prefix, "maf" if aligner == "LAST" else "sam")

    if model_fit:
        _log("Model fitting")
        fitting.model_fitting(prefix)

    if homopolymer is not None and hp_maf:
        _log("Analyzing homopolymer lengths and estimating model parameters")
        from . import hp_model

        hp_model.model_homopolymer_lengths(hp_maf, homopolymer, prefix)

    if fastq:
        _log("Base quality models")
        quals.model_base_qualities(
            (error_prefix or prefix) + "_primary.sam", prefix, unaligned_bq
        )


def characterize_genome(
    read_file: str,
    ref_g: str,
    prefix: str = "training",
    *,
    aligner: str = "minimap2",
    g_alnm: str = "",
    num_threads: int = 1,
    model_fit: bool = True,
    chimeric: bool = False,
    homopolymer=None,
    fastq: bool = False,
):
    """Genome-mode characterization (read_analysis.py:526-611 + shared
    tail)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    if g_alnm and g_alnm.endswith(".maf"):
        _log("Processing MAF alignment")
        unaligned_len, strandness = align.besthit_and_unaligned(read_file, g_alnm, prefix)
        num_aligned = lengths.head_align_tail(prefix, "maf", "genome")
        _finalize_common(
            prefix, unaligned_len, strandness, num_aligned, [], "LAST",
            fastq=False, model_fit=model_fit,
        )
        return

    if aligner == "LAST" and not g_alnm:
        # LAST path: lastdb+lastal -> best-hit MAF -> MAF-based models
        # (read_analysis.py:177-201)
        maf_path = prefix + "_genome_alnm.maf"
        _log("Running LAST")
        align.run_last(ref_g, read_file, maf_path, prefix)
        unaligned_len, strandness = align.besthit_and_unaligned(read_file, maf_path, prefix)
        num_aligned = lengths.head_align_tail(prefix, "maf", "genome")
        _finalize_common(
            prefix, unaligned_len, strandness, num_aligned, [], "LAST",
            fastq=False, model_fit=model_fit,
        )
        return

    sam_path = g_alnm
    if not sam_path:
        sam_path = prefix + "_genome_alnm.sam"
        _log("Running minimap2")
        align.run_minimap2(ref_g, read_file, sam_path, "map-ont", num_threads)

    _log("Processing primary alignments")
    if chimeric:
        unaligned_len, strandness, unaligned_bq = primary.primary_and_unaligned_chimeric(
            sam_path, prefix, fastq=fastq
        )
    else:
        unaligned_len, strandness, unaligned_bq = primary.primary_and_unaligned(
            sam_path, prefix, fastq=fastq
        )

    _log("Aligned reads analysis")
    num_aligned = lengths.head_align_tail(prefix, "sam", "genome")

    hp_maf = None
    if homopolymer is not None:
        hp_maf = prefix + "_processed.maf"
        _log("Building pairwise MAF for homopolymer analysis")
        align.sam_to_maf(prefix + "_primary.sam", hp_maf, ref_g)

    _finalize_common(
        prefix, unaligned_len, strandness, num_aligned, unaligned_bq, "minimap2",
        fastq=fastq, model_fit=model_fit, homopolymer=homopolymer, hp_maf=hp_maf,
    )


def characterize_metagenome(
    read_file: str,
    genome_list: str,
    prefix: str = "training",
    *,
    g_alnm: str = "",
    num_threads: int = 1,
    model_fit: bool = True,
    chimeric: bool = False,
    quantification: bool = False,
    homopolymer=None,
    fastq: bool = False,
):
    """Metagenome characterization (read_analysis.py metagenome mode):
    genomes are concatenated with species-prefixed chromosome names
    (concatenate_genomes, read_analysis.py:235-248)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    # concatenate genomes with species-tagged names
    meta_ref = prefix + "_combined_ref.fasta"
    metagenome_list = {}
    from ..io.fastx import read_fastx

    with open(genome_list) as gl, open(meta_ref, "w") as out:
        for line in gl:
            if not line.strip():
                continue
            fields = line.split("\t")
            species = "_".join(fields[0].split())
            path = fields[1].strip()
            metagenome_list[species] = {}
            for name, seq, _ in read_fastx(path):
                out.write(f">{species}_{name}\n{seq}\n")

    sam_path = g_alnm
    if not sam_path:
        sam_path = prefix + "_metagenome_alnm.sam"
        _log("Running minimap2")
        align.run_minimap2(meta_ref, read_file, sam_path, "map-ont", num_threads)

    _log("Processing primary alignments")
    if chimeric:
        unaligned_len, strandness, unaligned_bq = primary.primary_and_unaligned_chimeric(
            sam_path, prefix, metagenome_list=metagenome_list, fastq=fastq
        )
    else:
        unaligned_len, strandness, unaligned_bq = primary.primary_and_unaligned(
            sam_path, prefix, metagenome_list=metagenome_list, fastq=fastq
        )

    num_aligned = lengths.head_align_tail(prefix, "sam", "metagenome")

    hp_maf = None
    if homopolymer is not None:
        hp_maf = prefix + "_processed.maf"
        _log("Building pairwise MAF for homopolymer analysis")
        align.sam_to_maf(prefix + "_primary.sam", hp_maf, meta_ref)

    _finalize_common(
        prefix, unaligned_len, strandness, num_aligned, unaligned_bq, "minimap2",
        fastq=fastq, model_fit=model_fit, homopolymer=homopolymer, hp_maf=hp_maf,
    )


def characterize_transcriptome(
    read_file: str,
    ref_g: str,
    ref_t: str,
    annotation: str,
    prefix: str = "training",
    *,
    g_alnm: str = "",
    t_alnm: str = "",
    num_threads: int = 1,
    model_fit: bool = True,
    model_ir: bool = True,
    homopolymer=None,
    quantification: bool = False,
    normalize: bool = False,
    fastq: bool = False,
):
    """Transcriptome characterization (read_analysis.py:707-830): align to
    the transcriptome (map-ont) AND the genome (splice), error models from
    the GENOME alignment, length models joining both, IR model from the
    annotation."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)

    t_sam = t_alnm
    if not t_sam:
        t_sam = prefix + "_transcriptome_alnm.sam"
        _log("Running minimap2 (transcriptome)")
        align.run_minimap2(ref_t, read_file, t_sam, "map-ont", num_threads)
    g_sam = g_alnm
    if not g_sam and ref_g:
        g_sam = prefix + "_genome_alnm.sam"
        _log("Running minimap2 (genome, splice)")
        align.run_minimap2(ref_g, read_file, g_sam, "splice", num_threads)

    _log("Processing transcriptome alignments")
    meta = {"tpm": {}} if quantification else None
    unaligned_len, strandness, unaligned_bq = primary.primary_and_unaligned_chimeric(
        t_sam, prefix + "_transcriptome", metagenome_list=meta, fastq=fastq,
        normalize=normalize,
    )
    if g_sam:
        _log("Processing genome alignments")
        primary.primary_and_unaligned(g_sam, prefix + "_genome")

    if model_ir and annotation:
        _log("Adding introns to annotation")
        align.add_introns_to_annotation(annotation, prefix + "_added_intron_final.gff3")
        _log("Modeling Intron Retention")
        from . import ir_model

        ir_model.intron_retention(
            prefix,
            prefix + "_added_intron_final.gff3",
            prefix + "_genome_primary.sam",
            prefix + "_transcriptome_primary.sam",
        )

    _log("Aligned reads analysis")
    num_aligned = lengths.head_align_tail(prefix + "_transcriptome", "sam", "transcriptome")

    hp_maf = None
    if homopolymer is not None:
        hp_maf = prefix + "_transcriptome_alnm_processed.maf"
        align.sam_to_maf(prefix + "_transcriptome_primary.sam", hp_maf, ref_t)

    _finalize_common(
        prefix, unaligned_len, strandness, num_aligned, unaligned_bq, "minimap2",
        fastq=fastq, model_fit=model_fit, homopolymer=homopolymer, hp_maf=hp_maf,
        error_prefix=(prefix + "_genome") if g_sam else (prefix + "_transcriptome"),
    )


def quantify(
    read_file: str,
    ref_t: str = "",
    prefix: str = "expression",
    *,
    mode: str = "trans",
    genome_list: str = "",
    t_alnm: str = "",
    g_alnm: str = "",
    num_threads: int = 1,
    normalize: bool = True,
):
    """Abundance quantification only (read_analysis.py quantify mode,
    read_analysis.py:390-457): `trans` -> EM + TPM over a transcriptome
    alignment; `meta` -> base-weighted EM over species-tagged genomes, with
    expected-abundance variation reporting when the genome list carries a
    third column."""
    if mode == "trans":
        sam_path = t_alnm
        if not sam_path:
            sam_path = prefix + "_transcriptome_alnm.sam"
            align.run_minimap2(ref_t, read_file, sam_path, "map-ont", num_threads)
        primary.primary_and_unaligned_chimeric(
            sam_path, prefix, metagenome_list={"tpm": {}}, q_mode=True, normalize=normalize
        )
        return

    # meta: concatenate species genomes with tagged chromosome names
    from ..io.fastx import read_fastx

    metagenome_list = {}
    meta_ref = prefix + "_combined_ref.fasta"
    with open(genome_list) as gl, open(meta_ref, "w") as out:
        for line in gl:
            if not line.strip():
                continue
            info = line.strip().split("	")
            species = "_".join(info[0].split())
            metagenome_list[species] = {"path": info[1]}
            if len(info) == 3:
                metagenome_list[species]["expected"] = float(info[2])
            for name, seq, _ in read_fastx(info[1]):
                out.write(f">{species}_{name}\n{seq}\n")
    sam_path = g_alnm
    if not sam_path:
        sam_path = prefix + "_metagenome_alnm.sam"
        align.run_minimap2(meta_ref, read_file, sam_path, "map-ont", num_threads)
    primary.primary_and_unaligned(sam_path, prefix, metagenome_list=metagenome_list)


def detect_ir(
    annotation: str,
    prefix: str = "ir",
    *,
    g_alnm: str = "",
    t_alnm: str = "",
    read_file: str = "",
    ref_g: str = "",
    ref_t: str = "",
    aligner: str = "minimap2",
    num_threads: int = 1,
):
    """Intron-retention detection only (read_analysis.py detect_ir mode);
    aligns the reads itself when only references are supplied.

    The -a flag is accepted for surface parity; alignment always runs
    minimap2 (the reference's LAST branch feeds a MAF into its pysam-based
    IR model, model_intron_retention.py:35, and cannot complete)."""
    if aligner == "LAST":
        _log("detect_ir: using minimap2 (LAST output is not consumable by the IR model)")
    if not g_alnm:
        g_alnm = prefix + "_genome_alnm.sam"
        align.run_minimap2(ref_g, read_file, g_alnm, "splice", num_threads)
    if not t_alnm:
        t_alnm = prefix + "_transcriptome_alnm.sam"
        align.run_minimap2(ref_t, read_file, t_alnm, "map-ont", num_threads)
    align.add_introns_to_annotation(annotation, prefix + "_added_intron_final.gff3")
    from . import ir_model

    ir_model.intron_retention(prefix, prefix + "_added_intron_final.gff3", g_alnm, t_alnm)
