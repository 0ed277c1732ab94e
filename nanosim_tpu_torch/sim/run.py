"""Top-level simulation runs: the equivalent of the reference's `simulation`
orchestrator (simulator.py:1571-1672) for genome mode, single host."""

from __future__ import annotations

import os
import sys
from time import strftime
from typing import Optional

from ..io.genome import PackedGenome
from ..profiles import profile as profile_mod
from . import output
from .genome_mode import GenomeSimulator
from .unaligned_mode import UnalignedBatchWriter, UnalignedSimulator


def _log(msg: str):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def simulate_genome(
    ref_g: str,
    model_prefix: str,
    out: str,
    number: int = 20000,
    *,
    fastq: bool = False,
    chimeric: bool = False,
    kmer_bias: Optional[int] = None,
    strandness: Optional[float] = None,
    dna_type: str = "linear",
    min_len: int = 50,
    max_len: float = float("inf"),
    seed: int = 0,
    batch: int = 256,
    resume: bool = False,
    device="cuda",
) -> dict:
    """Genome-mode simulation (reference main genome branch,
    simulator.py:2226-2320): aligned then unaligned reads, linear or circular
    DNA (circular: one chromosome); kmer_bias switches the aligned pass to
    homopolymer mode (`-hp -k`); chimeric draws a segment count per aligned
    read and joins the segments with gap sequences (`--chimeric`; such a run
    cannot be resumed).  Returns counters for reporting.  Runs on the card
    unless `device` says otherwise."""
    _log("Read in reference")
    genome = PackedGenome.from_fasta(ref_g, dna_type=dna_type)
    if dna_type == "circular" and genome.n_chrom > 1:
        raise ValueError("Do not choose circular if there is more than one chromosome in the genome!")

    _log("Read profile")
    prof = profile_mod.load_profile(model_prefix, mode="genome", fastq=fastq, chimeric=chimeric,
                                    homopolymer=kmer_bias is not None, strandness=strandness)
    n_aligned, n_unaligned = profile_mod.split_aligned_unaligned(
        [number], prof.aligned_rate, False
    )
    n_aligned, n_unaligned = n_aligned[0], n_unaligned[0]

    ext = ".fastq" if fastq else ".fasta"

    _log("Start simulation of aligned reads")
    circular = dna_type == "circular"
    if chimeric:
        from .chimeric_mode import ChimericGenomeSimulator

        sim = ChimericGenomeSimulator(genome, prof, fastq=fastq, circular_dna=circular,
                                      min_len=min_len, max_len=max_len, batch=batch,
                                      kmer_bias=kmer_bias, device=device)
    else:
        sim = GenomeSimulator(genome, prof, fastq=fastq, circular_dna=circular, min_len=min_len,
                              max_len=max_len, batch=batch, kmer_bias=kmer_bias, device=device)
    state_path = out + "_aligned.resume.json"
    resuming = resume and os.path.exists(state_path)
    fw = output.FastxWriter(out + "_aligned_reads" + ext, fastq, append=resuming)
    el = output.ErrorLogWriter(out + "_aligned_error_profile", header=True, append=resuming)
    if chimeric:
        sim.run(n_aligned, output.ChimericBatchWriter(fw, el), seed=seed)
    else:
        writer = output.GenomeBatchWriter(fw, el)
        sim.run(n_aligned, writer, seed=seed, resume_state=state_path if resume else None)
    fw.close()
    el.close()

    if n_unaligned > 0:
        _log("Start simulation of random reads")
        usim = UnalignedSimulator(genome, prof, fastq=fastq, circular_dna=circular,
                                  min_len=min_len, max_len=max_len, batch=batch, device=device)
        ufw = output.FastxWriter(out + "_unaligned_reads" + ext, fastq)
        usim.run(n_unaligned, UnalignedBatchWriter(ufw), seed=seed)
        ufw.close()

    output.RUN_STATS.report(_log)
    _log("Finished!")
    return {"aligned": n_aligned, "unaligned": n_unaligned}
