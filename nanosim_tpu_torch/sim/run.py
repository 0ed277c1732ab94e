"""Top-level simulation runs: the equivalent of the reference's `simulation`
orchestrator (simulator.py:1571-1672) for genome mode.  Multi-host runs shard
slot ranges over ranks instead (see parallel/)."""

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
    perfect: bool = False,
    chimeric: bool = False,
    kmer_bias: Optional[int] = None,
    strandness: Optional[float] = None,
    dna_type: str = "linear",
    min_len: int = 50,
    max_len: float = float("inf"),
    median_len: Optional[float] = None,
    sd_len: Optional[float] = None,
    seed: int = 0,
    batch: int = 256,
    n_hosts: int = 1,
    host_id: int = 0,
    coordinator: Optional[str] = None,
    resume: bool = False,
    device="cuda",
) -> dict:
    """Genome-mode simulation (reference main genome branch,
    simulator.py:2226-2320): aligned then unaligned reads, linear or circular
    DNA (circular: one chromosome); kmer_bias switches the aligned pass to
    homopolymer mode (`-hp -k`); chimeric draws a segment count per aligned
    read and joins the segments with gap sequences (`--chimeric`; such a run
    cannot be resumed); perfect reads (`--perfect`) carry no error, no head
    or tail, and have no unaligned pass; median_len and sd_len (`-med/-sd`)
    draw both passes' lengths from a lognormal instead of the model's KDEs.
    Returns counters for reporting.  Runs on the card unless `device` says
    otherwise.

    Multi-host (n_hosts > 1): this process is rank host_id; it simulates its
    shard of every batch and writes `{out}_..._h{host_id}` files (the aligned
    reads, the error profile, whose header host 0 writes, and the unaligned
    reads); concatenating the ranks' shards gives the single-host output up
    to record order.  With `coordinator` (host:port of rank 0's process
    group) the ranks are processes that exchange their counts; without it
    this process emulates the other ranks.  Such a run cannot be resumed."""
    if perfect and chimeric:
        raise ValueError("Perfect reads cannot be chimeric")
    if median_len is not None and chimeric:
        raise ValueError("Lognormal distributed reads cannot be chimeric")
    _log("Read in reference")
    genome = PackedGenome.from_fasta(ref_g, dna_type=dna_type)
    if dna_type == "circular" and genome.n_chrom > 1:
        raise ValueError("Do not choose circular if there is more than one chromosome in the genome!")

    _log("Read profile")
    prof = profile_mod.load_profile(model_prefix, mode="genome", perfect=perfect, fastq=fastq,
                                    chimeric=chimeric, homopolymer=kmer_bias is not None,
                                    strandness=strandness)
    n_aligned, n_unaligned = profile_mod.split_aligned_unaligned(
        [number], prof.aligned_rate, perfect
    )
    n_aligned, n_unaligned = n_aligned[0], n_unaligned[0]

    ext = ".fastq" if fastq else ".fasta"

    _log("Start simulation of aligned reads")
    multi = n_hosts > 1
    if multi:
        from ..parallel import MultiHostModeRunner, init_distributed, rank_device

        init_distributed(coordinator, n_hosts if coordinator else None, host_id)
        device = rank_device(device, host_id)
    tag = f"_h{host_id}" if multi else ""
    circular = dna_type == "circular"
    if chimeric:
        from .chimeric_mode import ChimericGenomeSimulator

        sim = ChimericGenomeSimulator(genome, prof, fastq=fastq, circular_dna=circular,
                                      min_len=min_len, max_len=max_len, batch=batch,
                                      kmer_bias=kmer_bias, device=device)
    else:
        sim = GenomeSimulator(genome, prof, fastq=fastq, circular_dna=circular, min_len=min_len,
                              max_len=max_len, batch=batch, kmer_bias=kmer_bias,
                              perfect=perfect, median_len=median_len, sd_len=sd_len,
                              device=device)
    state_path = out + "_aligned.resume.json"
    resuming = resume and not multi and os.path.exists(state_path)
    fw = output.FastxWriter(out + "_aligned_reads" + tag + ext, fastq, append=resuming)
    el = output.ErrorLogWriter(out + "_aligned_error_profile" + tag, header=(host_id == 0),
                               append=resuming)
    if chimeric:
        writer = output.ChimericBatchWriter(fw, el)
        if multi:
            MultiHostModeRunner(sim, n_hosts, host_id).run(n_aligned, writer, seed=seed)
        else:
            sim.run(n_aligned, writer, seed=seed)
    else:
        writer = output.GenomeBatchWriter(fw, el, perfect=perfect)
        if multi:
            MultiHostModeRunner(sim, n_hosts, host_id, full_events=True).run(
                n_aligned, writer, seed=seed)
        else:
            sim.run(n_aligned, writer, seed=seed, resume_state=state_path if resume else None)
    fw.close()
    el.close()

    if not perfect and n_unaligned > 0:
        _log("Start simulation of random reads")
        usim = UnalignedSimulator(genome, prof, fastq=fastq, circular_dna=circular,
                                  min_len=min_len, max_len=max_len, median_len=median_len,
                                  sd_len=sd_len, batch=batch, device=device)
        ufw = output.FastxWriter(out + "_unaligned_reads" + tag + ext, fastq)
        if multi:
            # sharded like the aligned pass, on the unaligned stream's slots
            MultiHostModeRunner(usim, n_hosts, host_id).run(n_unaligned,
                                                            UnalignedBatchWriter(ufw), seed=seed)
        else:
            usim.run(n_unaligned, UnalignedBatchWriter(ufw), seed=seed)
        ufw.close()

    output.RUN_STATS.report(_log)
    _log("Finished!")
    return {"aligned": n_aligned, "unaligned": 0 if perfect else n_unaligned}


def calculate_read_number_from_coverage(reference_path, model_prefix, coverage,
                                        n_estimation=10_000_000):
    """Lander/Waterman read count for a requested coverage (`-x`) via Monte
    Carlo mean read length (calculate_read_number_from_coverage,
    simulator.py:2024-2068)."""
    import numpy as np

    from ..profiles import error_model, kde

    reference_size = 0
    with open(reference_path) as f:
        for line in f:
            if not line.startswith(">"):
                reference_size += len(line.strip())

    alignment_rate = error_model.read_alignment_rate(model_prefix + "_reads_alignment_rate")
    if alignment_rate is None:
        alignment_rate = 1.0  # "100%": everything aligned

    rng_np = np.random.default_rng(0)
    aligned_n = int(n_estimation * alignment_rate / (alignment_rate + 1))
    k_aligned = kde.load_kde(model_prefix + "_aligned_reads.pkl")
    samples = k_aligned.sample(rng_np, aligned_n)[:, 0]
    k_unaligned = kde.load_kde(model_prefix + "_unaligned_length.pkl")
    samples = np.append(samples, k_unaligned.sample(rng_np, n_estimation - aligned_n)[:, 0])
    mean = samples.mean()
    return int(reference_size / mean * coverage)
