"""The route of a simulation pass, decided in one place for every mode.

Route A runs the meta-only program and reconstructs the reads on the host
(the C++ walk replay and emitter); Route B runs the read-emitting program
and moves the reads off the card."""

import os

RECON_MODES = ("genome", "chimeric", "metagenome", "transcriptome", "unaligned")


def want_recon(mode: str, *, circular_dna: bool = False, hp: bool = False,
               direct_rna: bool = False) -> bool:
    """Whether a pass of `mode` (one of RECON_MODES) runs the meta-only
    program with host reconstruction (Route A) rather than the read-emitting
    program (Route B).  The only reader of NANOSIM_TPU_RECON: 0 sends every
    pass to Route B.  Otherwise the reconstruction covers linear DNA: circular
    genome, chimeric and unaligned passes leave it, while the metagenome and
    transcriptome passes count as linear.  Homopolymer mode (`hp`) stays on
    it in genome mode: a genome simulator with kmer_bias always holds the hp
    tables the host needs (its constructor refuses a profile without them);
    the chimeric, metagenome and transcriptome reconstructions resize no
    runs, so their `-hp` passes leave it (unaligned reads have no `-hp`
    step).  Direct-RNA reads of the unaligned pass leave it: they carry 'U'
    for 'T', which the host reconstruction does not write."""
    if mode not in RECON_MODES:
        raise ValueError(f"unknown pass mode {mode!r}")
    if os.environ.get("NANOSIM_TPU_RECON", "1") == "0":
        return False
    if circular_dna and mode not in ("metagenome", "transcriptome"):
        return False
    if hp and mode not in ("genome", "unaligned"):
        return False
    return not (direct_rna and mode == "unaligned")
