"""Seconds from the process's start to the window's first job: imports,
bringing up the card, making the inputs from the seed, reading the FASTA
and the profile, building the simulators (tables, genome upload, the
kernels' libraries) and the warm-up job."""


def read(run):
    return run.setup_s
