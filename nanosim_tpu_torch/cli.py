"""Simulation CLI, mirroring the JAX package's (and the reference's
`simulator.py`) argparse surface: the genome sub-command with the same flags,
defaults and validation messages.  The PyTorch package runs it on the card.

Ported so far: linear and circular DNA (`-dna_type circular`), KDE read
lengths, FASTA/FASTQ with the error profile, homopolymer mode (`-hp -k`),
chimeric reads (`--chimeric`), `--resume`.  The transcriptome and metagenome
sub-commands, and the genome options not ported yet (--perfect, -med/-sd, -x,
multi-host), say so and exit non-zero.
"""

from __future__ import annotations

import argparse
import os
import sys
from textwrap import dedent

from . import __version__

NOT_PORTED_MODES = ("transcriptome", "metagenome")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="nanosim-tpu-torch simulate",
        description=dedent(
            """
            Simulation step
            -----------------------------------------------------------
            Given error profiles and a reference genome, simulate ONT DNA
            reads on a CUDA card
            """
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version",
                        version="nanosim-tpu-torch " + __version__)
    sub = parser.add_subparsers(dest="mode")

    g = sub.add_parser("genome", help="Run the simulator on genome mode")
    g.add_argument("-rg", "--ref_g", help="Input reference genome", required=True)
    g.add_argument("-c", "--model_prefix", default="training")
    g.add_argument("-o", "--output", default="simulated")
    g.add_argument("-n", "--number", type=int, default=20000)
    g.add_argument("-x", "--coverage", type=float, default=None)
    g.add_argument("-max", "--max_len", type=float, default=float("inf"))
    g.add_argument("-min", "--min_len", type=int, default=50)
    g.add_argument("-med", "--median_len", type=int, default=None)
    g.add_argument("-sd", "--sd_len", type=float, default=None)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("-hp", "--homopolymer", action="store_true", default=False)
    g.add_argument("-k", "--KmerBias", type=int, default=None)
    g.add_argument("-s", "--strandness", type=float, default=None)
    g.add_argument("-dna_type", choices=["linear", "circular"], default="linear")
    g.add_argument("--perfect", action="store_true", default=False)
    g.add_argument("--fastq", action="store_true", default=False)
    g.add_argument("--chimeric", action="store_true", default=False)
    g.add_argument("-t", "--num_threads", type=int, default=1)
    g.add_argument("--num_hosts", type=int, default=1,
                       help="shard the run over N cooperating host processes")
    g.add_argument("--host_id", type=int, default=0,
                       help="this process's rank in a multi-host run")
    g.add_argument("--coordinator", default=None,
                       help="coordinator address of a multi-host run (not ported yet)")
    g.add_argument("--resume", action="store_true", default=False,
                   help="continue an interrupted run from its checkpoint")
    g.add_argument("--batch", type=int, default=256, help="device batch size")

    for mode in NOT_PORTED_MODES:
        sub.add_parser(mode, help=f"{mode} mode (not ported yet)")

    return parser


def _validate_common(args, parser):
    if args.homopolymer and (args.KmerBias is None or args.KmerBias < 0):
        print(
            "\nPlease input proper kmer bias value >= 0 to simulate homopolymer contraction and "
            "expansion events from\n"
        )
        sys.exit(1)
    if args.strandness is not None and (args.strandness < 0 or args.strandness > 1):
        print("\nPlease input proper strandness value between 0 and 1\n")
        sys.exit(1)
    if args.max_len < args.min_len:
        sys.stderr.write("\nMaximum read length must be longer than Minimum read length!\n")
        sys.exit(1)


def _not_ported(what: str):
    sys.stderr.write(f"\n{what} is not ported to the PyTorch package yet\n")
    sys.exit(2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED_MODES:
        _not_ported(f"simulate {argv[0]}")
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help(sys.stderr)
        sys.exit(1)

    seed = int(args.seed) if args.seed else 0
    dir_name = os.path.dirname(args.output)
    if dir_name:
        os.makedirs(dir_name, exist_ok=True)

    _validate_common(args, parser)
    median = args.median_len
    sd = args.sd_len
    if (median and not sd) or (sd and not median):
        sys.stderr.write("\nPlease provide both mean and standard deviation of read length!\n")
        sys.exit(1)
    if median and sd and args.chimeric:
        sys.stderr.write("\nLognormal distributed reads cannot be chimeric!\n")
        sys.exit(1)
    if args.perfect and args.chimeric:
        print("\nPerfect reads cannot be chimeric\n")
        sys.exit(1)
    for flag, what in ((args.perfect, "--perfect"), (median is not None, "-med/-sd"),
                       (args.coverage is not None, "-x"), (args.num_hosts > 1, "--num_hosts")):
        if flag:
            _not_ported(what)

    from .sim.run import simulate_genome

    simulate_genome(
        args.ref_g,
        args.model_prefix,
        args.output,
        args.number,
        fastq=args.fastq,
        chimeric=args.chimeric,
        kmer_bias=args.KmerBias if args.homopolymer else None,
        strandness=args.strandness,
        dna_type=args.dna_type,
        min_len=args.min_len,
        max_len=args.max_len,
        seed=seed,
        batch=args.batch,
        resume=args.resume,
    )


if __name__ == "__main__":
    main()
