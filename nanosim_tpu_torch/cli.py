"""Simulation CLI, mirroring the JAX package's (and the reference's
`simulator.py`) argparse surface: the genome sub-command with the same flags,
defaults and validation messages.  The PyTorch package runs it on the card.

Ported so far: the genome sub-command with linear and circular DNA
(`-dna_type circular`), KDE or lognormal (`-med/-sd`) read lengths, a read
count from a coverage (`-x`), FASTA/FASTQ with the error profile,
homopolymer mode (`-hp -k`), chimeric reads (`--chimeric`), perfect reads
(`--perfect`) and `--resume`; the transcriptome sub-command (cDNA, direct RNA
with `--uracil`, polyA tails, intron retention, `-hp -k`, `--perfect`, `-x`,
`--resume`); the metagenome sub-command (multi-species abundance with the
species-quota feedback, `--abun_var`, `--chimeric`, `--perfect`, `-hp -k`,
`-med/-sd`, `--resume`); and multi-host runs of all three (`--num_hosts`,
`--host_id`, `--coordinator`: one process per rank, or one process
emulating the ranks when no coordinator is given).
"""

from __future__ import annotations

import argparse
import os
import sys
from textwrap import dedent

from . import __version__

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
                       help="host:port of rank 0's process group")
    g.add_argument("--resume", action="store_true", default=False,
                   help="continue an interrupted run from its checkpoint")
    g.add_argument("--batch", type=int, default=256, help="device batch size")

    t = sub.add_parser("transcriptome", help="Run the simulator on transcriptome mode")
    t.add_argument("-rt", "--ref_t", required=True)
    t.add_argument("-rg", "--ref_g", default="")
    t.add_argument("-e", "--exp", required=True)
    t.add_argument("-c", "--model_prefix", default="training")
    t.add_argument("-o", "--output", default="simulated")
    t.add_argument("-n", "--number", type=int, default=20000)
    t.add_argument("-x", "--coverage", type=float, default=None)
    t.add_argument("-max", "--max_len", type=float, default=float("inf"))
    t.add_argument("-min", "--min_len", type=int, default=50)
    t.add_argument("--seed", type=int, default=None)
    t.add_argument("-hp", "--homopolymer", action="store_true", default=False)
    t.add_argument("-k", "--KmerBias", type=int, default=None)
    t.add_argument("-b", "--basecaller", choices=["albacore", "guppy"], default=None)
    t.add_argument("-s", "--strandness", type=float, default=None)
    t.add_argument("--no_model_ir", dest="model_ir", action="store_false", default=True)
    t.add_argument("--perfect", action="store_true", default=False)
    t.add_argument("--polya", default=None)
    t.add_argument("--fastq", action="store_true", default=False)
    t.add_argument("-t", "--num_threads", type=int, default=1)
    t.add_argument("--num_hosts", type=int, default=1,
                   help="shard the run over N cooperating host processes")
    t.add_argument("--host_id", type=int, default=0,
                   help="this process's rank in a multi-host run")
    t.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's process group")
    t.add_argument("--uracil", action="store_true", default=False)
    t.add_argument("--resume", action="store_true", default=False,
                   help="continue an interrupted run from its checkpoint")
    t.add_argument("--batch", type=int, default=256)

    m = sub.add_parser("metagenome", help="Run the simulator on metagenome mode")
    m.add_argument("-gl", "--genome_list", required=True)
    m.add_argument("-a", "--abun", required=True)
    m.add_argument("-dl", "--dna_type_list", default=None)
    m.add_argument("-c", "--model_prefix", default="training")
    m.add_argument("-o", "--output", default="simulated")
    m.add_argument("-max", "--max_len", type=float, default=float("inf"))
    m.add_argument("-min", "--min_len", type=int, default=50)
    m.add_argument("-med", "--median_len", type=int, default=None)
    m.add_argument("-sd", "--sd_len", type=float, default=None)
    m.add_argument("--seed", type=int, default=None)
    m.add_argument("-hp", "--homopolymer", action="store_true", default=False)
    m.add_argument("-k", "--KmerBias", type=int, default=None)
    m.add_argument("-s", "--strandness", type=float, default=None)
    m.add_argument("--perfect", action="store_true", default=False)
    m.add_argument("--abun_var", nargs="+", type=float, default=None)
    m.add_argument("--fastq", action="store_true", default=False)
    m.add_argument("--chimeric", action="store_true", default=False)
    m.add_argument("-t", "--num_threads", type=int, default=1)
    m.add_argument("--num_hosts", type=int, default=1,
                   help="shard the run over N cooperating host processes")
    m.add_argument("--host_id", type=int, default=0,
                   help="this process's rank in a multi-host run")
    m.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's process group")
    m.add_argument("--resume", action="store_true", default=False,
                   help="continue an interrupted run from its checkpoint")
    m.add_argument("--batch", type=int, default=256)

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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
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
    if args.mode == "transcriptome":
        _transcriptome(args, seed)
        return
    if args.mode == "metagenome":
        _metagenome(args, seed)
        return
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

    from .sim.run import calculate_read_number_from_coverage, simulate_genome

    number = args.number
    if args.coverage is not None:
        number = calculate_read_number_from_coverage(args.ref_g, args.model_prefix,
                                                     args.coverage)
    simulate_genome(
        args.ref_g,
        args.model_prefix,
        args.output,
        number,
        fastq=args.fastq,
        perfect=args.perfect,
        chimeric=args.chimeric,
        kmer_bias=args.KmerBias if args.homopolymer else None,
        strandness=args.strandness,
        dna_type=args.dna_type,
        min_len=args.min_len,
        max_len=args.max_len,
        median_len=median,
        sd_len=sd,
        seed=seed,
        batch=args.batch,
        n_hosts=args.num_hosts,
        host_id=args.host_id,
        coordinator=args.coordinator,
        resume=args.resume,
    )


def _transcriptome(args, seed: int):
    if args.model_ir and args.ref_g == "":
        sys.stderr.write(
            "\nPlease provide a reference genome to simulate intron retention events!\n")
        sys.exit(1)
    if args.polya and args.basecaller is None:
        print("\nPlease input basecaller to simulate polyA tails from.\n")
        sys.exit(1)

    from .sim.run import calculate_read_number_from_coverage
    from .sim.run_transcriptome import simulate_transcriptome

    number = args.number
    if args.coverage is not None:
        number = calculate_read_number_from_coverage(args.ref_t, args.model_prefix,
                                                     args.coverage)
    simulate_transcriptome(
        args.ref_t,
        args.ref_g,
        args.exp,
        args.model_prefix,
        args.output,
        number,
        perfect=args.perfect,
        fastq=args.fastq,
        kmer_bias=args.KmerBias if args.homopolymer else None,
        homopolymer=args.homopolymer,
        strandness=args.strandness,
        model_ir=args.model_ir,
        polya=args.polya,
        basecaller=args.basecaller,
        uracil=args.uracil,
        min_len=args.min_len,
        max_len=args.max_len,
        seed=seed,
        batch=args.batch,
        n_hosts=args.num_hosts,
        host_id=args.host_id,
        coordinator=args.coordinator,
        resume=args.resume,
    )


def _metagenome(args, seed: int):
    if (args.median_len and not args.sd_len) or (args.sd_len and not args.median_len):
        sys.stderr.write("\nPlease provide both mean and standard deviation of read length!\n")
        sys.exit(1)
    if args.median_len and args.sd_len and args.chimeric:
        sys.stderr.write("\nLognormal distributed reads cannot be chimeric!\n")
        sys.exit(1)
    if args.perfect and args.chimeric:
        print("\nPerfect reads cannot be chimeric\n")
        sys.exit(1)

    from .sim.run_metagenome import simulate_metagenome

    simulate_metagenome(
        args.genome_list,
        args.abun,
        args.dna_type_list,
        args.model_prefix,
        args.output,
        perfect=args.perfect,
        fastq=args.fastq,
        chimeric=args.chimeric,
        kmer_bias=args.KmerBias if args.homopolymer else None,
        homopolymer=args.homopolymer,
        strandness=args.strandness,
        abun_var=args.abun_var,
        min_len=args.min_len,
        max_len=args.max_len,
        median_len=args.median_len,
        sd_len=args.sd_len,
        seed=seed,
        batch=args.batch,
        n_hosts=args.num_hosts,
        host_id=args.host_id,
        coordinator=args.coordinator,
        resume=args.resume,
    )


if __name__ == "__main__":
    main()
