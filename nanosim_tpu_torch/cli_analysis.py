"""Characterization CLI mirroring the reference's `read_analysis.py`
argparse tree (read_analysis.py:251-383): subcommands genome,
transcriptome, metagenome, quantify, detect_ir."""

from __future__ import annotations

import argparse
import sys
from textwrap import dedent

from . import __version__


def build_parser():
    parser = argparse.ArgumentParser(
        prog="nanosim-tpu-torch characterize",
        description=dedent(
            """
            Read characterization step
            -----------------------------------------------------------
            Given raw ONT reads, reference genome, transcriptome, and/or
            annotation file, learn read features and output profiles
            """
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version", version="nanosim-tpu-torch " + __version__)
    sub = parser.add_subparsers(dest="mode")

    g = sub.add_parser("genome", help="Run the simulator on genome mode")
    g.add_argument("-i", "--read", required=True, help="Input read for training")
    g.add_argument("-rg", "--ref_g", required=True, help="Reference genome")
    g.add_argument("-a", "--aligner", choices=["minimap2", "LAST"], default="minimap2")
    g.add_argument("-ga", "--g_alnm", default="", help="Pre-computed genome alignment (sam/maf)")
    g.add_argument("-o", "--output", default="training")
    g.add_argument("-c", "--chimeric", action="store_true", default=False)
    g.add_argument("-hp", "--homopolymer", action="store_true", default=False,
                   help="Analyze homopolymer lengths")
    g.add_argument("--min_homopolymer_len", type=int, default=5,
                   help="Minimum length of homopolymers to analyze (Default = 5 bp)")
    g.add_argument("--fastq", action="store_true", default=False)
    g.add_argument("--no_model_fit", dest="model_fit", action="store_false", default=True)
    g.add_argument("-t", "--num_threads", type=int, default=1)

    t = sub.add_parser("transcriptome", help="Run the simulator on transcriptome mode")
    t.add_argument("-i", "--read", required=True)
    t.add_argument("-rg", "--ref_g", default="")
    t.add_argument("-rt", "--ref_t", required=True)
    t.add_argument("-annot", "--annotation", default="")
    t.add_argument("-a", "--aligner", choices=["minimap2", "LAST"], default="minimap2")
    t.add_argument("-ga", "--g_alnm", default="")
    t.add_argument("-ta", "--t_alnm", default="")
    t.add_argument("-o", "--output", default="training")
    t.add_argument("-hp", "--homopolymer", action="store_true", default=False,
                   help="Analyze homopolymer lengths")
    t.add_argument("--min_homopolymer_len", type=int, default=5,
                   help="Minimum length of homopolymers to analyze (Default = 5 bp)")
    t.add_argument("--fastq", action="store_true", default=False)
    t.add_argument("-q", "--quantification", action="store_true", default=False)
    t.add_argument("-n", "--normalize", action="store_true", default=False,
                   help="Normalize by transcript length")
    t.add_argument("--no_model_fit", dest="model_fit", action="store_false", default=True)
    t.add_argument("--no_intron_retention", dest="model_ir", action="store_false", default=True)
    t.add_argument("-t", "--num_threads", type=int, default=1)

    m = sub.add_parser("metagenome", help="Run the simulator on metagenome mode")
    m.add_argument("-i", "--read", required=True)
    m.add_argument("-gl", "--genome_list", required=True)
    m.add_argument("-ga", "--g_alnm", default="")
    m.add_argument("-o", "--output", default="training")
    m.add_argument("-c", "--chimeric", action="store_true", default=False)
    m.add_argument("-q", "--quantification", action="store_true", default=False)
    m.add_argument("-hp", "--homopolymer", action="store_true", default=False,
                   help=argparse.SUPPRESS)
    m.add_argument("--min_homopolymer_len", type=int, default=5,
                   help=argparse.SUPPRESS)
    m.add_argument("--fastq", action="store_true", default=False)
    m.add_argument("--no_model_fit", dest="model_fit", action="store_false", default=True)
    m.add_argument("-t", "--num_threads", type=int, default=1)

    q = sub.add_parser("quantify", help="Quantify expression or abundance")
    q.add_argument("-e", dest="qmode", choices=["trans", "meta"], default="trans",
                   help="Quantify transcriptome expression OR metagenome abundance")
    q.add_argument("-i", "--read", required=True)
    q.add_argument("-rt", "--ref_t", default="")
    q.add_argument("-gl", "--genome_list", default="")
    q.add_argument("-ta", "--t_alnm", default="")
    q.add_argument("-ga", "--g_alnm", default="")
    q.add_argument("-o", "--output", default="expression")
    q.add_argument("-n", "--normalize", action="store_true", default=False,
                   help="Normalize by transcript length")
    q.add_argument("-t", "--num_threads", type=int, default=1)

    ir = sub.add_parser("detect_ir", help="Detect intron retention events")
    ir.add_argument("-annot", "--annotation", required=True)
    ir.add_argument("-i", "--read", default="")
    ir.add_argument("-rg", "--ref_g", default="")
    ir.add_argument("-rt", "--ref_t", default="")
    ir.add_argument("-a", "--aligner", choices=["minimap2", "LAST"], default="minimap2")
    ir.add_argument("-ga", "--g_alnm", default="")
    ir.add_argument("-ta", "--t_alnm", default="")
    ir.add_argument("-o", "--output", default="ir")
    ir.add_argument("-t", "--num_threads", type=int, default=1)

    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help(sys.stderr)
        sys.exit(1)

    from .characterization import main as char_main

    # -hp is a switch; --min_homopolymer_len sets the modeled run length
    # (read_analysis.py:281-283).  Internally homopolymer=None means off.
    hp = getattr(args, "min_homopolymer_len", 5) if getattr(args, "homopolymer", False) else None

    if args.mode == "genome":
        char_main.characterize_genome(
            args.read,
            args.ref_g,
            args.output,
            aligner=args.aligner,
            g_alnm=args.g_alnm,
            num_threads=args.num_threads,
            model_fit=args.model_fit,
            chimeric=args.chimeric,
            homopolymer=hp,
            fastq=args.fastq,
        )
    elif args.mode == "transcriptome":
        char_main.characterize_transcriptome(
            args.read,
            args.ref_g,
            args.ref_t,
            args.annotation,
            args.output,
            g_alnm=args.g_alnm,
            t_alnm=args.t_alnm,
            num_threads=args.num_threads,
            model_fit=args.model_fit,
            model_ir=args.model_ir,
            homopolymer=hp,
            quantification=args.quantification,
            normalize=args.normalize,
            fastq=args.fastq,
        )
    elif args.mode == "metagenome":
        char_main.characterize_metagenome(
            args.read,
            args.genome_list,
            args.output,
            g_alnm=args.g_alnm,
            num_threads=args.num_threads,
            model_fit=args.model_fit,
            chimeric=args.chimeric,
            quantification=args.quantification,
            homopolymer=hp,
            fastq=args.fastq,
        )
    elif args.mode == "quantify":
        char_main.quantify(
            args.read,
            args.ref_t,
            args.output,
            mode=args.qmode,
            genome_list=args.genome_list,
            t_alnm=args.t_alnm,
            g_alnm=args.g_alnm,
            num_threads=args.num_threads,
            normalize=args.normalize,
        )
    elif args.mode == "detect_ir":
        char_main.detect_ir(
            args.annotation,
            args.output,
            g_alnm=args.g_alnm,
            t_alnm=args.t_alnm,
            read_file=args.read,
            ref_g=args.ref_g,
            ref_t=args.ref_t,
            aligner=args.aligner,
            num_threads=args.num_threads,
        )


if __name__ == "__main__":
    main()
