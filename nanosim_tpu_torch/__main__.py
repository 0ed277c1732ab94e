"""Command dispatcher: `python -m nanosim_tpu_torch <command> ...`

Commands:
  simulate       read simulation (genome, transcriptome and metagenome
                 modes; runs on a CUDA card)
  characterize   model fitting from real reads (read_analysis equivalent;
                 host code, runs on the CPU)
  quantify_paf   standalone PAF-based transcript abundance EM
"""

import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0 if len(sys.argv) >= 2 else 1)
    cmd = sys.argv[1]
    argv = sys.argv[2:]
    if cmd == "simulate":
        from .cli import main as m

        m(argv)
    elif cmd == "characterize":
        from .cli_analysis import main as m

        m(argv)
    elif cmd == "quantify_paf":
        from .characterization.paf_abundance import main as m

        m(argv)
    else:
        print(__doc__)
        sys.exit(1)


if __name__ == "__main__":
    main()
