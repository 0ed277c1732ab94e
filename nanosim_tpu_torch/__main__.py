"""Command dispatcher: `python -m nanosim_tpu_torch <command> ...`

Commands:
  simulate       read simulation (genome, transcriptome and metagenome
                 modes; runs on a CUDA card)

The JAX package's other commands (characterize, quantify_paf) are not ported
yet.
"""

import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0 if len(sys.argv) >= 2 else 1)
    cmd = sys.argv[1]
    if cmd == "simulate":
        from .cli import main as m

        m(sys.argv[2:])
    elif cmd in ("characterize", "quantify_paf"):
        sys.stderr.write(f"{cmd} is not ported to the PyTorch package yet\n")
        sys.exit(2)
    else:
        print(__doc__)
        sys.exit(1)


if __name__ == "__main__":
    main()
