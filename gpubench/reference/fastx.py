"""FASTA/FASTQ streaming parser (readfq-equivalent) with numpy fast paths.

Semantics match the reference's readfq (simulator.py:709-740, itself from
lh3/readfq): record names are the first whitespace-separated token; FASTQ
quality blocks are length-matched to the sequence.
"""

from __future__ import annotations

import gzip
import re


def gzopen(path: str, mode: str = "rt"):
    """Transparent gzip/plain open (reference: file_handler.py:6-9)."""
    if path.endswith(".gz"):
        return gzip.open(path, mode, compresslevel=1)
    return open(path, mode)


def read_fastx(path: str):
    """Yield (name, seq, qual_or_None) records.

    Generator over FASTA or FASTQ, gzip-transparent; same record semantics as
    the reference's readfq.
    """
    with gzopen(path) as fp:
        last = None
        while True:
            if not last:
                for line in fp:
                    if line[0] in ">@":
                        last = line[:-1]
                        break
            if not last:
                break
            name, seqs, last = last[1:].partition(" ")[0], [], None
            for line in fp:
                if line[0] in "@+>":
                    last = line[:-1]
                    break
                seqs.append(line[:-1])
            if not last or last[0] != "+":
                yield name, "".join(seqs), None
                if not last:
                    break
            else:
                seq, leng, seqs = "".join(seqs), 0, []
                for line in fp:
                    seqs.append(line[:-1])
                    leng += len(line) - 1
                    if leng >= len(seq):
                        last = None
                        yield name, seq, "".join(seqs)
                        break
                if last:
                    yield name, seq, None
                    break


_SPLIT_RE = re.compile(r"[_\s]\s*")


def mangle_name(raw_name: str) -> str:
    """Reference chromosome-name normalization (simulator.py:344-346):
    underscores -> dashes, then strip everything after the first dot."""
    return "-".join(_SPLIT_RE.split(raw_name)).split(".")[0]
