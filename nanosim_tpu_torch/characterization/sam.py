"""Minimal SAM text parser (pysam replacement for the characterization
pipeline).

Parses only what the pipeline needs: header SQ entries, flags, CIGAR-derived
coordinates, and the NM/SA/cs/MD tags.  Gzip-transparent.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from ..io.fastx import gzopen

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 0-based reference start
    mapq: int
    cigar: str
    seq: str
    qual: str
    tags: dict
    line: str  # raw line for pass-through writing

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    def cigar_ops(self):
        return [(int(n), op) for n, op in _CIGAR_RE.findall(self.cigar)]

    def _clips(self):
        ops = self.cigar_ops()
        head = ops[0][0] if ops and ops[0][1] in "SH" else 0
        tail = ops[-1][0] if len(ops) > 1 and ops[-1][1] in "SH" else 0
        return head, tail

    @property
    def query_alignment_start(self) -> int:
        ops = self.cigar_ops()
        return ops[0][0] if ops and ops[0][1] == "S" else 0

    @property
    def query_alignment_length(self) -> int:
        return sum(n for n, op in self.cigar_ops() if op in "MI=X")

    @property
    def query_alignment_end(self) -> int:
        return self.query_alignment_start + self.query_alignment_length

    @property
    def query_length(self) -> int:
        """Length of SEQ (soft clips included, hard clips not)."""
        if self.seq != "*":
            return len(self.seq)
        return sum(n for n, op in self.cigar_ops() if op in "MIS=X")

    def infer_read_length(self) -> int:
        """Full read length including hard clips (pysam semantics)."""
        return sum(n for n, op in self.cigar_ops() if op in "MIS=XH")

    @property
    def reference_length(self) -> int:
        return sum(n for n, op in self.cigar_ops() if op in "MDN=X")

    @property
    def reference_start(self) -> int:
        return self.pos

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length

    def get_tag(self, name: str):
        if name not in self.tags:
            raise KeyError(name)
        return self.tags[name]

    def has_tag(self, name: str) -> bool:
        return name in self.tags

    def query_qualities(self):
        if self.qual == "*":
            return None
        return [ord(c) - 33 for c in self.qual]


def _parse_tags(fields) -> dict:
    tags = {}
    for f in fields:
        name, typ, val = f.split(":", 2)
        if typ == "i":
            tags[name] = int(val)
        elif typ == "f":
            tags[name] = float(val)
        else:
            tags[name] = val
    return tags


def read_sam(path: str):
    """Yield ('header', line) and ('aln', SamRecord) items.

    Accepts SAM text (plain or gzipped) or BAM (BGZF) — pysam.AlignmentFile's
    ingestion surface (read_analysis.py:192-198), detected by content."""
    from . import bam as bam_mod

    if bam_mod.is_bam(path):
        yield from bam_mod.read_bam(path)
        return
    with gzopen(path) as f:
        for line in f:
            if line.startswith("@"):
                yield "header", line.rstrip("\n")
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            yield "aln", SamRecord(
                qname=fields[0],
                flag=int(fields[1]),
                rname=fields[2],
                pos=int(fields[3]) - 1,
                mapq=int(fields[4]),
                cigar=fields[5],
                seq=fields[9],
                qual=fields[10],
                tags=_parse_tags(fields[11:]),
                line=line.rstrip("\n"),
            )


def read_sq_lengths(path: str) -> dict:
    """Reference name -> length from @SQ headers (or the BAM reference list)."""
    from . import bam as bam_mod

    if bam_mod.is_bam(path):
        return bam_mod.read_bam_sq_lengths(path)
    out = {}
    with gzopen(path) as f:
        for line in f:
            if not line.startswith("@"):
                break
            if line.startswith("@SQ"):
                name = ln = None
                for fld in line.rstrip("\n").split("\t")[1:]:
                    if fld.startswith("SN:"):
                        name = fld[3:]
                    elif fld.startswith("LN:"):
                        ln = int(fld[3:])
                if name is not None:
                    out[name] = ln
    return out


class SamWriter:
    """Pass-through SAM writer (the '_primary' output is SAM text, not BAM —
    this environment has no htslib; downstream stages read it natively)."""

    def __init__(self, path: str, header_lines):
        self.f = open(path, "w")
        for line in header_lines:
            self.f.write(line + "\n")

    def write(self, rec: SamRecord):
        self.f.write(rec.line + "\n")

    def close(self):
        self.f.close()
