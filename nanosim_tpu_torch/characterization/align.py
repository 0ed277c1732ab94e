"""Alignment orchestration + annotation preprocessing.

Runs minimap2 (SAM output with cs tags, no samtools needed — we parse SAM
text) or LAST (MAF), mirroring read_analysis.py:76-248.  The GenomeTools
GTF->GFF3 + `-addintrons` + bequeath.lua chain is replaced by a native
intron annotator: introns are synthesized between consecutive exons of each
transcript and inherit its transcript_id, producing the same
`_added_intron_final.gff3` contract.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from time import strftime

from ..io.fastx import gzopen

# the source column of the annotation that add_introns_to_annotation writes:
# the project's name with an underscore, the value the JAX package writes
# too, so that both packages' annotation files are the same bytes (the one
# line that tests/test_torch_port_rules.py lets name the JAX package)
GFF_SOURCE = "nanosim_tpu"


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def have_tool(name: str) -> bool:
    return shutil.which(name) is not None


def run_minimap2(ref: str, reads: str, out_sam: str, preset: str = "map-ont", threads: int = 1):
    """minimap2 --cs -ax <preset> (read_analysis.py:84,136,170)."""
    if not have_tool("minimap2"):
        raise RuntimeError(
            "minimap2 not found on PATH; supply a pre-computed alignment with -ga/-ta"
        )
    cmd = ["minimap2", "--cs", "-a", "-x", preset, "-t", str(threads), ref, reads]
    _log(" ".join(cmd))
    with open(out_sam, "w") as out:
        subprocess.run(cmd, stdout=out, check=True)


def run_last(ref: str, reads: str, out_maf: str, prefix: str):
    """lastdb + lastal (read_analysis.py:92-93,144-145,177-178)."""
    if not (have_tool("lastdb") and have_tool("lastal")):
        raise RuntimeError("LAST (lastdb/lastal) not found on PATH")
    db = prefix + "_lastdb"
    subprocess.run(["lastdb", db, ref], check=True)
    with open(out_maf, "w") as out:
        ps = subprocess.Popen(["lastal", "-a", "1", db, reads], stdout=subprocess.PIPE)
        grep = subprocess.Popen(["grep", "-v", "^#"], stdin=ps.stdout, stdout=out)
        grep.communicate()


def besthit_and_unaligned(reads_fa: str, maf_path: str, prefix: str):
    """Longest alignment per read from a MAF; unaligned lengths from the
    reads FASTA (get_besthit_maf.py:8-56).

    Returns (unaligned_len list, strandness)."""
    import numpy as np

    align_dict = {}
    with gzopen(maf_path) as f:
        for line in f:
            query = next(f)
            qi = query.strip().split()
            if qi[1] not in align_dict or align_dict[qi[1]][0] < int(qi[3]):
                align_dict[qi[1]] = [int(qi[3]), query, False]

    pos_strand = 0
    num_aligned = 0
    with gzopen(maf_path) as f, open(prefix + "_besthit.maf", "w") as out:
        for line in f:
            ref_info = line.split()
            query = next(f)
            qi = query.split()
            name = qi[1]
            if align_dict[name][0] == int(qi[3]) and not align_dict[name][2]:
                out.write(line + query)
                align_dict[name][2] = True
                num_aligned += 1
                if ref_info[4] == qi[4]:
                    pos_strand += 1

    unaligned_len = []
    with gzopen(reads_fa) as f:
        flag = False
        for line in f:
            if line[0] == ">":
                name = line.strip().split()[0][1:]
                flag = name not in align_dict
            elif flag:
                unaligned_len.append(len(line.strip()))

    strandness = pos_strand / max(num_aligned, 1)
    return np.array(unaligned_len), strandness


def sam_to_maf(primary_sam: str, out_maf: str, ref_fasta: str):
    """Pairwise MAF records from cs-tagged primary SAM alignments (replaces
    the sam2pairwise + pairwise2maf chain, read_analysis.py:126-127,203-204).

    The cs long/short tag encodes the full pairwise alignment; with the
    reference FASTA we reconstruct both gapped rows.
    """
    import re

    from ..io.genome import PackedGenome
    from . import sam as sam_mod

    genome = PackedGenome.from_fasta(ref_fasta)
    name_idx = {}
    for i, nm in enumerate(genome.names):
        name_idx[nm] = i
    cs_re = re.compile(r"(:[0-9]+|\*[a-z][a-z]|[=\+\-][A-Za-z]+)")

    with open(out_maf, "w") as out:
        for kind, aln in sam_mod.read_sam(primary_sam):
            if kind != "aln" or aln.is_unmapped or "cs" not in aln.tags:
                continue
            from ..io.fastx import mangle_name

            ci = name_idx.get(mangle_name(aln.rname))
            if ci is None:
                continue
            rstart = aln.reference_start
            rlen = aln.reference_length
            ref_seq = genome.slice(ci, rstart, rlen).tobytes().decode()
            read_seq = aln.seq[aln.query_alignment_start : aln.query_alignment_end]

            ref_row, read_row = [], []
            ri = qi = 0
            for item in cs_re.findall(aln.tags["cs"]):
                op = item[0]
                if op == ":":
                    n = int(item[1:])
                    ref_row.append(ref_seq[ri : ri + n])
                    read_row.append(read_seq[qi : qi + n])
                    ri += n
                    qi += n
                elif op == "*":
                    ref_row.append(ref_seq[ri : ri + 1])
                    read_row.append(read_seq[qi : qi + 1])
                    ri += 1
                    qi += 1
                elif op == "+":
                    n = len(item) - 1
                    ref_row.append("-" * n)
                    read_row.append(read_seq[qi : qi + n])
                    qi += n
                elif op == "-":
                    n = len(item) - 1
                    ref_row.append(ref_seq[ri : ri + n])
                    read_row.append("-" * n)
                    ri += n
            ref_gapped = "".join(ref_row)
            read_gapped = "".join(read_row)
            qalign = len(read_seq)
            direction = "-" if aln.is_reverse else "+"
            out.write(f"s {aln.rname} {rstart} {rlen} + * {ref_gapped}\n")
            out.write(
                f"s {aln.qname} {aln.query_alignment_start} {qalign} {direction} "
                f"{aln.infer_read_length()} {read_gapped}\n"
            )


def add_introns_to_annotation(annot_path: str, out_gff: str):
    """Native `gt gtf_to_gff3 | gt -addintrons | bequeath` replacement
    (read_analysis.py:208-232 + bequeath.lua): write exon features with
    transcript_id attributes and synthesize introns between consecutive
    exons of each transcript."""
    # parse GTF or GFF3 exons grouped per transcript
    exons = {}  # trx -> [(chrom, start0, end, strand)]
    order = []
    with gzopen(annot_path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9 or cols[2] != "exon":
                continue
            attrs = cols[8]
            trx = None
            if "transcript_id" in attrs:
                import re as _re

                m = _re.search(r'transcript_id[ =]"?([^";]+)"?', attrs)
                if m:
                    trx = m.group(1)
            if trx is None and "Parent=" in attrs:
                for item in attrs.split(";"):
                    if item.startswith("Parent="):
                        trx = item[7:].split(":")[-1]
            if trx is None:
                continue
            if trx not in exons:
                exons[trx] = []
                order.append(trx)
            exons[trx].append((cols[0], int(cols[3]) - 1, int(cols[4]), cols[6]))

    with open(out_gff, "w") as out:
        out.write("##gff-version 3\n")
        for trx in order:
            feats = sorted(exons[trx], key=lambda x: x[1])
            for i, (chrom, s, e, strand) in enumerate(feats):
                out.write(
                    f"{chrom}\t{GFF_SOURCE}\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t"
                    f"transcript_id={trx}\n"
                )
                if i < len(feats) - 1:
                    nxt = feats[i + 1]
                    if nxt[1] > e:
                        out.write(
                            f"{chrom}\t{GFF_SOURCE}\tintron\t{e + 1}\t{nxt[1]}\t.\t{strand}\t.\t"
                            f"transcript_id={trx}\n"
                        )
