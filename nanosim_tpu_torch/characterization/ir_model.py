"""Intron-retention model fitting (model_intron_retention.py).

From a GFF3 with introns + primary genome and transcriptome alignments:
per-read intron coverage (a read retains an intron when its gapless aligned
blocks cover the intron's full length), first-intron state and transition
counts -> `_IR_markov_model` (+ `_IR_info`).  Interval intersection is plain
per-transcript arithmetic instead of HTSeq's GenomicArrayOfSets.
"""

from __future__ import annotations

import sys
from time import strftime

from ..profiles.profile import load_transcript_structures
from . import sam as sam_mod


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def aligned_blocks(rec: sam_mod.SamRecord):
    """Gapless (M/=/X) reference blocks, split at D and N like pysam's
    get_blocks (model_intron_retention.py:75-82)."""
    blocks = []
    pos = rec.pos
    start = None
    for n, op in rec.cigar_ops():
        if op in "M=X":
            if start is None:
                start = pos
            pos += n
        elif op in "DN":
            if start is not None:
                blocks.append((start, pos))
                start = None
            pos += n
        # I, S, H don't advance the reference
    if start is not None:
        blocks.append((start, pos))
    return blocks


def intron_retention(outfile: str, gff_file: str, g_alnm: str, t_alnm: str):
    _log("Reading intron coordinates from GFF file")
    structures = load_transcript_structures(gff_file)
    dict_intron_info = {}
    introns_by_chrom = {}
    for trx, feats in structures.by_transcript.items():
        dict_intron_info.setdefault(trx, [])
        for ftype, chrom, start, end, length, strand in feats:
            if ftype == "intron":
                dict_intron_info[trx].append((start, end, length))
                introns_by_chrom.setdefault((chrom, trx), []).append((start, end))

    _log("Read primary genome alignment for each read")
    dict_g_alnm = {}
    for kind, rec in sam_mod.read_sam(g_alnm):
        if kind != "aln" or rec.is_unmapped:
            continue
        chrom = rec.rname
        if "chr" in chrom:
            chrom = chrom.strip("chr")
        dict_g_alnm[rec.qname] = (chrom, aligned_blocks(rec))

    _log("Read primary transcriptome alignment for each read")
    dict_t_alnm = {}
    for kind, rec in sam_mod.read_sam(t_alnm):
        if kind != "aln" or rec.is_unmapped:
            continue
        tname = rec.rname
        if tname.startswith("ENST"):
            tname = tname.split(".")[0]
        dict_t_alnm[rec.qname] = tname

    _log("Calculating probabilities for each intron retention event")
    first_state = {False: 0, True: 0}
    states = {(False, False): 0, (False, True): 0, (True, False): 0, (True, True): 0}
    dict_ir_info = {}

    for qname, (chrom, blocks) in dict_g_alnm.items():
        if qname not in dict_t_alnm:
            continue
        trx = dict_t_alnm[qname]
        dict_ir_info.setdefault(trx, [])
        introns = dict_intron_info.get(trx, [])
        if not introns:
            continue

        # an intron is retained when the read's blocks cover its full length
        retained = []
        for spos, epos, length in introns:
            covered = 0
            for bs, be in blocks:
                covered += max(0, min(be, epos) - max(bs, spos))
            retained.append(covered == length and length > 0)

        if not any(retained):
            first_state[False] += 1
            for _ in range(1, len(introns)):
                states[(False, False)] += 1
        else:
            prev = retained[0]
            first_state[retained[0]] += 1
            if retained[0]:
                dict_ir_info[trx].append((introns[0][0], introns[0][1]))
            for i in range(1, len(introns)):
                cur = retained[i]
                if cur:
                    dict_ir_info[trx].append((introns[i][0], introns[i][1]))
                states[(prev, cur)] += 1
                prev = cur

    sum_first = first_state[True] + first_state[False]
    sum_no = states[(False, False)] + states[(False, True)]
    sum_ir = states[(True, False)] + states[(True, True)]

    with open(outfile + "_IR_markov_model", "w") as f:
        f.write("succedent\tno_IR\tIR\n")
        if sum_first:
            f.write(
                f"start\t{round(first_state[False] / sum_first, 4)}\t"
                f"{round(first_state[True] / sum_first, 4)}\n"
            )
        else:
            f.write("start\t0.0\t0.0\n")
        if sum_no:
            f.write(
                f"no_IR\t{round(states[(False, False)] / sum_no, 4)}\t"
                f"{round(states[(False, True)] / sum_no, 4)}\n"
            )
        else:
            f.write("no_IR\t0.0\t0.0\n")
        if sum_ir:
            f.write(
                f"IR\t{round(states[(True, False)] / sum_ir, 4)}\t"
                f"{round(states[(True, True)] / sum_ir, 4)}\n"
            )
        else:
            f.write("IR\t0.0\t0.0\n")

    with open(outfile + "_IR_info", "w") as f:
        f.write("trx_name\tintron_spos\tintron_epos\n")
        for trx, items in dict_ir_info.items():
            if items:
                srt = sorted(set(items))
                f.write(
                    trx
                    + "\t"
                    + ",".join(str(s) for s, _ in srt)
                    + "\t"
                    + ",".join(str(e) for _, e in srt)
                    + "\n"
                )
