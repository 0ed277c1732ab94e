"""Read-length model fitting (head_align_tail_dist.py).

From primary alignments: total read length, aligned (middle) length, head/
tail soft-clips (minimum across split alignments; genome-alignment clips
joined for transcriptome), circular-read merging — then the five KDE models
(aligned region bw=10, aligned reads bw=10, log10 head+tail bw=0.01,
head/(head+tail) ratio bw=0.01, 2D Silverman for transcriptome).
"""

from __future__ import annotations

import sys
from time import strftime

import numpy as np

from ..profiles.kde import save_kde
from . import sam as sam_mod
from .primary import edge_checker
from ..io.fastx import gzopen


def _get_head_tail(rec: sam_mod.SamRecord):
    ops = rec.cigar_ops()
    head = ops[0][0] if ops and ops[0][1] in "SH" else 0
    tail = ops[-1][0] if len(ops) > 1 and ops[-1][1] in "SH" else 0
    if rec.is_reverse:
        return tail, head
    return head, tail


def head_align_tail(prefix: str, alnm_ext: str, mode: str) -> int:
    """Fit and persist the length KDEs; returns the aligned-read count
    (head_align_tail_dist.py:58-281)."""
    alnm_prefix = prefix
    total_ref_length = []
    dict_genome_alnm_info = {}
    if mode == "transcriptome":
        prefix = prefix[:-14]
        for kind, rec in sam_mod.read_sam(prefix + "_genome_primary.sam"):
            if kind != "aln":
                continue
            h, t = _get_head_tail(rec)
            if rec.qname not in dict_genome_alnm_info:
                dict_genome_alnm_info[rec.qname] = (h, t)
            else:
                h0, t0 = dict_genome_alnm_info[rec.qname]
                dict_genome_alnm_info[rec.qname] = (min(h, h0), min(t, t0))

    aligned_ref_length = []
    total_length = []
    ht_length = []
    head_vs_ht_ratio = []

    if alnm_ext == "maf":
        with gzopen(alnm_prefix + "_besthit.maf") as f:
            for line in f:
                ref = line.strip().split()
                aligned_ref_length.append(int(ref[3]))
                if mode == "transcriptome":
                    total_ref_length.append(int(ref[5]))
                query = next(f).strip().split()
                head = int(query[2])
                total_length.append(int(query[5]))
                ht = int(query[5]) - int(query[3])
                ht_length.append(ht)
                if ht != 0:
                    head_vs_ht_ratio.append(float(head) / ht)
    else:
        ref_len_by_name = sam_mod.read_sq_lengths(alnm_prefix + "_primary.sam")
        last_read = ""
        last_ref = ""
        last_is_edge = [False, False]
        aligned_ref = 0
        middle = 0
        head = tail = 0
        read_len_total = 0

        def flush(final=False):
            if aligned_ref == 0:
                return
            aligned_ref_length.append(aligned_ref)
            total_length.append(read_len_total)
            ht = head + tail
            ht_length.append(ht)
            # reference quirk: mid-stream reads gate the ratio on head != 0
            # (head_align_tail_dist.py:181) but the FINAL read gates on
            # ht != 0 (:219), admitting one head==0,tail>0 ratio of 0.0
            if (ht != 0 if final else head != 0):
                head_vs_ht_ratio.append(float(head) / ht)

        for kind, rec in sam_mod.read_sam(alnm_prefix + "_primary.sam"):
            if kind != "aln":
                continue
            read = rec.qname
            ref = rec.rname
            if mode == "transcriptome":
                total_ref_length.append(ref_len_by_name.get(ref, 0))
            if read == last_read:
                if mode == "transcriptome" and read in dict_genome_alnm_info:
                    hg, tg = dict_genome_alnm_info[read]
                    ht_, tt_ = _get_head_tail(rec)
                    h_new, t_new = min(hg, ht_), min(tg, tt_)
                else:
                    h_new, t_new = _get_head_tail(rec)
                head = min(head, h_new)
                tail = min(tail, t_new)
                read_len_total = max(read_len_total, rec.infer_read_length())
                if mode != "transcriptome":
                    is_edge = edge_checker(
                        rec.reference_start, rec.reference_end, ref_len_by_name.get(ref, 0)
                    )
                    if ref == last_ref and (
                        (last_is_edge[0] and is_edge[1]) or (last_is_edge[1] and is_edge[0])
                    ):
                        aligned_ref += rec.reference_length
                        middle += rec.query_alignment_length
                    else:
                        aligned_ref_length.append(aligned_ref)
                        aligned_ref = rec.reference_length
                        middle = rec.query_alignment_length
                    last_is_edge = is_edge
                else:
                    aligned_ref_length.append(aligned_ref)
                    aligned_ref = rec.reference_length
                    middle = rec.query_alignment_length
                last_ref = ref
            else:
                flush()
                last_read = read
                aligned_ref = rec.reference_length
                read_len_total = rec.infer_read_length()
                middle = rec.query_alignment_length
                if mode == "transcriptome" and read in dict_genome_alnm_info:
                    hg, tg = dict_genome_alnm_info[read]
                    ht_, tt_ = _get_head_tail(rec)
                    head, tail = min(hg, ht_), min(tg, tt_)
                else:
                    head, tail = _get_head_tail(rec)
                if mode != "transcriptome":
                    last_is_edge = edge_checker(
                        rec.reference_start, rec.reference_end, ref_len_by_name.get(ref, 0)
                    )
                last_ref = ref
        flush(final=True)

    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": Computing KDE\n")
    if mode == "transcriptome":
        x = np.asarray(total_ref_length, np.float64)
        y = np.asarray(aligned_ref_length[: len(x)], np.float64)
        n = len(x)
        bw = (n * (2 + 2) / 4.0) ** (-1.0 / (2 + 4))  # Silverman
        save_kde(prefix + "_aligned_region_2d.pkl", np.stack([x, y], axis=1), bw)

    aligned_ref_length = np.asarray(aligned_ref_length, np.float64)
    total_length = np.asarray(total_length, np.float64)
    ht_length = np.asarray(ht_length, np.float64)
    head_vs_ht_ratio = np.asarray(head_vs_ht_ratio, np.float64)

    save_kde(prefix + "_aligned_region.pkl", aligned_ref_length, 10.0)
    save_kde(prefix + "_aligned_reads.pkl", total_length, 10.0)
    save_kde(prefix + "_ht_length.pkl", np.log10(ht_length + 1), 0.01)
    if len(head_vs_ht_ratio) == 0:
        head_vs_ht_ratio = np.array([0.5])
    save_kde(prefix + "_ht_ratio.pkl", head_vs_ht_ratio, 0.01)
    return len(total_length)
