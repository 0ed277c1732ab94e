"""Primary/chimeric alignment selection + EM quantification.

Re-implements get_primary_sam.py over SAM text: primary filtering,
compatible-supplementary grouping into non-overlapping maximal-score segment
sets, circular-read edge detection, chimeric gap statistics, and the
base-weighted (metagenome) / read-weighted+TPM (transcriptome) EM
quantifiers (get_primary_sam.py:44-142, 145-478).
"""

from __future__ import annotations

import re
import sys
from statistics import median
from time import strftime

import numpy as np

from ..profiles.kde import save_kde
from . import sam as sam_mod


def _log(msg):
    sys.stdout.write(strftime("%Y-%m-%d %H:%M:%S") + ": " + msg + "\n")
    sys.stdout.flush()


def cigar_parser(cigar: str):
    """(qstart, qend, qlen, rlen) from a SAM cigar (get_primary_sam.py:16-31)."""
    match = re.findall(r"(\d+)(\w)", cigar)
    qstart = int(match[0][0]) if match[0][1] in ("S", "H") else 0
    qlen = 0
    rlen = 0
    for n, op in match:
        if op == "M":
            qlen += int(n)
            rlen += int(n)
        elif op == "I":
            qlen += int(n)
        elif op == "D":
            rlen += int(n)
    return qstart, qstart + qlen, qlen, rlen


def not_overlap(interval, interval_lst, interval_name=None, interval_name_list=None, overlap_base=10):
    for i in range(len(interval_lst)):
        if interval[0] < interval_lst[i][1] - overlap_base and interval[1] - overlap_base > interval_lst[i][0]:
            if interval_name is None or interval_name == interval_name_list[i]:
                return False
    return True


def edge_checker(rstart, rend, ref_length, ref_edge_max_dist=400, query_min_aln_len=100):
    """head_align_tail_dist.py:25-35."""
    is_edge = [False, False]
    if rend - rstart >= query_min_aln_len:
        if rend >= ref_length - 1 - ref_edge_max_dist:
            is_edge[1] = True
        elif rstart <= ref_edge_max_dist:
            is_edge[0] = True
    return is_edge


def EM_meta(read_list: dict, all_species: dict) -> dict:
    """Base-weighted abundance EM (get_primary_sam.py:44-86)."""
    _log("Starting EM for quantification")
    base_count_unique = dict.fromkeys(all_species, 0)
    multi = {}
    total_base = 0
    for read, species_list in read_list.items():
        length = read[1][1] - read[1][0]
        total_base += length
        if len(species_list) == 1:
            base_count_unique[species_list[0]] += length
        else:
            multi[(read[0], read[1], length)] = species_list
    abundance = {sp: 100 / len(all_species) for sp in all_species}

    diff = 100 * len(all_species)
    for it in range(100):
        counts = dict(base_count_unique)
        for read, species_list in multi.items():
            length = read[2]
            tot = sum(abundance[sp] for sp in species_list)
            for sp in species_list:
                counts[sp] += length * abundance[sp] / tot
        new = {sp: b * 100 / total_base for sp, b in counts.items()}
        d = sum(abs(new[sp] - abundance[sp]) for sp in abundance)
        abundance = new
        thres = min(abundance.values()) * 0.01
        if d <= thres or diff - d < thres:
            break
        diff = d
    return abundance


def EM_trans(read_list: dict, all_trans: dict, normalize: bool) -> dict:
    """Read-weighted EM + TPM (get_primary_sam.py:89-142)."""
    _log("Starting EM for quantification")
    unique = dict.fromkeys(all_trans, 0)
    multi = {}
    total_reads = 0
    for read, trans_list in read_list.items():
        total_reads += 1
        if len(trans_list) == 1:
            unique[trans_list[0]] += 1
        else:
            multi[read] = trans_list
    abundance = {t: 100 / len(all_trans) for t in all_trans}

    counts = dict(unique)
    diff = 100 * len(all_trans)
    for it in range(1000):
        counts = dict(unique)
        for read, trans_list in multi.items():
            tot = sum(abundance[t] for t in trans_list)
            for t in trans_list:
                counts[t] += abundance[t] / tot
        new = {t: r * 100 / total_reads for t, r in counts.items()}
        d = sum(abs(new[t] - abundance[t]) for t in abundance)
        abundance = new
        thres = min(abundance.values()) * 0.001
        if d <= thres or diff - d < thres:
            break
        diff = d

    tpm_list = {}
    if normalize:
        total_rpk = sum(c / all_trans[t] * 1e3 for t, c in counts.items())
    else:
        total_rpk = sum(counts.values())
    for t, c in counts.items():
        rpk = c / all_trans[t] * 1e3 if normalize else c
        tpm_list[t] = (c, rpk * 1e6 / max(total_rpk, 1e-12))
    return tpm_list


def _species_of(ref_name: str, is_trans: bool) -> str:
    return ref_name if is_trans else "_".join(ref_name.split("_")[:-1])


def _write_quantification(prefix, quant_dic, all_species, metagenome_list, is_trans, normalize):
    if is_trans:
        tpm_list = EM_trans(quant_dic, all_species, normalize)
        with open(prefix + "_quantification.tsv", "w") as f:
            f.write("ID\tcount\tTPM\n")
            for t, info in tpm_list.items():
                f.write(f"{t}\t{info[0]}\t{info[1]}\n")
        return None
    abundance = EM_meta(quant_dic, all_species)
    with open(prefix + "_quantification.tsv", "w") as f:
        f.write("Species\tAbundance\n")
        for k, v in abundance.items():
            f.write(f"{k}\t{v}\n")
            if metagenome_list is not None and k in metagenome_list:
                metagenome_list[k]["real"] = v
                if "expected" in metagenome_list[k]:
                    metagenome_list[k]["variation"] = (
                        v - metagenome_list[k]["expected"]
                    ) / metagenome_list[k]["expected"]
    return abundance


def primary_and_unaligned(sam_path: str, prefix: str, metagenome_list=None, fastq=False):
    """Primary-only filtering (get_primary_sam.py:145-217).

    Returns (unaligned_len ndarray, strandness, unaligned_base_quals)."""
    header = []
    quant_dic = {}
    unaligned_len = []
    unaligned_bq = []
    pos_strand = 0
    num_aligned = 0
    all_species = {}

    out = None
    for kind, item in sam_mod.read_sam(sam_path):
        if kind == "header":
            header.append(item)
            if item.startswith("@SQ"):
                name = [f[3:] for f in item.split("\t") if f.startswith("SN:")][0]
                all_species["_".join(name.split("_")[:-1])] = 0
            continue
        if out is None:
            out = sam_mod.SamWriter(prefix + "_primary.sam", header)
        aln = item
        if not aln.is_unmapped and not aln.is_secondary and not aln.is_supplementary:
            num_aligned += 1
            out.write(aln)
            if aln.flag == 0:
                pos_strand += 1
            if metagenome_list is not None:
                sp = _species_of(aln.rname, False)
                quant_dic[(aln.qname, (aln.query_alignment_start, aln.query_alignment_end))] = [sp]
        elif aln.is_unmapped:
            unaligned_len.append(aln.query_length)
            q = aln.query_qualities()
            if fastq and q:
                unaligned_bq += q
        else:
            if metagenome_list is not None:
                qstart, qend, _, _ = cigar_parser(aln.cigar)
                key = (aln.qname, (qstart, qend))
                if key in quant_dic:
                    quant_dic[key].append(_species_of(aln.rname, False))
    if out is not None:
        out.close()

    strandness = float(pos_strand) / max(num_aligned, 1)
    if metagenome_list is not None:
        _write_quantification(prefix, quant_dic, all_species, metagenome_list, False, True)
    return np.array(unaligned_len), strandness, unaligned_bq


def primary_and_unaligned_chimeric(
    sam_path: str, prefix: str, metagenome_list=None, q_mode=False, normalize=True, fastq=False
):
    """Chimeric-aware filtering + gap/segment statistics
    (get_primary_sam.py:220-478)."""
    is_trans = bool(metagenome_list) and "tpm" in metagenome_list

    header = []
    ref_lengths = {}
    all_species = {}
    chimeric_species_count = {}
    quant_dic = {}
    gap_length = []
    unaligned_len = []
    unaligned_bq = []
    pos_strand = 0
    num_aligned = 0

    records = []
    for kind, item in sam_mod.read_sam(sam_path):
        if kind == "header":
            header.append(item)
            if item.startswith("@SQ"):
                name = ln = None
                for f in item.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                ref_lengths[name] = ln
                sp = name if is_trans else "_".join(name.split("_")[:-1])
                all_species[sp] = ln
                chimeric_species_count[sp] = [0, 0]
        else:
            records.append(item)

    out = None if q_mode else sam_mod.SamWriter(prefix + "_primary.sam", header)
    aln_queue = []
    supplementary_to_be_added = []

    for aln in records:
        if aln.is_unmapped:
            unaligned_len.append(aln.query_length)
            q = aln.query_qualities()
            if fastq and q:
                unaligned_bq += q
        elif not aln.is_secondary and not aln.is_supplementary:
            num_aligned += 1
            primary_direction = "-" if aln.is_reverse else "+"
            NM_tag = int(aln.tags.get("NM", 0))
            primary_qstart = aln.query_alignment_start

            if not q_mode:
                for pre in aln_queue:
                    if pre is not None:
                        out.write(pre)
                aln_queue = []
                supplementary_to_be_added = []

            if "SA" not in aln.tags:
                if not q_mode:
                    out.write(aln)
                if metagenome_list:
                    sp = _species_of(aln.rname, is_trans)
                    quant_dic[(aln.qname, (aln.query_alignment_start, aln.query_alignment_end))] = [sp]
                if primary_direction == "+":
                    pos_strand += 1
                continue

            supp_list = aln.tags["SA"].split(";")
            compatible = [
                {
                    "query": [(aln.query_alignment_start, aln.query_alignment_end)],
                    "ref": [(aln.reference_start, aln.reference_end)],
                    "score": aln.query_alignment_length - NM_tag,
                    "rname": [aln.rname],
                    "direction": [primary_direction],
                }
            ]
            for supp in supp_list[:-1]:
                ref_name, ref_start, direction, cigar, _, nm = supp.split(",")
                ref_start = int(ref_start) - 1
                nm = int(nm)
                qstart, qend, qlen, rlen = cigar_parser(cigar)
                added = False
                for seg in compatible:
                    if not_overlap((qstart, qend), seg["query"]) and not_overlap(
                        (ref_start, ref_start + rlen), seg["ref"], ref_name, seg["rname"]
                    ):
                        seg["query"].append((qstart, qend))
                        seg["ref"].append((ref_start, ref_start + rlen))
                        seg["score"] += qlen - nm
                        seg["rname"].append(ref_name)
                        seg["direction"].append(direction)
                        added = True
                if not added:
                    compatible.append(
                        {
                            "query": [(qstart, qend)],
                            "ref": [(ref_start, ref_start + rlen)],
                            "score": qlen - nm,
                            "rname": [ref_name],
                            "direction": [direction],
                        }
                    )

            max_score = max(x["score"] for x in compatible)
            for seg in compatible:
                if seg["score"] != max_score:
                    continue
                if len(seg["query"]) == 1 and seg["query"][0][0] != primary_qstart:
                    if not q_mode:
                        out.write(aln)
                    if metagenome_list:
                        sp = _species_of(aln.rname, is_trans)
                        quant_dic[(aln.qname, tuple(seg["query"][0]))] = [sp]
                    if primary_direction == "+":
                        pos_strand += 1
                    break
                idx = [i[0] for i in sorted(enumerate(seg["query"]), key=lambda x: x[1])]
                seg["query"].sort()
                seg["ref"] = [seg["ref"][x] for x in idx]
                seg["rname"] = [seg["rname"][x] for x in idx]

                dir_added = False
                pre_is_edge = [False, False]
                if not q_mode:
                    aln_queue = [None] * len(seg["query"])
                    supplementary_to_be_added = [None] * len(seg["query"])
                pre_species = ""
                species = ""
                for i, interval in enumerate(seg["query"]):
                    ref_interval = seg["ref"][i]
                    is_edge = edge_checker(
                        ref_interval[0], ref_interval[1], ref_lengths[seg["rname"][i]]
                    )
                    species = _species_of(seg["rname"][i], is_trans)
                    if metagenome_list:
                        quant_dic[(aln.qname, tuple(interval))] = [species]
                    if i > 0:
                        if seg["rname"][i] == seg["rname"][i - 1] and (
                            (pre_is_edge[0] and is_edge[1]) or (pre_is_edge[1] and is_edge[0])
                        ):
                            pass  # circular read split
                        else:
                            gap_length.append(max(0, interval[0] - seg["query"][i - 1][1]))
                            if species == pre_species:
                                chimeric_species_count[pre_species][0] += 1
                            else:
                                chimeric_species_count[pre_species][1] += 1
                    if interval[0] == primary_qstart:
                        dir_added = True
                        if primary_direction == "+":
                            pos_strand += 1
                        if not q_mode:
                            aln_queue[i] = aln
                    elif not q_mode:
                        supplementary_to_be_added[i] = (
                            seg["rname"][i], interval[0], interval[1], seg["ref"][i][0]
                        )
                    pre_is_edge = is_edge
                    pre_species = species
                if not dir_added and seg["direction"][0] == "+":
                    pos_strand += 1
                break
        else:
            qstart, qend, _, _ = cigar_parser(aln.cigar)
            if not q_mode:
                for i in range(len(supplementary_to_be_added)):
                    if (aln.rname, qstart, qend, aln.reference_start) == supplementary_to_be_added[i]:
                        aln_queue[i] = aln
            if metagenome_list and (aln.qname, (qstart, qend)) in quant_dic:
                quant_dic[(aln.qname, (qstart, qend))].append(_species_of(aln.rname, is_trans))

    if not q_mode:
        for pre in aln_queue:
            if pre is not None:
                out.write(pre)
        out.close()

    strandness = float(pos_strand) / max(num_aligned, 1)
    beta_list = []
    if metagenome_list:
        _write_quantification(prefix, quant_dic, all_species, metagenome_list, is_trans, normalize)
        if not is_trans:
            for sp, counts in chimeric_species_count.items():
                if counts[0] + counts[1] == 0:
                    continue
                original = metagenome_list.get(sp, {}).get("real", 100 / max(len(all_species), 1))
                other = 100 - original
                if other > 0:
                    beta_list.append(counts[1] / (counts[0] + counts[1]) * 100 / other)

    if q_mode:
        return [], strandness, unaligned_bq

    gap_length = np.array(gap_length)
    if len(gap_length):
        save_kde(prefix + "_gap_length.pkl", np.log10(gap_length + 1), 0.01)

    mean_segments = (len(gap_length) + num_aligned) / max(num_aligned, 1)
    with open(prefix + "_chimeric_info", "w") as f:
        f.write("Mean segments for each aligned read:\t" + str(mean_segments) + "\n")
        if metagenome_list and not is_trans and beta_list:
            f.write("Shrinkage rate (beta):\t" + str(median(beta_list)))
    return np.array(unaligned_len), strandness, unaligned_bq
