"""Error histogram + Markov-model extraction (besthit_to_histogram.py).

From primary alignments (SAM with cs tags, cs reconstructed from CIGAR+MD
when absent) or best-hit MAF: match/mis/ins/del length histograms, the
error-type transition counts (including zero-match `*0` states), the binned
conditional match-length ECDF, and the first-match ECDF — written in the
exact reference formats.
"""

from __future__ import annotations

import re

from ..profiles import ecdf as ecdf_mod
from ..profiles import error_model
from ..io.fastx import gzopen
from . import sam as sam_mod

_CS_RE = re.compile(r"(:[0-9]+|\*[a-z][a-z]|[=\+\-][A-Za-z]+)")

HIST_CAP = 1000  # errors longer than this are dropped (besthit_to_histogram.py:15-16)


def parse_cs(cs_string: str):
    """(list_hist, list_op) with consecutive mismatches merged
    (besthit_to_histogram.py:41-69)."""
    mis = 0
    list_op = []
    list_hist = []
    prev_op = "start"
    for item in _CS_RE.findall(cs_string):
        op = item[0]
        op_name = {":": "match", "+": "ins", "-": "del", "*": "mis"}.get(op, "skip")
        if op_name != "mis":
            list_op.append(op)
        elif prev_op != "mis":
            list_op.append(op)
        prev_op = op_name
        if op_name in ("ins", "del"):
            if mis:
                list_hist.append(mis)
                mis = 0
            list_hist.append(len(item) - 1)
        elif op_name == "match":
            if mis:
                list_hist.append(mis)
                mis = 0
            list_hist.append(int(item[1:]))
        elif op_name == "mis":
            mis += 1
    if mis:
        list_hist.append(mis)
    return list_hist, list_op


def cs_from_cigar_md(cigar_str: str, md_str: str) -> str:
    """Reconstruct a cs-equivalent string from CIGAR+MD
    (semantics of get_cs, besthit_to_histogram.py:76-132: arbitrary bases
    stand in for the real ones — only op structure matters)."""
    cigar = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDSHX=])", cigar_str)]
    md = re.findall(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])", md_str)
    out = []
    ci = 0  # cigar index
    c_used = 0  # bases consumed from current cigar M op

    def emit_insertions_and_clips():
        nonlocal ci
        while ci < len(cigar) and cigar[ci][1] in "IS":
            if cigar[ci][1] == "I":
                out.append("+" + "I" * cigar[ci][0])
            ci += 1

    emit_insertions_and_clips()
    for num, deletion, mismatch in md:
        if deletion:
            out.append("-" + deletion[1:])
            # consume the D op
            while ci < len(cigar) and cigar[ci][1] != "D":
                ci += 1
            if ci < len(cigar):
                ci += 1
            emit_insertions_and_clips()
        else:
            ml = int(num) if num else 0
            if mismatch:
                ml = 0
            # consume ml match bases + possibly spanning insertions
            while ml > 0 and ci < len(cigar):
                if cigar[ci][1] in "M=X":
                    avail = cigar[ci][0] - c_used
                    take = min(avail, ml)
                    out.append(f":{take}")
                    c_used += take
                    ml -= take
                    if c_used == cigar[ci][0]:
                        ci += 1
                        c_used = 0
                        emit_insertions_and_clips()
                else:
                    ci += 1
            if mismatch:
                out.append("*ab")
                c_used += 1
                if ci < len(cigar) and c_used == cigar[ci][0]:
                    ci += 1
                    c_used = 0
                    emit_insertions_and_clips()
    # merge adjacent matches
    merged = []
    for tok in out:
        if tok.startswith(":") and merged and merged[-1].startswith(":"):
            merged[-1] = f":{int(merged[-1][1:]) + int(tok[1:])}"
        else:
            merged.append(tok)
    return "".join(merged)


class _HistState:
    def __init__(self):
        self.dic_match = {x: 0 for x in range(150)}
        self.dic_first_match = {x: 0 for x in range(150)}
        self.dic_mis = {x: 0 for x in range(30)}
        self.dic_ins = {x: 0 for x in range(30)}
        self.dic_del = {x: 0 for x in range(30)}
        self.match_list = {x: {y: 0 for y in range(150)} for x in range(150)}
        self.error_list = {
            f"{a}/{b}": 0
            for a in ("mis", "ins", "del", "mis0", "ins0", "del0")
            for b in ("mis", "ins", "del")
        }
        self.first_error = {"mis": 0, "ins": 0, "del": 0}

    def add_dict(self, v, dic):
        if v > HIST_CAP:
            return
        if v not in dic:
            for i in range(len(dic), v + 1):
                dic[i] = 0
        dic[v] += 1

    def add_match(self, prev, succ):
        ml = self.match_list
        expand = max(prev, succ) + 1
        if expand > len(ml):
            last = len(ml)
            for i in range(0, last):
                for j in range(last, expand):
                    ml[i][j] = 0
            for i in range(last, expand):
                ml[i] = {j: 0 for j in range(expand)}
        ml[prev][succ] += 1


def _process_ops(st: _HistState, list_hist, list_op):
    """Shared op-walk (besthit_to_histogram.py:325-364)."""
    flag = True
    prev_error = ""
    prev_match = 0
    conv = {":": "match", "+": "ins", "-": "del", "*": "mis"}
    for i, op in enumerate(list_op):
        curr = conv.get(op, "skip")
        if curr == "skip":
            continue
        if curr != "match":
            exact_prev = conv.get(list_op[i - 1], "skip") if i > 0 else "skip"
            if exact_prev != "match":
                prev_error += "0"
            if flag:
                flag = False
                st.first_error[curr] += 1
            else:
                st.error_list[prev_error + "/" + curr] += 1
            prev_error = curr
            if curr == "mis":
                st.add_dict(list_hist[i], st.dic_mis)
                if exact_prev != "match":
                    st.add_dict(0, st.dic_match)
                    st.add_match(prev_match, 0)
                    prev_match = 0
            elif curr == "del":
                st.add_dict(list_hist[i], st.dic_del)
            else:
                st.add_dict(list_hist[i], st.dic_ins)
        else:
            m = list_hist[i]
            if flag:
                st.add_dict(m, st.dic_first_match)
                prev_match = m
            else:
                if i == len(list_op) - 1:
                    st.add_match(prev_match, m)
                else:
                    st.add_dict(m, st.dic_match)
                    st.add_match(prev_match, m)
                    prev_match = m


def _maf_to_ops(ref: str, query: str):
    """Column walk of a MAF pair into (hist, op) lists equivalent to the
    cs path (reference MAF branch, besthit_to_histogram.py:188-315)."""
    out_hist, out_op = [], []
    i = 0
    n = len(ref)
    while i < n:
        if ref[i] == "-":
            j = i
            while j < n and ref[j] == "-":
                j += 1
            out_hist.append(j - i)
            out_op.append("+")
            i = j
        elif query[i] == "-":
            j = i
            while j < n and query[j] == "-" and ref[j] != "-":
                j += 1
            out_hist.append(j - i)
            out_op.append("-")
            i = j
        elif ref[i] == query[i]:
            j = i
            while j < n and ref[j] != "-" and query[j] != "-" and ref[j] == query[j]:
                j += 1
            out_hist.append(j - i)
            out_op.append(":")
            i = j
        else:
            j = i
            while j < n and ref[j] != "-" and query[j] != "-" and ref[j] != query[j]:
                j += 1
            out_hist.append(j - i)
            out_op.append("*")
            i = j
    return out_hist, out_op


def hist(prefix: str, alnm_ftype: str = "sam"):
    """Main entry (besthit_to_histogram.py:148-487): reads
    `<prefix>_primary.sam` (or `<prefix>_besthit.maf`), writes the histogram
    and Markov model files under the un-suffixed prefix."""
    alignment_prefix = prefix
    if prefix.endswith("_genome"):
        prefix = prefix[:-7]
    st = _HistState()

    if alnm_ftype == "maf":
        with gzopen(alignment_prefix + "_besthit.maf") as f:
            for line in f:
                ref = line.strip().split()[6].upper()
                query = next(f).strip().split()[6].upper()
                lh, lo = _maf_to_ops(ref, query)
                _process_ops(st, lh, lo)
    else:
        for kind, aln in sam_mod.read_sam(alignment_prefix + "_primary.sam"):
            if kind != "aln":
                continue
            if "cs" in aln.tags:
                cs = aln.tags["cs"]
            else:
                cs = cs_from_cigar_md(aln.cigar, aln.tags.get("MD", ""))
            lh, lo = parse_cs(cs)
            _process_ops(st, lh, lo)

    _write_outputs(st, prefix)


def _write_outputs(st: _HistState, prefix: str):
    import numpy as np

    def dense(dic):
        out = np.zeros(max(dic) + 1, np.int64)
        for k, v in dic.items():
            out[k] = v
        return out

    m = dense(st.dic_match)
    mi = dense(st.dic_mis)
    ins = dense(st.dic_ins)
    de = dense(st.dic_del)
    error_model.write_histogram(prefix + "_match.hist", m, "Matches:")
    error_model.write_histogram(prefix + "_mis.hist", mi, "Mismatches:")
    error_model.write_histogram(prefix + "_ins.hist", ins, "Insertions:")
    error_model.write_histogram(prefix + "_del.hist", de, "Deletions:")
    idx = np.arange(len(m))
    total_match = int((idx * m).sum())
    total_mis = int((np.arange(len(mi)) * mi).sum())
    total_ins = int((np.arange(len(ins)) * ins).sum())
    total_del = int((np.arange(len(de)) * de).sum())
    error_model.write_error_rates(
        prefix + "_error_rate.tsv", total_match, total_mis, total_ins, total_del
    )

    # error transition probabilities (besthit_to_histogram.py:404-422)
    probs = np.zeros((7, 3))
    n_first = max(sum(st.first_error.values()), 1)
    probs[0] = [st.first_error[t] / n_first for t in ("mis", "ins", "del")]
    for r, state in enumerate(("mis", "ins", "del", "mis0", "ins0", "del0"), start=1):
        denom = sum(st.error_list[f"{state}/{t}"] for t in ("mis", "ins", "del"))
        if denom:
            probs[r] = [st.error_list[f"{state}/{t}"] / denom for t in ("mis", "ins", "del")]
    error_model.write_error_markov(prefix + "_error_markov_model", probs)

    # binned conditional match ECDF: 15 equal-mass precedent bins
    # (besthit_to_histogram.py:424-476)
    ml = st.match_list
    n_keys = len(ml)
    count = sum(sum(row.values()) for row in ml.values())
    bin_size = count / 15
    bins = []  # (lo, hi)
    bin_counts = []
    k = 0
    last_k = 0
    while len(bins) < 15 and k < n_keys:
        tmp = 0
        while tmp < bin_size and k < n_keys:
            new_added = sum(ml[k].values())
            if abs(tmp + new_added - bin_size) > abs(tmp - bin_size) and tmp != 0:
                break
            tmp += new_added
            k += 1
        bins.append((last_k, k))
        bin_counts.append(tmp)
        last_k = k
    if k < n_keys:  # leftovers into the last bin
        extra = 0
        for kk in range(last_k, n_keys):
            extra += sum(ml[kk].values())
        bin_counts[-1] += extra
        bins[-1] = (bins[-1][0], bins[-1][1])

    n_vals = n_keys
    cum = np.zeros((n_vals, len(bins)))
    for bi, (lo, hi) in enumerate(bins):
        hi_eff = n_keys if bi == len(bins) - 1 and k < n_keys else hi
        col = np.zeros(n_vals)
        for kk in range(lo, hi_eff):
            for succ, c in ml[kk].items():
                if succ < n_vals:
                    col[succ] += c
        denom = max(bin_counts[bi], 1)
        # accumulate per-value RATIOS serially (count_prob += cnt/total,
        # besthit_to_histogram.py:470-473) so the emitted f64 text is
        # bit-identical to the reference's — cumsum(col)/denom rounds
        # differently by 1 ulp
        cum[:, bi] = np.cumsum(col / denom)
    ecdf_mod.write_ecdf_file(prefix + "_match_markov_model", bins, cum)

    # first-match cumulative ECDF (besthit_to_histogram.py:478-486)
    fm = dense(st.dic_first_match)
    if len(fm) < 150:
        fm = np.concatenate([fm, np.zeros(150 - len(fm), np.int64)])
    cum_fm = np.cumsum(fm / max(fm.sum(), 1))
    ecdf_mod.write_ecdf_file(
        prefix + "_first_match.hist", [(0, 50000)], cum_fm[:, None], first_token="bin"
    )
