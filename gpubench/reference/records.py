"""Output records of reference lanes, in the simulator's file formats.

Written from NanoSim's formats (simulator.py) as the JAX package's Python
writers spell them, not copied from the port's emitters:

* a read is one FASTQ record, ``@<name>\\n<bases>\\n+\\n<quals>\\n`` (FASTA:
  ``><name>\\n<bases>\\n``);
* an aligned read is named ``<chrom>_<pos>_aligned_<idx>_<F|R>_<head>_<middle>_<tail>``,
  an unaligned one ``<chrom>_<pos>_unaligned_<idx>_<F|R>_0_<middle>_0``;
* every error of an aligned read is one row of the ground-truth log,
  ``name  key  mis|ins|del  length  ref_bases  read_bases``, the read's
  rows in reverse position order (mutate_read logs them so); an insertion
  overwritten by a later one at the same key, and an event that homopolymer
  mode suppressed, carry length 0 and write no row.
"""

from __future__ import annotations

import numpy as np

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in ((ord("A"), ord("T")), (ord("C"), ord("G"))):
    _COMP[_a], _COMP[_b] = _b, _a
_ETYPES = ("mis", "ins", "del")


def fastx_record(name: str, read: np.ndarray, quals, fastq: bool) -> bytes:
    if fastq:
        return b"@" + name.encode() + b"\n" + read.tobytes() + b"\n+\n" + quals.tobytes() + b"\n"
    return b">" + name.encode() + b"\n" + read.tobytes() + b"\n"


def aligned_name(chrom_name: str, pos: int, idx: int, rev: bool, head: int, middle: int,
                 tail: int) -> str:
    return f"{chrom_name}_{pos}_aligned_{idx}_{'R' if rev else 'F'}_{head}_{middle}_{tail}"


def unaligned_name(chrom_name: str, pos: int, idx: int, rev: bool, middle: int) -> str:
    return f"{chrom_name}_{pos}_unaligned_{idx}_{'R' if rev else 'F'}_0_{middle}_0"


def event_rows(pos2x: np.ndarray, etype: np.ndarray, elen: np.ndarray):
    """One lane's events (ascending, as the walk draws them) -> per event
    (key, start in the mutated middle, effective length).

    The key is the reference's float key rounded up (an insertion sits at
    pos - 0.5); a start in the middle is the reference start less the bases
    deleted before the event plus those inserted before it."""
    elen = elen.astype(np.int64).copy()
    ins = etype == 1
    overwritten = np.zeros(len(elen), bool)
    overwritten[:-1] = ins[:-1] & ins[1:] & (pos2x[1:] == pos2x[:-1])
    elen[overwritten] = 0
    dlen = np.where(etype == 2, elen, 0)
    ilen = np.where(ins, elen, 0)
    key = (pos2x.astype(np.int64) + 1) // 2
    ref_start = np.where(ins, key, pos2x.astype(np.int64) // 2)
    start = ref_start - (np.cumsum(dlen) - dlen) + (np.cumsum(ilen) - ilen)
    return key, start, elen


def log_rows(name: str, pos2x, etype, elen, middle: np.ndarray, genome, chrom: int,
             spos: int) -> bytes:
    """The ground-truth rows of one aligned segment: `middle` is its mutated
    bases in forward orientation, ref bases come from the genome at
    spos + key (wrapping on a circular chromosome).  Rows in reverse
    position order."""
    key, start, elen = event_rows(np.asarray(pos2x), np.asarray(etype), np.asarray(elen))
    goff = int(genome.offsets[chrom])
    glen = int(genome.lengths[chrom])
    circ = bool(genome.circular[chrom])
    rows = []
    for k, t, ln, st in zip(key.tolist(), np.asarray(etype).tolist(), elen.tolist(),
                            start.tolist()):
        if ln == 0:
            continue
        seq = middle[st:st + ln].tobytes().decode()
        if t == 1:
            ref = "-" * ln
        else:
            g0 = spos + k
            idx = (np.arange(g0, g0 + ln) % glen) if circ else np.arange(g0, g0 + ln)
            ref = genome.flat[goff + idx].tobytes().decode()
            if t == 2:
                seq = "-" * ln
        rows.append(f"{name}\t{k}\t{_ETYPES[t]}\t{ln}\t{ref}\t{seq}\n")
    return "".join(reversed(rows)).encode()


def forward_middle(read: np.ndarray, total: int, head: int, l_new: int, rev: bool) -> np.ndarray:
    """The mutated middle of an assembled read in forward orientation."""
    seq = read[:total]
    if rev:
        seq = _COMP[seq[::-1]]
    return seq[head:head + l_new]
