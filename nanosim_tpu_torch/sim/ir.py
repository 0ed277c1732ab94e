"""Intron retention: per-read Markov walk over transcript structures and
genome-interval extraction.

Reference behavior (simulator.py:114-191, 1156-1181):

  - per read, walk the transcript's introns through the IR Markov chain
    (update_structure); if any intron is retained, the read is extracted from
    the GENOME over the exon/retained-intron intervals instead of from the
    transcript sequence (extract_read_pos + per-interval faidx fetch);
  - the start position is uniform in [0, min(trx_len - length, len_before)]
    where len_before is the exonic length before the first retained intron
    (so the retained intron is covered);
  - '-'-strand structures are reverse-complemented after concatenation;
  - polyA is retained when the last interval reaches within 10 bp of the
    structure's genomic end.

Structures are CSR tables over features.  The per-read chain is a loop of
f_max steps (its uniforms, which do not depend on the state, are drawn for
every step at once before it); the interval->base mapping is a scatter-max +
running max over read positions, so extraction is one genome gather — the
reference's per-read faidx fetches (simulator.py:1172) become batched device
reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import rng, seqops
from . import extract

IR_NO, IR_YES = 0, 1  # column order in the IR markov table
MAX_IR_OUT = 16  # retained-intron intervals reported in read names


@dataclasses.dataclass
class IRTables:
    """CSR feature tables aligned with the packed transcriptome's order."""

    feat_offset: torch.Tensor  # [n_trx + 1] i32
    is_intron: torch.Tensor  # [F] bool
    chrom: torch.Tensor  # [F] i32 genome chromosome index
    start: torch.Tensor  # [F] i64 genomic start
    length: torch.Tensor  # [F] i32
    n_feats: torch.Tensor  # [n_trx] i32
    strand_neg: torch.Tensor  # [n_trx] bool
    last_end: torch.Tensor  # [n_trx] i64 genomic end of the final feature
    ir_cum: torch.Tensor  # [3] cum prob of IR given state (start, no_IR, IR)
    f_max: int

    @classmethod
    def build(cls, structures, trx_names, genome_names, ir_markov: np.ndarray, spliced_lens,
              device):
        """From profiles.TranscriptStructures; returns (tables, eligible_mask).

        Eligible transcripts (simulator.py:1094-1100): structure present,
        exonic length == transcript length, and every chromosome resolvable.
        """
        name_to_idx = {}
        for i, nm in enumerate(genome_names):
            name_to_idx[nm] = i
            if "chr" in nm:
                name_to_idx[nm.strip("chr")] = i
        n_trx = len(trx_names)
        offs = [0]
        is_int, chrom, start, length = [], [], [], []
        n_feats = np.zeros(n_trx, np.int32)
        strand_neg = np.zeros(n_trx, bool)
        last_end = np.zeros(n_trx, np.int64)
        eligible = np.zeros(n_trx, bool)
        for ti, nm in enumerate(trx_names):
            feats = structures.by_transcript.get(nm.split(".")[0], [])
            exon_len = sum(f[4] for f in feats if f[0] == "exon")
            ok = bool(feats) and exon_len == int(spliced_lens[ti])
            ok = ok and all(f[1] in name_to_idx for f in feats)
            if ok:
                eligible[ti] = True
                for f in feats:
                    is_int.append(f[0] == "intron")
                    chrom.append(name_to_idx[f[1]])
                    start.append(f[2])
                    length.append(f[4])
                n_feats[ti] = len(feats)
                strand_neg[ti] = feats[-1][5] == "-"
                last_end[ti] = feats[-1][3]
            offs.append(len(is_int))
        f_max = int(n_feats.max()) if n_feats.max() > 0 else 1
        ir_cum = np.cumsum(ir_markov, axis=1)[:, 0]  # P(no_IR | state)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        tables = cls(
            feat_offset=dev(offs, np.int32),
            is_intron=dev(is_int if is_int else [False], bool),
            chrom=dev(chrom if chrom else [0], np.int32),
            start=dev(start if start else [0], np.int64),
            length=dev(length if length else [0], np.int32),
            n_feats=dev(n_feats, np.int32),
            strand_neg=dev(strand_neg, bool),
            last_end=dev(last_end, np.int64),
            ir_cum=dev(ir_cum, np.float32),
            f_max=f_max,
        )
        return tables, eligible


def ir_walk_and_extract(sk, trx, middle_ref, trx_len, t: IRTables, genome: extract.GenomeDevice,
                        l_cap: int):
    """IR decision + genome-interval extraction for a batch.

    Returns (seg [B, l_cap] uint8, rep_pos [B] i64 first-interval start,
    extracted_len [B] i32, has_ir [B] bool, ir_intervals [B, min(F, MAX_IR_OUT), 2],
    n_ir [B] i32, reach_end [B] bool, feat_start [B, F] i64, feat_take [B, F] i32).
    """
    B = trx.shape[0]
    F = t.f_max
    dev = trx.device
    ir_keys = rng.site_keys(sk, rng.SITE_IR)
    tl = trx.long()
    base_off = t.feat_offset[tl]
    nf = t.n_feats[tl]
    f_ids = torch.arange(F, dtype=torch.int32, device=dev)

    # --- phase 1: intron retention states (update_structure) ---------------
    # step f's uniform is uniform(fold_in(ir_key, f)), the first draw of that
    # key; it does not depend on the chain, so every step's is drawn at once
    k = rng.fold_in(ir_keys[:, None, :], f_ids.long()[None, :])  # [B, F, 2]
    u_f = rng.uniform(k)  # [B, F]
    feat_ids = base_off[:, None] + torch.minimum(f_ids[None, :], (nf - 1)[:, None])
    f_act = f_ids[None, :] < nf[:, None]
    f_int = t.is_intron[feat_ids.long()] & f_act
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    ret = []
    for f in range(F):
        goes_ir = u_f[:, f] >= t.ir_cum[state]
        is_int = f_int[:, f]
        state = torch.where(is_int, torch.where(goes_ir, 2, 1), state)
        ret.append(is_int & goes_ir)
    retained = torch.stack(ret, dim=1)
    has_ir = retained.any(dim=1)

    # --- len_before: exonic length before the first retained intron --------
    f_len = torch.where(f_act, t.length[feat_ids.long()], 0)
    before_first_ret = torch.cumsum(retained, dim=1) == 0
    len_before = torch.where(before_first_ret & ~f_int, f_len, 0).sum(dim=1).to(torch.int32)

    # --- start position (extract_read_pos, simulator.py:162) ---------------
    u_pos = rng.uniform_f64(rng.fold_in(ir_keys, F + 1))
    hi = torch.minimum(trx_len - middle_ref, len_before).clamp_min(0)
    start_pos = torch.minimum((u_pos * (hi + 1)).to(torch.int32), hi)

    # --- phase 2: interval walk --------------------------------------------
    # usable features = exons + retained introns; skipped introns vanish
    usable = f_act & (~f_int | retained)
    u_len = torch.where(usable, f_len, 0).long()
    # consume start_pos, then take bases until middle_ref is exhausted
    cum_before = torch.cumsum(u_len, dim=1) - u_len  # usable length before f
    # offset into feature f after skipping start_pos
    skip = torch.minimum((start_pos.long()[:, None] - cum_before).clamp_min(0), u_len)
    avail = u_len - skip
    cum_avail = torch.cumsum(torch.where(usable, avail, 0), dim=1)
    mref = middle_ref.long()[:, None]
    taken_end = torch.minimum(cum_avail, mref)
    taken_start = torch.minimum(cum_avail - avail, mref)
    take = torch.where(usable, taken_end - taken_start, 0)  # bases from feature f
    extracted_len = taken_end[:, -1].to(torch.int32)

    g_start = t.start[feat_ids.long()] + skip  # genomic interval start
    has_take = take > 0

    # The active interval per read position: scatter each used interval's
    # (read start, gpos - j) tag at its read start and forward-fill with a
    # running max.  Tag layout: taken_start in the high bits (later intervals
    # always win the running max) | base_val + 2^42 in a 43-bit low field —
    # base_val is bounded by the genome size (|base_val| << 2^41), so the low
    # field stays inside its 43 bits and cannot bleed into taken_start.
    j = torch.arange(l_cap, dtype=torch.int64, device=dev)[None, :]
    base_val = g_start - taken_start  # gpos = j + base_val
    scatter_pos = torch.where(has_take, taken_start, l_cap).clamp(0, l_cap)
    offset_bias = 1 << 42
    tag = (taken_start << 43) + (base_val + offset_bias)
    tagged = torch.full((B, l_cap + 1), -1, dtype=torch.int64, device=dev)
    tagged.scatter_reduce_(1, scatter_pos, torch.where(has_take, tag, -1), "amax",
                           include_self=True)
    filled = torch.cummax(tagged[:, :l_cap], dim=1).values
    base_at_j = (filled & ((1 << 43) - 1)) - offset_bias
    gpos = j + base_at_j

    chrom0 = t.chrom[base_off.long()].long()  # transcripts live on one chromosome
    goff = genome.offsets[chrom0][:, None]
    glen = genome.lengths[chrom0][:, None]
    idx = goff + torch.minimum(gpos.clamp_min(0), glen - 1)
    seg = genome.flat[idx.clamp(0, genome.flat.shape[0] - 1)]
    seg = torch.where(j < extracted_len[:, None], seg, 0).to(torch.uint8)

    # '-'-strand: reverse complement the extracted block (simulator.py:1177-1178)
    neg = t.strand_neg[tl]
    seg = torch.where(neg[:, None], seqops.reverse_complement(seg, extracted_len), seg)

    # polyA reach test: last interval's genomic end + 10 >= structure end
    last_g_end = torch.where(has_take, g_start + take, -1).max(dim=1).values
    reach_end = last_g_end + 10 >= t.last_end[tl]

    # retained-intron intervals actually used (for read names), in feature
    # order (a stable sort of the not-used flag)
    ret_used = retained & has_take
    ivl_start = torch.where(ret_used, g_start, 0)
    ivl_end = torch.where(ret_used, g_start + take, 0)
    order = torch.argsort((~ret_used).to(torch.uint8), dim=1, stable=True)[:, :MAX_IR_OUT]
    ir_intervals = torch.stack([ivl_start.gather(1, order), ivl_end.gather(1, order)], dim=2)
    n_ir = ret_used.sum(dim=1).to(torch.int32)

    rep_pos = torch.where(has_ir, torch.where(has_take, g_start, 2**62).min(dim=1).values, 0)
    # per-feature (genomic start, taken length) — the host-reconstruction
    # path rebuilds the source bytes from these instead of re-walking
    feat_start = torch.where(has_take, g_start, 0)
    feat_take = torch.where(has_take, take, 0).to(torch.int32)
    return (seg, rep_pos, extracted_len, has_ir, ir_intervals, n_ir, reach_end,
            feat_start, feat_take)
