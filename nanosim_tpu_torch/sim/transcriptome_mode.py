"""Transcriptome-mode simulation: the batched device program.

Mirrors `simulation_aligned_transcriptome` (simulator.py:1043-1263):

  - expression-weighted transcript choice (random.choices over the TPM ECDF,
    simulator.py:1084) -> weighted inverse-CDF draw;
  - aligned length conditioned on transcript length via the 2D KDE: the
    reference's nearest-of-a-sample-pool estimator (select_nearest_kde2d,
    simulator.py:108-111), with rejection until aligned < transcript length;
  - head/tail: remainder KDE + ratio CLAMPED into [0, 1]
    (simulator.py:1073-1075 — unlike genome mode, which filters);
  - polyA tails ~ int(Expon(loc=2, scale per basecaller)) for transcripts in
    the polyA list whose extraction reaches within 10 bp of the 3' end;
  - uracil (T -> U) on the final read.

Intron retention runs as a per-read feature walk over CSR structure tables
(see ir.py) and switches extraction to genome intervals.

On the default route the device runs the meta-only program (one [B, K] int64
row per lane goes to the host, which replays the walk against the device
checksum and reconstructs the read in C++).  The read-emitting program
(`-hp`, NANOSIM_TPU_RECON=0) extracts per byte, mutates through the gather
map (the byte gather is the CUDA kernel of ops/gather_cuda on the card),
resizes homopolymer runs with `-hp` and assembles head | middle | polyA |
tail inline.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..ops import apply_errors, error_walk, homopolymer, rng, seqops, xla_math
from . import extract, ir
from .bundles import SimTables
from .compact import event_checksum
from .genome_mode import _kde_draw, _ndtri


class TrxBatchOut(NamedTuple):
    read: Optional[torch.Tensor]  # [B, L_out] uint8 (None in the meta-only program)
    quals: Optional[torch.Tensor]
    valid: torch.Tensor
    total_len: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor  # WITHOUT polyA (name component adds polya_len)
    polya_len: torch.Tensor
    middle_ref: torch.Tensor
    l_new: torch.Tensor
    trx: torch.Tensor  # [B] transcript index
    local_pos: torch.Tensor  # [B] start within transcript (or genome for IR)
    is_reversed: torch.Tensor
    ev_pos2x: torch.Tensor
    ev_type: torch.Tensor
    ev_len: torch.Tensor
    n_events: torch.Tensor
    has_ir: torch.Tensor  # [B] bool
    ir_intervals: torch.Tensor  # [B, I, 2] genomic retained-intron intervals
    n_ir: torch.Tensor  # [B]
    ref_seg: Optional[torch.Tensor]  # [B, l_cap] IUPAC-resolved extracted reference
    read_prehp: Optional[torch.Tensor]  # [B, l_cap] pass-1 mutated middle (log source)
    m_ref_init: Optional[torch.Tensor] = None  # [B] walk INPUT length (2D-KDE aligned draw)
    # host-reconstruction extras (meta-only program)
    ev_cksum: Optional[torch.Tensor] = None  # [B] uint32 (in int64) walk event checksum
    ir_feat_start: Optional[torch.Tensor] = None  # [B, F] i64 per-feature genomic starts
    ir_feat_take: Optional[torch.Tensor] = None  # [B, F] i32 per-feature taken lengths


def pick_transcripts(sk, cum_weights: torch.Tensor, site=rng.SITE_TRANSCRIPT):
    """Weighted choice: the float32 uniform, cast up, searched (left) in the
    float64 cumulative weights."""
    u = rng.uniform_per_slot(sk, site)
    idx = torch.searchsorted(cum_weights, u.to(cum_weights.dtype))
    return idx.clamp_max(cum_weights.shape[0] - 1).to(torch.int32)


def draw_ht_clamped(sk, tables: SimTables, ht_cap: int):
    """Transcriptome head/tail: remainder log-KDE (int truncation), ratio
    clamped to [0, 1] (simulator.py:1072-1075, 1200-1208)."""
    rem = _kde_draw(sk, rng.SITE_REMAINDER, tables.kde_ht, 1)[:, 0]
    ratio = _kde_draw(sk, rng.SITE_HT_RATIO, tables.kde_ht_ratio, 1)[:, 0].clamp(0.0, 1.0)
    remainder = rem.to(torch.int32).clamp_min(0)
    # an int32 times a float32 is a float32 product; round half to even
    head = torch.round(remainder * ratio).to(torch.int32)
    head = torch.where(remainder == 0, 0, head).to(torch.int32)
    tail = remainder - head
    ok = remainder <= ht_cap
    return remainder, head, tail, ok


def polya_length(sk, retain: torch.Tensor, scale: float):
    """int(scipy.stats.expon.rvs(loc=2, scale)) per lane
    (simulator.py:1046-1053), in float32 with XLA's log1p."""
    u = rng.uniform_per_slot(sk, rng.SITE_POLYA)
    f32 = torch.float32
    s = torch.tensor(np.float32(scale), dtype=f32, device=u.device)
    two = torch.tensor(2.0, dtype=f32, device=u.device)
    ln = (two - s * xla_math.log1p_f32(-u)).to(torch.int32)  # truncation toward 0
    return torch.where(retain, ln, 0).to(torch.int32)


def transcriptome_batch(
    base_key: torch.Tensor,
    slots: torch.Tensor,
    genome: extract.GenomeDevice,  # the TRANSCRIPTOME
    tables: SimTables,
    cum_weights: torch.Tensor,  # [n_eligible] f64 expression cumulative weights
    trx_of_eligible: torch.Tensor,  # [n_eligible] -> transcript index
    polya_mask: torch.Tensor,  # [n_trx] bool
    *,
    l_cap: int,
    l_out: int,
    ht_cap: int,
    e_max: int,
    fastq: bool,
    perfect: bool,
    uracil: bool,
    polya_scale: float,
    with_ir: bool = False,
    kmer_bias: Optional[int] = None,
    hp_r_max: int = 256,
    ir_tables=None,  # ir.IRTables when with_ir
    ir_genome: Optional[extract.GenomeDevice] = None,
    exact_conditional: bool = False,
    emit_reads: bool = True,
) -> TrxBatchOut:
    """The aligned transcriptome batch program: read-emitting, or with
    emit_reads=False the meta-only one (plain aligned path, no -hp), which
    accepts the same lanes.  exact_conditional draws the aligned length from
    the 2D KDE's exact conditional instead of the reference's
    nearest-of-a-pool estimator."""
    if not emit_reads and kmer_bias is not None:
        raise ValueError("the meta-only transcriptome program supports the plain aligned path")
    B = slots.shape[0]
    dev = slots.device
    sk = rng.slot_keys(base_key, slots)

    trx = trx_of_eligible[pick_transcripts(sk, cum_weights).long()]
    tl = trx.long()
    trx_len = genome.lengths[tl].to(torch.int32)

    # aligned length given transcript length, rejected until < transcript
    # length (simulator.py:1098-1104): the reference's nearest-of-pool
    # estimator, two rounds of a pool of K; or with exact_conditional four
    # rounds of the exact conditional (the same site, drawn as (4, 2))
    aligned = torch.zeros(B, dtype=torch.int32, device=dev)
    got = torch.zeros(B, dtype=torch.bool, device=dev)
    lo = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    hi = torch.tensor(1 - 1e-7, dtype=torch.float32, device=dev)
    cond = trx_len.to(torch.float32)
    if exact_conditional:
        u2 = rng.uniform_per_slot(sk, rng.SITE_ALIGNED_2D, (4, 2))
        rounds = 4
    else:
        K = 256
        u2 = rng.uniform_per_slot(sk, rng.SITE_ALIGNED_2D, (2, K, 3))
        rounds = 2
    for r in range(rounds):
        if exact_conditional:
            z = _ndtri(torch.minimum(torch.maximum(u2[:, r, 1], lo), hi))
            cand = tables.kde_aligned_2d.sample_conditional(cond, u2[:, r, 0], z)
        else:
            comp = u2[:, r, :, 0]
            z0 = _ndtri(torch.minimum(torch.maximum(u2[:, r, :, 1], lo), hi))
            z1 = _ndtri(torch.minimum(torch.maximum(u2[:, r, :, 2], lo), hi))
            cand = tables.kde_aligned_2d.sample_nearest_pool(cond, comp, z0, z1)
        cand = cand.to(torch.int32)
        ok = (cand > 0) & (cand < trx_len)
        take = (~got) & ok
        aligned = torch.where(take, cand, aligned)
        got = got | ok
    valid = got & (aligned <= l_cap)

    zero_b = torch.zeros(B, dtype=torch.int32, device=dev)
    if perfect:
        middle_ref = aligned
        l_new = aligned
        ev_pos2x = torch.zeros((B, 8), dtype=torch.int32, device=dev)
        ev_type = torch.zeros_like(ev_pos2x)
        ev_len = torch.zeros_like(ev_pos2x)
        ev_valid = torch.zeros((B, 8), dtype=torch.bool, device=dev)
        n_events = zero_b
        head = tail = zero_b
    else:
        walk = error_walk.error_walk(sk, aligned, tables.first_match, tables.match_markov,
                                     tables.mixtures, tables.trans, e_max)
        middle_ref, l_new = walk.middle_ref, walk.l_new
        ev_pos2x, ev_type, ev_len, ev_valid = (walk.events_pos2x, walk.events_type,
                                               walk.events_len, walk.events_valid)
        n_events = walk.n_events
        # reject when errors push past the transcript (simulator.py:1148-1149)
        valid &= ~walk.overflow & (middle_ref <= trx_len) & (middle_ref <= l_cap)
        valid &= l_new <= l_cap
        _, head, tail, ht_ok = draw_ht_clamped(sk, tables, ht_cap)
        valid &= ht_ok

    # --- intron retention decision + interval extraction -------------------
    use_ir = with_ir and not perfect
    has_ir = torch.zeros(B, dtype=torch.bool, device=dev)
    n_ir = zero_b
    ir_intervals = torch.zeros((B, 1, 2), dtype=torch.int64, device=dev)
    if use_ir:
        (ir_seg, ir_pos, ir_extract_len, has_ir, ir_intervals, n_ir, ir_retain_end,
         ir_feat_start, ir_feat_take) = ir.ir_walk_and_extract(
            sk, trx, middle_ref, trx_len, ir_tables, ir_genome, l_cap)

    # --- extraction --------------------------------------------------------
    local_pos, pos_ok = extract.sample_transcript_positions(sk, trx, middle_ref, genome)
    valid &= pos_ok
    if emit_reads:
        ref_seg = extract.gather_segments(genome, trx, local_pos, middle_ref, l_cap)
        if use_ir:
            ref_seg = torch.where(has_ir[:, None], ir_seg, ref_seg)
    if use_ir:
        local_pos = torch.where(has_ir, ir_pos, local_pos)
        valid &= torch.where(has_ir, ir_extract_len == middle_ref, True)
    if emit_reads:
        u_iupac, u_mis = rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (l_cap,))
        ref_seg = seqops.resolve_iupac(ref_seg, u_iupac)

    # polyA retention: non-IR reads reach the 3' end within 10 bp
    # (extract_read_trx, simulator.py:1683-1691); IR reads use the genomic
    # interval test (extract_read_pos, simulator.py:186-189)
    trx_has_polya = polya_mask[tl]
    reach_end = local_pos + middle_ref + 10 >= genome.lengths[tl]
    retain_polya = trx_has_polya & reach_end
    if use_ir:
        retain_polya = torch.where(has_ir, trx_has_polya & ir_retain_end, retain_polya)
    pa_len = polya_length(sk, retain_polya, polya_scale) if polya_scale > 0 else zero_b

    u_strand = rng.uniform_per_slot(sk, rng.SITE_STRAND)
    is_rev = u_strand > tables.strandness_rate
    if not emit_reads:
        # Meta-only program (host reconstruction): no ref gather, no
        # materialization, no [B, l_out] assembly.  l_new is the
        # dict-overwrite-aware read length; acceptance matches the full
        # program's exactly.
        eff = apply_errors.effective_lens(ev_pos2x, ev_type, ev_len, ev_valid)
        zero = torch.zeros_like(eff)
        dsum = torch.where(ev_valid & (ev_type == 2), eff, zero).sum(dim=1)
        isum = torch.where(ev_valid & (ev_type == 1), eff, zero).sum(dim=1)
        l_new2 = (middle_ref - dsum + isum).to(torch.int32)
        total = head + l_new2 + pa_len + tail
        valid &= total <= l_out
        if use_ir:
            feat_start, feat_take = ir_feat_start, ir_feat_take
        else:
            feat_start = torch.zeros((B, 1), dtype=torch.int64, device=dev)
            feat_take = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        return TrxBatchOut(
            read=None, quals=None, valid=valid, total_len=total, head=head, tail=tail,
            polya_len=pa_len, middle_ref=middle_ref, l_new=l_new2, trx=trx,
            local_pos=local_pos, is_reversed=is_rev, ev_pos2x=ev_pos2x, ev_type=ev_type,
            ev_len=ev_len, n_events=n_events, has_ir=has_ir, ir_intervals=ir_intervals,
            n_ir=n_ir, ref_seg=None, read_prehp=None, m_ref_init=aligned,
            ev_cksum=event_checksum(ev_pos2x, ev_type, ev_len, n_events),
            ir_feat_start=feat_start, ir_feat_take=feat_take,
        )

    read_prehp = ref_seg
    if perfect:
        read_mid = ref_seg
        qclass_mid = torch.zeros((B, l_cap), dtype=torch.int32, device=dev)
    else:
        if kmer_bias is not None:
            keep = homopolymer.suppress_hp_errors(ref_seg, middle_ref, ev_pos2x, ev_type,
                                                  ev_len, ev_valid, kmer_bias)
            ev_len = torch.where(keep, ev_len, 0)
        gm = apply_errors.build_gather_map(ev_pos2x, ev_type, ev_len, ev_valid, middle_ref,
                                           l_cap)
        u_ins, _ = rng.uniform2_per_slot(sk, rng.SITE_INS_BASE, (l_cap,))
        read_mid = apply_errors.materialize_read(gm.src, gm.qclass, gm.valid, ref_seg, u_mis,
                                                 u_ins)
        qclass_mid = gm.qclass
        l_new = gm.read_len
        read_prehp = read_mid
        if kmer_bias is not None:
            read_mid, qclass_mid, l_new, hp_ok = homopolymer.resize_homopolymers(
                sk, read_mid, qclass_mid, l_new, tables.hp_breaks, tables.hp_vals,
                tables.hp_mis_rate, kmer_bias, hp_r_max, l_cap)
            valid &= hp_ok

    # --- assembly: head + mutated middle + polyA + tail --------------------
    j = torch.arange(l_out, dtype=torch.int32, device=dev)[None, :]
    headc = head[:, None]
    l_newc = l_new[:, None]
    pac = pa_len[:, None]
    total = head + l_new + pa_len + tail
    totalc = total[:, None]
    valid &= total <= l_out

    in_head = j < headc
    in_mid = (j >= headc) & (j < headc + l_newc)
    in_pa = (j >= headc + l_newc) & (j < headc + l_newc + pac)
    in_tail = (j >= headc + l_newc + pac) & (j < totalc)

    mid_idx = (j - headc).clamp(0, l_cap - 1).long()
    mid_bases = torch.gather(read_mid, 1, mid_idx)
    u_ht = rng.uniform_per_slot(sk, rng.SITE_HEAD_TAIL, (ht_cap,))
    ht_idx = torch.where(in_tail, j - l_newc - pac, j)
    ht_bases = seqops.random_bases(torch.gather(u_ht, 1, ht_idx.clamp(0, ht_cap - 1).long()))
    base = torch.where(in_mid, mid_bases,
                       torch.where(in_pa, ord("A"),
                                   torch.where(in_head | in_tail, ht_bases, 0))).to(torch.uint8)

    read = torch.where(is_rev[:, None], seqops.reverse_complement(base, total), base)
    if uracil:
        read = torch.where(read != 0, seqops.to_uracil(read), read)

    quals = torch.zeros((B, l_out), dtype=torch.uint8, device=dev)
    if fastq:
        cls_mid = torch.gather(qclass_mid, 1, mid_idx)
        cls = torch.where(in_mid, cls_mid, apply_errors.QCLASS_HT)  # polyA quals are ht-class
        u_q = rng.uniform_per_slot(sk, rng.SITE_QUAL, (l_out,))
        q = tables.qual.sample(cls, u_q)
        q = torch.where(j < totalc, q, 0)
        q = torch.where(is_rev[:, None], seqops.reverse_quals(q, total), q)
        quals = torch.where(j < totalc, (q + 33).to(torch.uint8), 0).to(torch.uint8)

    return TrxBatchOut(
        read=read, quals=quals, valid=valid, total_len=total, head=head, tail=tail,
        polya_len=pa_len, middle_ref=middle_ref, l_new=l_new, trx=trx, local_pos=local_pos,
        is_reversed=is_rev, ev_pos2x=ev_pos2x, ev_type=ev_type, ev_len=ev_len,
        n_events=n_events, has_ir=has_ir, ir_intervals=ir_intervals, n_ir=n_ir,
        ref_seg=ref_seg, read_prehp=read_prehp, m_ref_init=aligned,
    )


TRX_META_SCALARS = 16  # valid,total,head,tail,pa,mref,lnew,trx,pos,rev,nev,cksum,mref0,has_ir,n_ir,ir_chrom


@tracing.traced("dispatch.compact")
def pack_trx_meta(out: TrxBatchOut, ir_chrom: torch.Tensor) -> torch.Tensor:
    """ONE [B, K] int64 transfer for the reconstruction writer (events stay on
    the device; the host replays them against the checksum)."""
    scal = [out.valid, out.total_len, out.head, out.tail, out.polya_len,
            out.middle_ref, out.l_new, out.trx, out.local_pos,
            out.is_reversed, out.n_events, out.ev_cksum, out.m_ref_init,
            out.has_ir, out.n_ir, ir_chrom]
    B = out.ir_intervals.shape[0]
    parts = [torch.stack([c.long() for c in scal], dim=1),
             out.ir_intervals.reshape(B, -1).long(),
             out.ir_feat_start.long(), out.ir_feat_take.long()]
    return torch.cat(parts, dim=1)


def decode_trx_meta(meta, n_iv: int, F: int) -> dict:
    names = ["valid", "total", "head", "tail", "pa", "mref", "lnew", "trx",
             "pos", "rev", "n_events", "cksum", "mref0", "has_ir", "n_ir",
             "ir_chrom"]
    d = {nm: meta[:, i] for i, nm in enumerate(names)}
    d["valid"] = d["valid"].astype(bool)
    d["rev"] = d["rev"].astype(bool)
    d["has_ir"] = d["has_ir"].astype(bool)
    off = TRX_META_SCALARS
    d["ir_iv"] = meta[:, off : off + 2 * n_iv].reshape(len(meta), n_iv, 2)
    off += 2 * n_iv
    d["feat_start"] = meta[:, off : off + F]
    off += F
    d["feat_take"] = meta[:, off : off + F]
    return d


class TrxReconHandle:
    """A dispatched meta-only transcriptome batch."""

    def __init__(self, meta_dev, slots, sim, seed, n_iv, F):
        self.meta_dev = meta_dev
        self.slots = slots
        self.sim = sim
        self.seed = seed
        self.n_iv = n_iv
        self.F = F
        self._decoded = None

    def decoded(self) -> dict:
        """The host view of the batch's metadata (one transfer)."""
        if self._decoded is None:
            with tracing.span("fetch", self.slots):
                tracing.count("batches.fetched")
                with tracing.span("fetch.copy"):
                    meta = self.meta_dev.cpu().numpy()
                with tracing.span("fetch.decode"):
                    self._decoded = decode_trx_meta(meta, self.n_iv, self.F)
        return self._decoded
