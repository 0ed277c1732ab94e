"""Device-side batch compaction: valid lanes -> one flat transfer buffer.

A batch leaves the device as ONE uint8 buffer holding only the valid lanes'
used prefixes:

  meta   -> (B+1) rows x META_COLS int64 little-endian; the last row holds
            the needed chunk counts;
  reads  -> (read-emitting programs) 2-bit codes, 4 bases/byte, each lane
            starting at a 256-byte aligned offset; or raw bytes, one per
            base (pack_reads=False: direct RNA reads carry 'U', which has
            no 2-bit code);
  events -> (only when asked for: the checksum fallback) one u32 per walk
            event (pos2x | len << 17 | type << 30), each lane starting at a
            64-word (256-byte) aligned offset;
  quals  -> (read-emitting programs, FASTQ) raw phred+33 bytes, 256-byte
            aligned offsets;
  prehp  -> (homopolymer mode off the reconstruction route) the pass-1
            mutated middle before run resizing, 2-bit codes like the reads;
            the metadata then has one more column, the pass-1 length.

The host replays each lane's walk and checks it against the per-lane event
checksum in the metadata, so the event stream normally stays on the device.
Offsets are a pure function of (valid, total, n_events), so the host
recomputes them from the metadata instead of transferring them.

Capacities are static.  The packer reports the needed chunk counts in the
metadata tail; a batch that overflows its capacity is repacked larger.
The buffer layout is the JAX package's (sim/compact.py there), byte for byte;
the prehp stream is this package's own (the JAX package moves the pre-resize
middle through a second, padded transfer format).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.apply_errors import _pack_codes4, effective_lens

CHUNK = 256  # bytes per aligned chunk; events use 64 u32 words

# valid,total,head,tail,middle_ref,l_new,chrom,pos,rev,n_events,cap_over,
# m_ref_init, ev_checksum (walk-replay verification)
META_COLS = 13
MASK32 = 0xFFFFFFFF


def _chunk_compact(rows_bytes: torch.Tensor, lane_bytes: torch.Tensor, cap_chunks: int):
    """Compact per-lane byte prefixes into a flat chunk-aligned buffer.

    rows_bytes: [B, W] uint8 (W a multiple of CHUNK)
    lane_bytes: [B] used bytes per lane (0 for skipped lanes)
    cap_chunks: output capacity in CHUNK-byte chunks

    Returns (flat [cap_chunks * CHUNK] u8, n_chunks_needed int64 scalar).
    """
    B, W = rows_bytes.shape
    dev = rows_bytes.device
    mc = W // CHUNK  # max chunks per lane
    rows = rows_bytes.reshape(B * mc, CHUNK)
    nch = (lane_bytes.long() + (CHUNK - 1)) // CHUNK
    off = torch.cumsum(nch, 0) - nch  # exclusive prefix
    need = off[-1] + nch[-1]
    c = torch.arange(mc, dtype=torch.int64, device=dev)[None, :]
    mask = c < nch[:, None]
    dst = torch.where(mask, off[:, None] + c, torch.full_like(c, cap_chunks))
    src_rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * mc + c
    # slot cap_chunks collects the out-of-range writes and is dropped
    chunk_src = torch.zeros(cap_chunks + 1, dtype=torch.int64, device=dev)
    chunk_src[dst.clamp_max(cap_chunks).reshape(-1)] = src_rows.expand(B, mc).reshape(-1)
    chunk_src = chunk_src[:cap_chunks].clamp(0, B * mc - 1)
    return rows[chunk_src].reshape(cap_chunks * CHUNK), need


def _u32_le_bytes(w: torch.Tensor) -> torch.Tensor:
    """[B, E] int64 holding uint32 -> [B, 4E] uint8 little-endian."""
    parts = [((w >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(w.shape[0], -1)


def event_words(ev_pos2x, ev_type, ev_len) -> torch.Tensor:
    """Host-link event words pos2x | len << 17 | type << 30 (uint32 in int64)."""
    return (ev_pos2x.long() | (ev_len.long() << 17) | (ev_type.long() << 30)) & MASK32


def event_checksum(ev_pos2x, ev_type, ev_len, n_events) -> torch.Tensor:
    """Order-sensitive 32-bit checksum over each lane's first n_events packed
    event words (uint32 in int64; the host walk replay recomputes it)."""
    w = event_words(ev_pos2x, ev_type, ev_len)
    e_i = torch.arange(w.shape[1], dtype=torch.int64, device=w.device)[None, :]
    terms = ((w + 1) * (2 * e_i + 1)) & MASK32
    mask = e_i < n_events.long()[:, None]
    return torch.where(mask, terms, 0).sum(dim=1) & MASK32


def compact_pack(
    valid,  # [B] bool
    total,  # [B] int32
    head,
    tail,
    middle_ref,
    l_new,
    chrom,
    local_pos,
    is_rev,
    n_events,
    cap_over,
    ev_pos2x,  # [B, E] int32
    ev_type,
    ev_len,
    m_ref_init,  # [B] int32
    *,
    ne_cap: int,  # event capacity, CHUNK-byte chunks
    with_events: bool,
    with_checksum: bool,
    read=None,  # [B, L] uint8 ASCII, final orientation (read-emitting programs)
    quals=None,  # [B, L] uint8 phred+33 (FASTQ)
    nr_cap: int = 1,  # read capacity, CHUNK-byte chunks
    nq_cap: int = 1,  # qual capacity, CHUNK-byte chunks
    prehp=None,  # [B, l_cap] uint8 ASCII pass-1 middle (homopolymer mode)
    np_cap: int = 1,  # prehp capacity, CHUNK-byte chunks
    pack_reads: bool = True,  # False: the reads travel as raw bytes
) -> torch.Tensor:
    """ONE uint8 transfer buffer: [ meta (B+1 rows x META_COLS i64 LE, one more
    column with prehp; last row = needed chunk counts) | flat reads, 2-bit or
    raw (read given) | flat events (with_events) | flat quals (quals given) |
    flat 2-bit pre-resize middles (prehp given) ]."""
    B = valid.shape[0]
    dev = valid.device
    v64 = valid.long()
    parts = []
    need_r = torch.zeros((), dtype=torch.int64, device=dev)
    need_e = torch.zeros((), dtype=torch.int64, device=dev)
    need_q = torch.zeros((), dtype=torch.int64, device=dev)
    need_p = torch.zeros((), dtype=torch.int64, device=dev)
    if read is not None:
        if pack_reads:
            packed = _pack_codes4(read)
            lane_bytes = v64 * ((total.long() + 3) // 4)
        else:
            packed = read
            lane_bytes = v64 * total.long()
        padw = (-packed.shape[1]) % CHUNK
        if padw:
            packed = torch.nn.functional.pad(packed, (0, padw))
        flat_r, need_r = _chunk_compact(packed, lane_bytes, nr_cap)
        parts.append(flat_r)
    if with_events:
        evb = _u32_le_bytes(event_words(ev_pos2x, ev_type, ev_len))  # [B, 4E]
        pade = (-evb.shape[1]) % CHUNK
        if pade:
            evb = torch.nn.functional.pad(evb, (0, pade))
        flat_e, need_e = _chunk_compact(evb, v64 * 4 * n_events.long(), ne_cap)
        parts.append(flat_e)
    if quals is not None:
        padq = (-quals.shape[1]) % CHUNK
        q = torch.nn.functional.pad(quals, (0, padq)) if padq else quals
        flat_q, need_q = _chunk_compact(q, v64 * total.long(), nq_cap)
        parts.append(flat_q)
    extra_cols = []
    if prehp is not None:
        # the pass-1 length: middle_ref - deleted + inserted bases of the
        # (suppression-zeroed) events, as build_gather_map counts them
        live = (torch.arange(ev_len.shape[1], dtype=torch.int64, device=dev)[None, :]
                < n_events.long()[:, None])
        eff = effective_lens(ev_pos2x, ev_type, ev_len, live).long()
        zero = torch.zeros_like(eff)
        pre_len = (middle_ref.long()
                   - torch.where(live & (ev_type == 2), eff, zero).sum(dim=1)
                   + torch.where(live & (ev_type == 1), eff, zero).sum(dim=1))
        pre_len = pre_len.clamp(0, prehp.shape[1])
        packed_p = _pack_codes4(prehp)
        padp = (-packed_p.shape[1]) % CHUNK
        if padp:
            packed_p = torch.nn.functional.pad(packed_p, (0, padp))
        flat_p, need_p = _chunk_compact(packed_p, v64 * ((pre_len + 3) // 4), np_cap)
        parts.append(flat_p)
        extra_cols.append(pre_len)

    if with_checksum:
        cksum = event_checksum(ev_pos2x, ev_type, ev_len, n_events)
    else:
        cksum = torch.zeros(B, dtype=torch.int64, device=dev)
    cols = [valid, total, head, tail, middle_ref, l_new, chrom, local_pos,
            is_rev, n_events, cap_over, m_ref_init, cksum] + extra_cols
    meta = torch.stack([c.long() for c in cols], dim=1)  # [B, 13 or 14]
    tail_row = torch.zeros((1, len(cols)), dtype=torch.int64, device=dev)
    tail_row[0, :4] = torch.stack([need_r, need_e, need_q, need_p])
    meta = torch.cat([meta, tail_row])
    meta_bytes = meta.contiguous().view(torch.uint8).reshape(-1)  # little-endian
    return torch.cat([meta_bytes] + [p.reshape(-1) for p in parts])


# --- host-side decoding ------------------------------------------------------


class CompactBatch:
    """Host view of a compacted batch: metadata dict + flat streams with
    per-lane offsets recomputed from the metadata (same arithmetic as the
    device packer, by construction)."""

    __slots__ = (
        "valid", "total", "head", "tail", "middle_ref", "l_new", "chrom",
        "pos", "rev", "n_events", "cap_over",
        "reads_flat", "read_off", "ev_flat", "ev_off", "quals_flat", "qual_off",
        "pack_reads", "needs", "m_ref", "ev_checksum", "slots", "recon",
        "finish", "prehp_flat", "prehp_off", "prehp_len",
    )

    def __getitem__(self, k):  # dict-style access for writer compatibility
        return getattr(self, "pos" if k == "pos" else k)

    def __contains__(self, k):
        return hasattr(self, k)


def decode_compact(
    buf: np.ndarray,
    B: int,
    nr_cap: int,
    ne_cap: int,
    nq_cap: int,
    fastq: bool,
    with_events: bool,
    pack_reads: bool = True,
    with_reads: bool = True,
    np_cap: int = 0,  # prehp capacity; 0 = the buffer holds no prehp stream
):
    """Parse the fused transfer buffer.  Returns (CompactBatch, ok) where
    ok=False means a stream overflowed its capacity (repack needed); the
    first value is then the needed chunk counts (reads, events, quals,
    prehp)."""
    n_cols = META_COLS + (1 if np_cap else 0)
    meta_n = (B + 1) * n_cols * 8
    meta = buf[:meta_n].view("<i8").reshape(B + 1, n_cols)
    needs = tuple(int(x) for x in meta[B, :4])
    if (needs[0] > nr_cap or needs[1] > ne_cap or needs[2] > nq_cap
            or (np_cap and needs[3] > np_cap)):
        return needs, False

    cb = CompactBatch()
    cb.needs = needs
    m = meta[:B]
    cb.valid = m[:, 0].astype(bool)
    cb.total = m[:, 1]
    cb.head = m[:, 2]
    cb.tail = m[:, 3]
    cb.middle_ref = m[:, 4]
    cb.l_new = m[:, 5]
    cb.chrom = m[:, 6]
    cb.pos = m[:, 7]
    cb.rev = m[:, 8].astype(bool)
    cb.n_events = m[:, 9]
    cb.cap_over = m[:, 10].astype(bool)
    cb.m_ref = m[:, 11]
    cb.ev_checksum = m[:, 12].astype(np.uint32)
    cb.pack_reads = pack_reads

    v = cb.valid.astype(np.int64)
    off = meta_n
    cb.recon = None
    cb.finish = None

    if with_reads:
        lane_bytes = v * ((cb.total + 3) // 4 if pack_reads else cb.total)
        nch = (lane_bytes + CHUNK - 1) // CHUNK
        cb.read_off = (np.cumsum(nch) - nch) * CHUNK
        cb.reads_flat = buf[off : off + nr_cap * CHUNK]
        off += nr_cap * CHUNK
    else:
        cb.read_off = None
        cb.reads_flat = None

    if with_events:
        ev_bytes = v * 4 * cb.n_events
        ech = (ev_bytes + CHUNK - 1) // CHUNK
        cb.ev_off = (np.cumsum(ech) - ech) * (CHUNK // 4)  # word offsets
        cb.ev_flat = buf[off : off + ne_cap * CHUNK].view("<u4")
        off += ne_cap * CHUNK
    else:
        cb.ev_off = np.zeros(B, np.int64)
        cb.ev_flat = np.zeros(1, np.uint32)

    if fastq:
        qch = (v * cb.total + CHUNK - 1) // CHUNK
        cb.qual_off = (np.cumsum(qch) - qch) * CHUNK
        cb.quals_flat = buf[off : off + nq_cap * CHUNK]
        off += nq_cap * CHUNK
    else:
        cb.qual_off = np.zeros(B, np.int64)
        cb.quals_flat = np.zeros(1, np.uint8)

    if np_cap:
        cb.prehp_len = m[:, META_COLS]
        pch = (v * ((cb.prehp_len + 3) // 4) + CHUNK - 1) // CHUNK
        cb.prehp_off = (np.cumsum(pch) - pch) * CHUNK
        cb.prehp_flat = buf[off : off + np_cap * CHUNK]
    else:
        cb.prehp_len = cb.prehp_off = cb.prehp_flat = None

    return cb, True


# byte -> its four bases (code 4w+k at bits 2k)
_DEC_LUT = np.frombuffer(b"ACGT", np.uint8)[(np.arange(256)[:, None] >> (2 * np.arange(4))) & 3]


def _decode_2bit(flat: np.ndarray, off: int, n: int) -> np.ndarray:
    return _DEC_LUT[flat[off : off + (n + 3) // 4]].reshape(-1)[:n]


def decode_reads_ascii(cb: CompactBatch, lanes) -> list:
    """Decode selected lanes back to ASCII arrays (2-bit or raw reads)."""
    if not cb.pack_reads:
        return [cb.reads_flat[int(cb.read_off[b]) : int(cb.read_off[b]) + int(cb.total[b])]
                for b in lanes]
    return [_decode_2bit(cb.reads_flat, int(cb.read_off[b]), int(cb.total[b])) for b in lanes]


def decode_prehp_ascii(cb: CompactBatch, b: int) -> np.ndarray:
    """One lane's pre-resize middle (homopolymer mode) as ASCII."""
    return _decode_2bit(cb.prehp_flat, int(cb.prehp_off[b]), int(cb.prehp_len[b]))
