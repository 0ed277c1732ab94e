"""Vectorized error application: event lists -> read bytes.

The reference's `mutate_read` (simulator.py:1919-2015) splices Python strings
per error, walking events in reverse position order.  Because events never
overlap and positions refer to the *original* extracted slice, the whole edit
script can be applied in one shot from per-position difference arrays and
prefix sums; everything is [B, L] elementwise/cumsum/scatter work, no
per-read loops.

Insertion key convention (`pos2x`, half-position fixed point): an insertion
with key K in the reference (K = pos - 0.5 aligned, pos + 0.1 unaligned)
inserts before ref index ceil(K) = (pos2x + 1) // 2.

Every cumulative sum here passes ``dtype=torch.int32``: torch's cumsum of an
int32 tensor is int64 otherwise, where JAX's stays int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import gather, rng
from .gather import pack_codes

CLASS_MATCH, CLASS_MIS, CLASS_INS = 0, 1, 2
QCLASS_HT = 3

_I32 = torch.int32


def effective_lens(ev_pos2x, ev_type, ev_len, ev_valid, dedup_ins: bool = True):
    """Reference dict-overwrite semantics for duplicate insertion keys.

    The reference stores events as `e_dict[pos - 0.5] = [type, len]`
    (simulator.py:1880-1882): consecutive insertions separated by zero-length
    matches share the key, so every one but the LAST is silently overwritten
    — it contributes to error_list's l_new (the first length filter) but is
    never spliced into the read nor logged.  Mirror that by zeroing the
    length of any insertion whose successor is an insertion with the same
    position key.  (mis/del advance the position, so only insertions can
    collide; colliding events are always adjacent.)

    dedup_ins=False leaves lengths untouched: the UNALIGNED walk's reference
    counterpart MERGES consecutive insertions into one dict entry
    (simulator.py:1810-1814), which adjacent same-key events already model.
    """
    if not dedup_ins:
        return ev_len
    pad = torch.zeros_like(ev_valid[:, :1])
    nxt_ins = torch.cat([(ev_type[:, 1:] == 1) & ev_valid[:, 1:], pad], dim=1)
    nxt_same = torch.cat([ev_pos2x[:, 1:] == ev_pos2x[:, :-1], pad], dim=1)
    dead = (ev_type == 1) & ev_valid & nxt_ins & nxt_same
    return torch.where(dead, torch.zeros_like(ev_len), ev_len)


def _cumsum(x, dim=1):
    return torch.cumsum(x, dim=dim, dtype=_I32)


def _add_at(width: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[B, width] int32 zeros with val [B, E] added at idx [B, E] (clipped to
    the row, as JAX's ``.at[].add`` clips)."""
    out = torch.zeros((idx.shape[0], width), dtype=_I32, device=idx.device)
    return out.scatter_add_(1, idx.clamp(0, width - 1).long(), val.to(_I32))


class GatherMap(NamedTuple):
    """Per-output-base construction recipe.

    src:    [B, L_read] int32 — source ref index, or -1 for inserted bases.
    src_left: [B, L_read] int32 — the uncensored shift map: for inserted
        positions this resolves to the ref base just LEFT of the insertion
        point (used by homopolymer extension to replicate the run base).
    qclass: [B, L_read] int32 — CLASS_MATCH / CLASS_MIS / CLASS_INS.
    valid:  [B, L_read] bool — j < read length.
    read_len: [B] int32.
    """

    src: torch.Tensor
    src_left: torch.Tensor
    qclass: torch.Tensor
    valid: torch.Tensor
    read_len: torch.Tensor


def build_gather_map(
    events_pos2x: torch.Tensor,  # [B, E] int32
    events_type: torch.Tensor,  # [B, E] int32 (0=mis 1=ins 2=del)
    events_len: torch.Tensor,  # [B, E] int32
    events_valid: torch.Tensor,  # [B, E] bool
    middle_ref: torch.Tensor,  # [B] int32
    l_read: int,  # output capacity; also bounds ref length
    dedup_ins: bool = True,
) -> GatherMap:
    """Gather map of the aligned walk's edit script, in READ coordinates."""
    B = events_pos2x.shape[0]
    L = l_read
    dev = events_pos2x.device

    events_len = effective_lens(events_pos2x, events_type, events_len, events_valid,
                                dedup_ins)
    is_mis = events_valid & (events_type == 0)
    is_ins = events_valid & (events_type == 1)
    is_del = events_valid & (events_type == 2)

    start = events_pos2x // 2  # mis/del start (pos2x even)
    ins_before = (events_pos2x + 1) // 2  # insertion target index

    # Per-event READ-coordinate starts via cumulative sums over the (small)
    # event axis: read_start(e) = ref_start(e) - dels_before(e) + ins_before(e).
    dlen = torch.where(is_del, events_len, 0)
    ilen = torch.where(is_ins, events_len, 0)
    prior_del = _cumsum(dlen) - dlen
    prior_ins = _cumsum(ilen) - ilen
    ref_start = torch.where(is_ins, ins_before, start)
    rpos = ref_start - prior_del + prior_ins  # [B, E]

    # Everything else lives in READ coordinates, built from E-sized scatters
    # and [B, L] cumsums only:
    #   ins/mis events occupy read spans [rpos, rpos + len);
    #   deletions are zero-width points at rpos carrying weight len.
    def span_mask(flag):
        f = flag.to(_I32)
        diff = _add_at(L + 1, rpos, f)
        diff.scatter_add_(1, (rpos + events_len).clamp(0, L).long(), -f)
        return _cumsum(diff[:, :L]) > 0

    ins_mask = span_mask(is_ins)  # read positions holding inserted bases
    mis_mask = span_mask(is_mis)  # read positions holding substituted bases

    del_pts = _add_at(L + 1, rpos, dlen)
    D = _cumsum(del_pts[:, :L])  # deleted ref bases before-or-at j
    I = _cumsum(ins_mask.to(_I32))  # inserted read bases <= j

    j_idx = torch.arange(L, dtype=_I32, device=dev)[None, :].expand(B, L)
    # For a kept read position j, its source ref index is j shifted by the
    # net indel displacement accumulated so far.
    src_kept = j_idx - I + D
    src = torch.where(ins_mask, -1, src_kept)
    # within an insertion span the same algebra resolves to (insertion point
    # - 1), i.e. the ref base to the left — keep it for hp extensions
    src_left = torch.where(ins_mask, src_kept - 1, src_kept)
    cls = torch.where(ins_mask, CLASS_INS, torch.where(mis_mask, CLASS_MIS, CLASS_MATCH)).to(_I32)

    tot_del = dlen.sum(dim=1)
    tot_ins = ilen.sum(dim=1)
    read_len = (middle_ref - tot_del + tot_ins).to(_I32)

    valid = j_idx < read_len[:, None]
    src = torch.where(valid, src, -1)
    return GatherMap(src=src.to(_I32), src_left=src_left.to(_I32), qclass=cls, valid=valid,
                     read_len=read_len)


def presentation_cap(l_read: int) -> int:
    """build_unaligned_map's presentation buffer width: a lane whose
    middle_ref plus inserted bases exceeds it overflows and is rejected."""
    return l_read + (l_read >> 1) + 256


def build_unaligned_map(
    events_pos2x: torch.Tensor,  # [B, E] int32 (ins at 2*pos + 1)
    events_type: torch.Tensor,  # [B, E] int32 (0=mis 1=ins 2=del)
    events_len: torch.Tensor,  # [B, E] int32
    events_valid: torch.Tensor,  # [B, E] bool
    middle_ref: torch.Tensor,  # [B] int32
    l_read: int,
):
    """Gather map with the UNALIGNED walk's reference edit semantics.

    The reference keys unaligned insertions at pos + 0.1 (simulator.py:
    1810-1814), so mutate_read's reverse-order splicing makes a mis/del at
    the SAME pos act on L CONTIGUOUS post-insertion positions — starting at
    ref_pos and swallowing the just-inserted bases — not on L reference
    bases (the aligned walk's pos - 0.5 keys cannot overlap this way).
    Model: build the PRESENTATION sequence (ref bases with each ins block
    spliced after ref_{pos}), mark mis spans / del spans as L contiguous
    presentation positions from ref_pos, then compress deletions out.

    Returns (GatherMap, under_ins [B, l_read] bool, overflow [B] bool) —
    under_ins marks read positions whose PRE-substitution base is an
    inserted base (qclass says MIS there; materialize_read must mutate the
    ins draw, not the ref).
    """
    B = events_pos2x.shape[0]
    P = presentation_cap(l_read)
    L = l_read
    dev = events_pos2x.device

    is_mis = events_valid & (events_type == 0)
    is_ins = events_valid & (events_type == 1)
    is_del = events_valid & (events_type == 2)
    pos = events_pos2x // 2  # walk position of the event (ins: (2p+1)//2 = p)
    ilen = torch.where(is_ins, events_len, 0)
    prior_ins = _cumsum(ilen) - ilen
    # K_same: summed length of the immediately-preceding consecutive ins run
    # (an ins run never spans a pos-advancing event, so consecutive-in-buffer
    # means same walk position)
    r = _cumsum(ilen)
    boundary = torch.where(is_ins, torch.full_like(r, -1), r)
    reset = torch.cummax(boundary, dim=1).values
    reset_prev = torch.cat([torch.zeros((B, 1), dtype=_I32, device=dev),
                            reset[:, :-1].clamp_min(0)], dim=1)
    k_same = (r - ilen) - reset_prev  # ins len accumulated since last non-ins

    # presentation starts
    pres_ins = pos + prior_ins + 1
    pres_err = pos + (prior_ins - k_same)
    pres_start = torch.where(is_ins, pres_ins, pres_err)
    pres_end = pres_start + torch.where(events_valid, events_len, 0)

    def span(flag):
        f = flag.to(_I32)
        diff = _add_at(P + 1, pres_start, f)
        diff.scatter_add_(1, pres_end.clamp(0, P).long(), -f)
        return _cumsum(diff[:, :P]) > 0

    ins_mask = span(is_ins)
    mis_mask = span(is_mis)
    dead = span(is_del)

    j_p = torch.arange(P, dtype=_I32, device=dev)[None, :]
    I = _cumsum(ins_mask.to(_I32))
    src_pres = torch.where(ins_mask, torch.full_like(I, -1), j_p - I)
    tot_ins = ilen.sum(dim=1).to(_I32)
    pres_len = middle_ref + tot_ins  # total presentation positions
    in_pres = j_p < pres_len[:, None]
    alive = in_pres & ~dead
    read_idx = _cumsum(alive.to(_I32)) - 1
    read_len = alive.sum(dim=1).to(_I32)
    overflow = pres_len > P

    # alive positions land at their read index (unique); everything else, and
    # read indices past the row, goes to the discarded slot L
    dst = torch.where(alive, read_idx, L).clamp_max(L).long()
    src = torch.full((B, L + 1), -1, dtype=_I32, device=dev).scatter_(1, dst, src_pres)[:, :L]
    misr = torch.zeros((B, L + 1), dtype=torch.uint8, device=dev).scatter_(
        1, dst, mis_mask.to(torch.uint8))[:, :L].bool()
    insr = torch.zeros((B, L + 1), dtype=torch.uint8, device=dev).scatter_(
        1, dst, ins_mask.to(torch.uint8))[:, :L].bool()

    valid = torch.arange(L, dtype=_I32, device=dev)[None, :] < read_len[:, None]
    qclass = torch.where(misr, CLASS_MIS, torch.where(insr, CLASS_INS, CLASS_MATCH)).to(_I32)
    gm = GatherMap(
        src=torch.where(valid & ~insr, src, -1),
        src_left=src,
        qclass=qclass,
        valid=valid,
        read_len=read_len,
    )
    return gm, insr, overflow


def _pack_codes4(ascii_seq: torch.Tensor) -> torch.Tensor:
    """[B, L] ASCII -> [B, ceil(L/4)] packed 2-bit codes (4/byte, LE)."""
    return pack_codes(_ascii_to_code(ascii_seq))


# random_bases draws over (A, T, C, G) — np.random.choice order
# (seqops.random_bases) — map that choice index to 2-bit code A=0 C=1 G=2 T=3.
_CHOICE_CODE = torch.tensor([0, 3, 1, 2], dtype=torch.uint8)


def _choice_to_code(idx: torch.Tensor) -> torch.Tensor:
    return _CHOICE_CODE.to(idx.device)[idx.long()]


def fused_read_v2(
    events_pos2x: torch.Tensor,  # [B, E] int32
    events_type: torch.Tensor,  # [B, E] int32 (0=mis 1=ins 2=del)
    events_len: torch.Tensor,  # [B, E] int32
    events_valid: torch.Tensor,  # [B, E] bool
    middle_ref: torch.Tensor,  # [B] int32
    head: torch.Tensor,  # [B] int32
    tail: torch.Tensor,  # [B] int32
    is_rev: torch.Tensor,  # [B] bool
    ref_codes: torch.Tensor,  # [B, PB] uint8 packed 2-bit ref codes (IUPAC-resolved)
    n_ref_codes: int,  # logical code count (<= 4 * PB)
    seg_off,  # [B] int32 or None — code offset of the segment in the row
    sk: torch.Tensor,  # [B, 2] slot keys (head/tail base generation)
    u_mis: torch.Tensor,  # [B, l_out] uniforms, substituted-base choice
    u_ins: torch.Tensor,  # [B, l_out] uniforms, inserted-base choice
    l_out: int,
    ht_cap: int,
    ht_site: int = rng.SITE_HEAD_TAIL,
):
    """Mutation + head/tail assembly + strand flip in ONE [B, l_out] pass.

    Every map is built directly in FINAL OUTPUT coordinates: event spans and
    deletion points are scattered at strand-selected positions (reversed
    lanes scatter at mirrored indices), the indel-displacement prefix sums run
    once over [B, l_out], and one gather (gather.gather_codes, the plain
    version of the program's K3) fetches each middle base's 2-bit code from
    the packed reference row.  Span starts and deletion points share one index array (a
    deletion is zero-width in read coordinates), with the ins/mis start flags
    packed into one word (at most one ins and one mis span can START at a
    given output position, so 13-bit fields cannot carry).  Head/tail bases
    are generated at their output positions by counter-addressed threefry
    (rng.uniform_at — identical to gathering the SITE_HEAD_TAIL pool).
    Substitution/insertion uniforms are indexed by OUTPUT position.

    Returns (read [B, l_out] u8 ASCII, qclass [B, l_out] i32 with head/tail =
    3, l_new [B] i32, total [B] i32).  Positions >= total are zero.
    """
    B, E = events_pos2x.shape
    L = l_out
    dev = events_pos2x.device

    events_len = effective_lens(events_pos2x, events_type, events_len, events_valid)
    is_mis = events_valid & (events_type == 0)
    is_ins = events_valid & (events_type == 1)
    is_del = events_valid & (events_type == 2)

    start = events_pos2x // 2
    ins_before = (events_pos2x + 1) // 2
    dlen = torch.where(is_del, events_len, 0)
    ilen = torch.where(is_ins, events_len, 0)
    prior_del = _cumsum(dlen) - dlen
    prior_ins = _cumsum(ilen) - ilen
    ref_start = torch.where(is_ins, ins_before, start)
    rpos = ref_start - prior_del + prior_ins  # [B, E] middle read coords

    tot_del = dlen.sum(dim=1).to(_I32)
    tot_ins = ilen.sum(dim=1).to(_I32)
    l_new = (middle_ref - tot_del + tot_ins).to(_I32)
    total = head + l_new + tail

    h = head[:, None]
    n = l_new[:, None]
    t = tail[:, None]
    rev = is_rev[:, None]

    # deletions are zero-width in read coords: give them b == a so their
    # span start IS their deletion point (same index for both scatters)
    a = rpos
    b = torch.where(is_del, rpos, rpos + events_len)
    span_s = torch.where(rev, n + t - b, h + a)
    span_e = torch.where(rev, n + t - a, h + b)

    # flags pack into 13-bit fields: cumsum counts <= E <= 8191
    pk_flags = is_ins.to(_I32) | (is_mis.to(_I32) << 13)
    acc_s = _add_at(L + 1, span_s, pk_flags)
    acc_e = _add_at(L + 1, span_e, pk_flags)
    del_pts = _add_at(L + 1, span_s, dlen)

    cs = _cumsum(acc_s[:, :L])
    ce = _cumsum(acc_e[:, :L])
    ins_mask = (cs & 0x1FFF) > (ce & 0x1FFF)
    mis_mask = ((cs >> 13) & 0x1FFF) > ((ce >> 13) & 0x1FFF)
    Dcum = _cumsum(del_pts[:, :L])
    D = torch.where(rev, tot_del[:, None] - Dcum, Dcum)
    ins_i = ins_mask.to(_I32)
    Icum = _cumsum(ins_i)
    I = torch.where(rev, tot_ins[:, None] - (Icum - ins_i), Icum)

    j_idx = torch.arange(L, dtype=_I32, device=dev)[None, :]
    in_mid = torch.where(rev, (j_idx >= t) & (j_idx < t + n), (j_idx >= h) & (j_idx < h + n))
    in_head = torch.where(rev, j_idx >= n + t, j_idx < h)
    in_read = j_idx < total[:, None]
    m = torch.where(rev, n + t - 1 - j_idx, j_idx - h)

    src_mid = m - I + D
    if seg_off is not None:
        src_mid = src_mid + seg_off[:, None]
    src_mid = src_mid.clamp(0, n_ref_codes - 1).to(_I32)
    code = gather.gather_codes(ref_codes, src_mid)

    # head/tail bases generated at output coordinates (identical stream to
    # the SITE_HEAD_TAIL pool draw)
    ht_idx = torch.where(
        in_head,
        torch.where(rev, t + n + h - 1 - j_idx, j_idx),
        torch.where(rev, h + t - 1 - j_idx, j_idx - n),
    )
    u_ht = rng.uniform_at(sk, ht_site, ht_idx, ht_cap)
    ht_code = _choice_to_code(torch.floor(u_ht * 4.0).to(_I32).clamp_max(3))
    code = torch.where(in_mid, code, ht_code)

    # uint8 arithmetic, as in JAX: values stay below 7
    mis_off = 1 + torch.floor(u_mis * 3.0).to(torch.uint8)
    mis_code = (code + mis_off.clamp_max(3)) % 4
    ins_code = torch.floor(u_ins * 4.0).to(torch.uint8).clamp_max(3)
    mid_ins = in_mid & ins_mask
    mid_mis = in_mid & mis_mask & ~ins_mask
    out_code = torch.where(mid_mis, mis_code, code)
    out_code = torch.where(mid_ins, ins_code, out_code)
    out_code = torch.where(rev, 3 - out_code, out_code)

    read = torch.where(in_read, _code_to_ascii(out_code), 0).to(torch.uint8)
    qclass = torch.where(
        mid_ins, CLASS_INS,
        torch.where(mid_mis, CLASS_MIS, torch.where(in_mid, CLASS_MATCH, QCLASS_HT)),
    ).to(_I32)
    return read, qclass, l_new, total


# --- Base construction -----------------------------------------------------

_ASCII_CODE = torch.zeros(256, dtype=torch.uint8)
for _ch, _c in zip(b"CGT", (1, 2, 3)):
    _ASCII_CODE[_ch] = _c
_CODE_ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def _ascii_to_code(seq: torch.Tensor) -> torch.Tensor:
    """ASCII -> 2-bit code (A=0, C=1, G=2, T=3; any other byte -> 0)."""
    return _ASCII_CODE.to(seq.device)[seq.long()]


def _code_to_ascii(code: torch.Tensor) -> torch.Tensor:
    return _CODE_ASCII.to(code.device)[code.long()]


def materialize_read(
    gm_src: torch.Tensor,  # [B, L] int32
    gm_qclass: torch.Tensor,  # [B, L] int32
    gm_valid: torch.Tensor,  # [B, L] bool
    ref_seg: torch.Tensor,  # [B, L'] uint8 ASCII reference (L' >= L allowed)
    u_mis: torch.Tensor,  # [B, L] uniforms for substituted-base choice
    u_ins: torch.Tensor,  # [B, L] uniforms for inserted-base choice
    under_ins=None,  # [B, L] bool: read positions whose PRE-substitution base
    # is an inserted base (unaligned-walk overlap semantics,
    # build_unaligned_map) — substitutions there mutate the ins draw
) -> torch.Tensor:
    """[B, L] uint8 ASCII mutated read (padding positions = 0).

    Substitutions pick uniformly among the 3 non-identical bases
    (mutate_read, simulator.py:1965-1978); insertions uniformly among 4
    (simulator.py:1986-1995).  The reference-byte gather is gather.gather_u8
    (the plain version of the program's K4).  Every caller here extracts its segment
    per byte at offset 0, so the JAX package's optional per-lane ``src_offset``
    (chunked extraction) has no counterpart.
    """
    L = gm_src.shape[1]
    src = gm_src.clamp(0, L - 1).clamp(0, ref_seg.shape[1] - 1)
    code = _ascii_to_code(gather.gather_u8(ref_seg, src))

    ins_code = torch.floor(u_ins * 4.0).to(torch.uint8).clamp_max(3)
    if under_ins is not None:
        code = torch.where(under_ins, ins_code, code)
    mis_off = 1 + torch.floor(u_mis * 3.0).to(torch.uint8)
    mis_code = (code + mis_off.clamp_max(3)) % 4

    out_code = torch.where(gm_qclass == CLASS_MIS, mis_code, code)
    out_code = torch.where(gm_qclass == CLASS_INS, ins_code, out_code)
    out = _code_to_ascii(out_code)
    return torch.where(gm_valid, out, 0).to(torch.uint8)
