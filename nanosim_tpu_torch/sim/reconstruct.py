"""Host-side read reconstruction: final read bytes from (genome, events, RNG).

Under the counter-based RNG contract every byte of an accepted read is a
deterministic function of host-resident state: the genome (host copy), the
walk event list (replayed bit-exactly by the C++ WalkReplayer), and
counter-addressed threefry draws (IUPAC resolution, substituted / inserted /
head-tail bases).  The reads therefore never need to cross the device->host
link at all: the device batch program runs draws + walk + position sampling +
acceptance (`emit_reads=False`), transfers ~100 bytes of metadata per lane,
and the host regenerates the exact bytes the device's fused_read_v2 kernel
would have produced (byte-equality is enforced by tests/test_reconstruct.py
against the device path).

This module is the NUMPY REFERENCE implementation — the spec that
native/fastwriter.cpp's reconstruction mirrors — and the fallback when the
native library is unavailable.

Scope: the aligned-genome path on linear DNA (not perfect), with and without
-hp (reconstruct_hp_lane), FASTA and FASTQ (base qualities are
counter-addressed draws through the exact QualDevice breakpoint table, so
they reconstruct exactly like bases), and the unaligned pass; other paths
keep the device read materialization.
"""

from __future__ import annotations

import numpy as np

# IUPAC candidate sets (ops/seqops.py; case_convert, simulator.py:743-755)
_IUPAC = {
    "Y": "CT", "R": "AG", "W": "AT", "S": "GC", "K": "TG", "M": "CA",
    "D": "AGT", "V": "ACG", "H": "ACT", "B": "CGT",
    "N": "ATCG", "X": "ATCG",
}
_CODE = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T
_BASES = np.frombuffer(b"ACGT", np.uint8)
# random-base choice order (A, T, C, G) -> 2-bit code
_CHOICE_CODE = np.array([0, 3, 1, 2], np.uint8)


def _threefry2x32(k0, k1, x0, x1):
    """uint32 numpy threefry-2x32, bit-identical to jax (ops/rng.py)."""
    rot0 = (13, 15, 26, 6)
    rot1 = (17, 29, 16, 24)
    k0 = np.uint32(k0)
    k1 = np.uint32(k1)
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    x0 = (np.asarray(x0, np.uint32) + k0).astype(np.uint32)
    x1 = (np.asarray(x1, np.uint32) + k1).astype(np.uint32)
    ks = (k0, k1, k2)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rot0 if i % 2 == 0 else rot1:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))).astype(np.uint32)
                x1 = x0 ^ x1
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def fold_in(k, data):
    y0, y1 = _threefry2x32(k[0], k[1], np.uint32(0), np.uint32(data))
    return (y0, y1)


def key_root(seed: int, stream: int, slot: int, site: int):
    k = (np.uint32(np.uint64(seed) >> np.uint64(32)),
         np.uint32(np.uint64(seed) & np.uint64(0xFFFFFFFF)))
    k = fold_in(k, stream)
    k = fold_in(k, slot)
    return fold_in(k, site)


def bits_at(key, pos):
    """jax.random.bits(key, (n,))[pos] for array pos (counter (0, p))."""
    y0, y1 = _threefry2x32(key[0], key[1], np.zeros_like(pos, np.uint32),
                           np.asarray(pos, np.uint32))
    return y0 ^ y1


def uniform_at(key, pos):
    """jax.random.uniform(key, (n,))[pos] (f32 in [0,1))."""
    b = bits_at(key, pos)
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniform2_at(key, pos):
    """ops/rng.uniform2_per_slot at positions pos -> (lo, hi) f32."""
    b = bits_at(key, pos)
    scale = np.float32(1.0 / 65536.0)
    lo = (b & np.uint32(0xFFFF)).astype(np.float32) * scale
    hi = (b >> np.uint32(16)).astype(np.float32) * scale
    return lo, hi


def resolve_codes(raw: np.ndarray, iupac_key, buf_idx: np.ndarray) -> np.ndarray:
    """Uppercase-ASCII ref bytes -> 2-bit codes with IUPAC resolution.

    buf_idx: per-byte index into the SITE_IUPAC uniform pool (the chunked
    extraction buffer coordinate: (chrom_offset + local_pos) % CHUNK + i).
    """
    codes = np.zeros(len(raw), np.uint8)
    plain = np.isin(raw, (65, 67, 71, 84))
    codes[plain] = np.select(
        [raw[plain] == 67, raw[plain] == 71, raw[plain] == 84],
        [1, 2, 3], 0,
    )
    odd = np.nonzero(~plain)[0]
    if len(odd):
        u, _ = uniform2_at(iupac_key, buf_idx[odd])
        for j, i in enumerate(odd):
            ch = chr(raw[i])
            opts = _IUPAC.get(ch)
            if opts is None:
                codes[i] = 0  # non-IUPAC byte -> 'A' (ops/apply_errors._ascii_to_code)
                continue
            cnt = len(opts)
            idx = min(int(np.float32(u[j]) * np.float32(cnt)), cnt - 1)
            codes[i] = _CODE[ord(opts[idx])]
    return codes


def reconstruct_lane(
    genome_flat: np.ndarray,  # uint8 uppercase ASCII
    g_off: int,  # chromosome byte offset in genome_flat
    spos: int,  # local start position
    events,  # (pos2x, type, len) int arrays, ascending, RAW lengths
    head: int,
    tail: int,
    l_new: int,  # final (dedup-aware) mutated middle length
    total: int,
    rev: bool,
    keys,  # dict with 'iupac', 'mis', 'ht' site keys (key_root outputs)
    ht_cap: int,
    chunk: int = 256,
    qual_table=None,  # (breaks [5, K] f32, vals [5, K] i32) -> also return quals
) -> np.ndarray:
    """Final-orientation ASCII read bytes, byte-identical to fused_read_v2.

    With qual_table set (FASTQ), returns (read, quals): quals[j] =
    vals[class(j)][count(breaks[class(j)] <= u(j)) - 1] + 33 with u(j) the
    SITE_QUAL draw at OUTPUT position j and class(j) the fused_read_v2
    qclass (0 match / 1 mis / 2 ins / 3 head-tail) at that position (keys
    must then also hold 'qual')."""
    ev_pos2x, ev_type, ev_len = events
    ne = len(ev_pos2x)

    # effective lengths: consecutive same-key insertions keep only the last
    eff = np.asarray(ev_len, np.int64).copy()
    for e in range(ne - 1):
        if (ev_type[e] == 1 and ev_type[e + 1] == 1
                and ev_pos2x[e + 1] == ev_pos2x[e]):
            eff[e] = 0

    # --- middle (pre-reverse): class + ref index per position ---
    cls = np.zeros(l_new, np.uint8)  # 0 match, 1 mis, 2 ins
    src = np.zeros(l_new, np.int64)
    i = 0  # ref cursor
    m = 0  # mid cursor
    for e in range(ne):
        t = int(ev_type[e])
        ln = int(eff[e])
        key = (int(ev_pos2x[e]) + 1) // 2
        ref_start = key if t == 1 else int(ev_pos2x[e]) // 2
        span = ref_start - i
        if span > 0:
            src[m : m + span] = np.arange(i, ref_start)
            m += span
            i = ref_start
        if ln == 0:
            continue
        if t == 0:  # mis
            cls[m : m + ln] = 1
            src[m : m + ln] = np.arange(i, i + ln)
            m += ln
            i += ln
        elif t == 1:  # ins
            cls[m : m + ln] = 2
            m += ln
        else:  # del
            i += ln
    if m < l_new:
        src[m:] = np.arange(i, i + (l_new - m))

    buf_off = (g_off + spos) % chunk
    raw = genome_flat[g_off + spos + src]
    code = resolve_codes(raw, keys["iupac"], buf_off + src)

    # --- pre-reverse full read with output-indexed mutation draws ---
    jj = np.arange(total, dtype=np.int64)
    j_out = (total - 1 - jj) if rev else jj
    u_mis, u_ins = uniform2_at(keys["mis"], j_out)

    pre = np.zeros(total, np.uint8)
    # middle
    mid_jj = np.arange(head, head + l_new)
    c = code.copy()
    is_mis = cls == 1
    if is_mis.any():
        off = 1 + np.floor(u_mis[mid_jj[is_mis]] * np.float32(3.0)).astype(np.uint8)
        c[is_mis] = (c[is_mis] + np.minimum(off, 3)) % 4
    is_ins = cls == 2
    if is_ins.any():
        c[is_ins] = np.minimum(
            np.floor(u_ins[mid_jj[is_ins]] * np.float32(4.0)).astype(np.int32), 3
        ).astype(np.uint8)
    pre[head : head + l_new] = c

    # head/tail random bases: pool index = jj (head) / jj - l_new (tail)
    if head or tail:
        ht_jj = np.concatenate([np.arange(head), np.arange(head + l_new, total)])
        pool = np.where(ht_jj < head, ht_jj, ht_jj - l_new)
        u = uniform_at(keys["ht"], np.clip(pool, 0, ht_cap - 1))
        choice = np.minimum(np.floor(u * np.float32(4.0)).astype(np.int32), 3)
        pre[ht_jj] = _CHOICE_CODE[choice]

    if rev:
        out_codes = (3 - pre[::-1]).astype(np.uint8)
    else:
        out_codes = pre
    read = _BASES[out_codes]
    if qual_table is None:
        return read

    breaks, vals = qual_table
    cls_pre = np.full(total, 3, np.uint8)  # QCLASS_HT
    cls_pre[head : head + l_new] = cls  # 0 match / 1 mis / 2 ins
    cls_out = cls_pre[::-1] if rev else cls_pre
    u = uniform_at(keys["qual"], np.arange(total, dtype=np.int64))
    q = np.empty(total, np.uint8)
    for c in range(4):
        msk = cls_out == c
        if msk.any():
            cnt = np.searchsorted(breaks[c], u[msk], side="right")
            q[msk] = vals[c, cnt - 1].astype(np.uint8)
    return read, q + np.uint8(33)


def reconstruct_unaligned_lane(
    genome_flat: np.ndarray,
    g_off: int,
    spos: int,
    steps,  # (pos2x, type, len) per-STEP arrays (matches carry len 0)
    middle_ref: int,
    l_new: int,
    rev: bool,
    keys,  # dict with 'iupac', 'ins' (+ 'qual' for FASTQ) key_root outputs
    qual_table=None,
):
    """Unaligned-read bytes from the step stream, byte-identical to
    unaligned_batch's device path (build_unaligned_map + materialize_read).

    The reference keys unaligned insertions at pos + 0.1, so a same-pos
    mis/del acts on contiguous POST-insertion presentation positions; this
    builds the presentation flags exactly like build_unaligned_map and
    compresses deletions out.  With qual_table, returns (read, quals) —
    every position unmapped-class, NOT strand-flipped (matching the device).
    """
    st_pos2x, st_type, st_len = steps
    ns = len(st_pos2x)
    tot_ins = int(sum(l for t, l in zip(st_type, st_len) if t == 1 and l))
    P = middle_ref + tot_ins
    F_DEAD, F_INS, F_MIS = 1, 2, 4
    flags = np.zeros(P, np.uint8)
    prior_ins = k_same = 0
    for e in range(ns):
        t, ln = int(st_type[e]), int(st_len[e])
        pos = int(st_pos2x[e]) >> 1
        if ln == 0:
            k_same = 0
            continue
        if t == 1:
            ps = pos + prior_ins + 1
            flags[ps : min(ps + ln, P)] |= F_INS
            prior_ins += ln
            k_same += ln
        else:
            ps = pos + (prior_ins - k_same)
            flags[ps : min(ps + ln, P)] |= F_MIS if t == 0 else F_DEAD
            k_same = 0

    out = np.zeros(l_new, np.uint8)
    raw = genome_flat[g_off + spos : g_off + spos + middle_ref]
    j = ref_idx = 0
    for p in range(P):
        if j >= l_new:
            break
        f = flags[p]
        is_ins = bool(f & F_INS)
        if f & F_DEAD:
            if not is_ins:
                ref_idx += 1
            continue
        if is_ins:
            lo, _ = uniform2_at(keys["ins"], np.asarray([j]))
            code = min(int(np.float32(lo[0]) * np.float32(4.0)), 3)
        else:
            code = int(resolve_codes(raw[ref_idx : ref_idx + 1], keys["iupac"],
                                     np.asarray([ref_idx]))[0])
            ref_idx += 1
        if f & F_MIS:
            _, hi = uniform2_at(keys["iupac"], np.asarray([j]))
            off = min(1 + int(np.float32(hi[0]) * np.float32(3.0)), 3)
            code = (code + off) % 4
        out[j] = code
        j += 1

    read = _BASES[(3 - out[::-1]) if rev else out]
    if qual_table is None:
        return read
    breaks, vals = qual_table
    u = uniform_at(keys["qual"], np.arange(l_new, dtype=np.int64))
    cnt = np.searchsorted(breaks[4], u, side="right")
    return read, (vals[4, cnt - 1] + 33).astype(np.uint8)


def reconstruct_unaligned_batch(cb, lanes, genome, seed: int, stream: int,
                                qual_table=None):
    from ..ops import rng

    out = []
    for b in lanes:
        slot = int(cb.slots[b])
        keys = {
            "iupac": key_root(seed, stream, slot, rng.SITE_IUPAC),
            "ins": key_root(seed, stream, slot, rng.SITE_INS_BASE),
            "qual": key_root(seed, stream, slot, rng.SITE_QUAL),
        }
        ns = int(cb.n_events[b])
        o = int(cb.ev_off[b])
        w = cb.ev_flat[o : o + ns]
        steps = (
            (w & np.uint32(0x1FFFF)).astype(np.int64),
            (w >> np.uint32(30)).astype(np.int64),
            ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64),
        )
        chrom = int(cb.chrom[b])
        out.append(reconstruct_unaligned_lane(
            genome.flat, int(genome.offsets[chrom]), int(cb.pos[b]), steps,
            int(cb.middle_ref[b]), int(cb.l_new[b]), bool(cb.rev[b]), keys,
            qual_table=qual_table,
        ))
    return out


def reconstruct_batch(cb, lanes, genome, seed: int, stream: int, ht_cap: int,
                      qual_table=None):
    """Reconstruct selected lanes of a meta-only CompactBatch -> ASCII list
    (with qual_table: list of (read, quals) tuples)."""
    from ..ops import rng

    out = []
    for b in lanes:
        slot = int(cb.slots[b])
        keys = {
            "iupac": key_root(seed, stream, slot, rng.SITE_IUPAC),
            "mis": key_root(seed, stream, slot, rng.SITE_MIS_BASE),
            "ht": key_root(seed, stream, slot, rng.SITE_HEAD_TAIL),
            "qual": key_root(seed, stream, slot, rng.SITE_QUAL),
        }
        ne = int(cb.n_events[b])
        o = int(cb.ev_off[b])
        w = cb.ev_flat[o : o + ne]
        events = (
            (w & np.uint32(0x1FFFF)).astype(np.int64),
            (w >> np.uint32(30)).astype(np.int64),
            ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64),
        )
        chrom = int(cb.chrom[b])
        out.append(reconstruct_lane(
            genome.flat, int(genome.offsets[chrom]), int(cb.pos[b]), events,
            int(cb.head[b]), int(cb.tail[b]), int(cb.l_new[b]),
            int(cb.total[b]), bool(cb.rev[b]), keys, ht_cap,
            qual_table=qual_table,
        ))
    return out


def reconstruct_segment(genome_flat, g_off, spos, events, l_new, keys):
    """Pre-reverse middle bytes + classes of the unfused read path:
    aligned-event semantics with MIDDLE-indexed mutation draws (the path
    materializes via build_gather_map + materialize_read: iupac = SITE_IUPAC
    lo @ ref index, mis = SITE_IUPAC hi @ middle index, ins = SITE_INS_BASE
    lo @ middle index).  Returns (ascii bytes, classes)."""
    ev_pos2x, ev_type, ev_len = events
    ne = len(ev_pos2x)
    eff = np.asarray(ev_len, np.int64).copy()
    for e in range(ne - 1):
        if (ev_type[e] == 1 and ev_type[e + 1] == 1
                and ev_pos2x[e + 1] == ev_pos2x[e]):
            eff[e] = 0
    out = np.zeros(l_new, np.uint8)
    cls = np.zeros(l_new, np.uint8)
    raw = genome_flat[g_off + spos:]
    i = m = 0

    def matches(i0, i1, m0):
        n = i1 - i0
        if n <= 0:
            return
        codes = resolve_codes(raw[i0:i1], keys["iupac"], np.arange(i0, i1))
        out[m0 : m0 + n] = codes

    for e in range(ne):
        t = int(ev_type[e])
        ln = int(eff[e])
        key = (int(ev_pos2x[e]) + 1) // 2
        ref_start = key if t == 1 else int(ev_pos2x[e]) // 2
        matches(i, ref_start, m)
        m += max(ref_start - i, 0)
        i = max(i, ref_start)
        if ln == 0:
            continue
        if t == 0:  # mis
            for x in range(ln):
                _, hi = uniform2_at(keys["iupac"], np.asarray([m]))
                off = min(1 + int(np.float32(hi[0]) * np.float32(3.0)), 3)
                code = int(resolve_codes(raw[i : i + 1], keys["iupac"], np.asarray([i]))[0])
                out[m] = (code + off) % 4
                cls[m] = 1
                i += 1
                m += 1
        elif t == 1:  # ins
            for x in range(ln):
                lo, _ = uniform2_at(keys["ins"], np.asarray([m]))
                out[m] = min(int(np.float32(lo[0]) * np.float32(4.0)), 3)
                cls[m] = 2
                m += 1
        else:
            i += ln
    matches(i, i + (l_new - m), m)
    return _BASES[out], cls


def _hp_runs(arr: np.ndarray, k: int):
    """Homopolymer runs of length >= k: list of (start, end) over arr."""
    n = len(arr)
    if n == 0:
        return []
    change = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    return [(int(s), int(e)) for s, e in zip(starts, ends) if e - s >= k]


def hp_suppressed(ref_resolved: np.ndarray, events, k: int):
    """Events overlapping >= k homopolymer runs of the RESOLVED reference
    segment are dropped (numpy twin of ops/homopolymer.suppress_hp_errors;
    reference mutate_read, simulator.py:1920-1950).  Returns bool[ne]."""
    ev_pos2x, ev_type, ev_len = events
    ne = len(ev_pos2x)
    L = len(ref_resolved)
    in_hp = np.zeros(L, bool)
    for s, e in _hp_runs(ref_resolved, k):
        in_hp[s:e] = True
    cum = np.cumsum(in_hp.astype(np.int64))
    out = np.zeros(ne, bool)
    for e in range(ne):
        t = int(ev_type[e])
        ln = int(ev_len[e])
        p = (int(ev_pos2x[e]) + 1) // 2
        lo = p - 1 if t == 1 else int(ev_pos2x[e]) // 2
        hi = (p + ln - 1) if t == 1 else (int(ev_pos2x[e]) // 2 + ln - 1)
        lo_c = min(max(lo, 0), L - 1)
        hi_c = min(max(hi, 0), L - 1)
        covered = (cum[hi_c] - cum[lo_c]) > 0
        covered = covered or (in_hp[lo_c] and lo >= 0)
        out[e] = covered
    return out


def reconstruct_hp_lane(
    genome_flat: np.ndarray,
    g_off: int,
    spos: int,
    events_raw,  # (pos2x, type, len) RAW walk events, ascending
    middle_ref: int,
    head: int,
    tail: int,
    rev: bool,
    keys,  # 'iupac', 'ins', 'hp', 'hp_qual', 'hp_mis', 'ht' (+ 'qual')
    ht_cap: int,
    k: int,
    hp_tab,  # (breaks [2*(M+1), N] f32, vals i32) ops/tables.build_hp_breakpoints
    hp_mis_rate,  # np.float32
    l_cap: int,
    qual_table=None,
):
    """Genome `-hp -k` read from (genome, raw events, counter RNG) — the
    numpy spec native emit_batch_recon_hp mirrors, byte-identical to the
    device path (genome_batch with kmer_bias; reference semantics:
    mutate_read suppression simulator.py:1920-1950 + mutate_homo
    simulator.py:618-705).

    Pipeline: IUPAC-resolve the extracted segment -> drop events overlapping
    >= k runs -> pass-1 mutation with MIDDLE-indexed draws
    (reconstruct_segment) -> resize >= k runs of the mutated read via the
    exact u-space table (kept prefixes keep pass-1 bases+classes, extensions
    replicate the run base as ins-class, every position of a new run
    mismatches with prob hp_mis_rate) -> head/tail/strand/quals.

    Returns dict(read, quals, mid1, cls1, l_new2, total, log) where log is
    (keys, types, lens, rpos) of the surviving (suppressed-zeroed) events in
    ascending order with rpos in pass-1 coordinates.
    """
    ev_pos2x, ev_type, ev_len = (np.asarray(a, np.int64) for a in events_raw)
    ne = len(ev_pos2x)

    raw = genome_flat[g_off + spos : g_off + spos + middle_ref]
    resolved = raw.copy()
    odd = np.nonzero(~np.isin(raw, (65, 67, 71, 84)))[0]
    if len(odd):
        codes = resolve_codes(raw[odd], keys["iupac"], odd)
        resolved[odd] = _BASES[codes]

    supp = hp_suppressed(resolved, (ev_pos2x, ev_type, ev_len), k) if ne else np.zeros(0, bool)
    surv = np.where(supp, 0, ev_len)

    dels = int(surv[ev_type == 2].sum()) if ne else 0
    inss = int(surv[ev_type == 1].sum()) if ne else 0
    # reconstruct_segment dedups consecutive same-key insertions internally;
    # replicate for the length so the buffer is exact
    eff = surv.copy()
    for e in range(ne - 1):
        if (ev_type[e] == 1 and ev_type[e + 1] == 1
                and ev_pos2x[e + 1] == ev_pos2x[e]):
            if eff[e]:
                inss -= int(eff[e])
            eff[e] = 0
    l_new1 = middle_ref - dels + inss

    mid1, cls1 = reconstruct_segment(
        genome_flat, g_off, spos, (ev_pos2x, ev_type, surv), l_new1, keys
    )
    mid1_arr = np.frombuffer(mid1.tobytes(), np.uint8)

    # log events: surviving effective events with pass-1 read positions
    log_keys, log_rpos = [], []
    log_types, log_lens = [], []
    rc = 0  # running read-coordinate shift
    prior_del = prior_ins = 0
    for e in range(ne):
        t = int(ev_type[e])
        ln = int(eff[e])
        key = (int(ev_pos2x[e]) + 1) // 2
        ref_start = key if t == 1 else int(ev_pos2x[e]) // 2
        rpos = ref_start - prior_del + prior_ins
        if ln > 0:
            log_keys.append(key)
            log_types.append(t)
            log_lens.append(ln)
            log_rpos.append(rpos)
        if t == 1:
            prior_ins += ln
        elif t == 2:
            prior_del += ln
    del rc

    # --- resize runs of the pass-1 read (exact table) ----------------------
    breaks, vals = hp_tab
    runs = _hp_runs(mid1_arr[:l_new1], k)
    u_hp = uniform_at(keys["hp"], np.arange(max(len(runs), 1)))
    from ..ops.tables import hp_resize_lookup

    sizes = []
    for ridx, (s0, e0) in enumerate(runs):
        letter = int(mid1_arr[s0])
        is_at = letter in (65, 84)
        nsz = hp_resize_lookup(breaks, vals, is_at, e0 - s0, u_hp[ridx])
        sizes.append(min(nsz, l_cap // 2))

    l_new2 = l_new1 + sum(nsz - (e0 - s0) for (s0, e0), nsz in zip(runs, sizes))
    midf = np.zeros(l_new2, np.uint8)
    clsf = np.zeros(l_new2, np.uint8)
    run_ptr = 0
    p = q = 0
    out_runs = []  # (final start, size)
    while p < l_new1:
        if run_ptr < len(runs) and p == runs[run_ptr][0]:
            s0, e0 = runs[run_ptr]
            nsz = sizes[run_ptr]
            m_run = e0 - s0
            kept = min(nsz, m_run)
            midf[q : q + kept] = mid1_arr[s0 : s0 + kept]
            clsf[q : q + kept] = cls1[s0 : s0 + kept]
            if nsz > m_run:
                midf[q + m_run : q + nsz] = mid1_arr[s0]
                clsf[q + m_run : q + nsz] = 2
            out_runs.append((q, nsz))
            q += nsz
            p = e0
            run_ptr += 1
        else:
            midf[q] = mid1_arr[p]
            clsf[q] = cls1[p]
            q += 1
            p += 1

    rate32 = np.float32(hp_mis_rate)
    for sfin, nsz in out_runs:
        if nsz == 0:
            continue
        u_p = uniform_at(keys["hp_qual"], np.arange(sfin, sfin + nsz))
        for j in range(nsz):
            u_j = np.float32(u_p[j])
            if np.float32(0.0) < u_j <= rate32:
                u2 = np.float32(uniform_at(keys["hp_mis"], np.asarray([sfin + j]))[0])
                off = 1 + min(int(u2 * np.float32(3.0)), 2)
                midf[sfin + j] = _BASES[(_CODE.get(int(midf[sfin + j]), 0) + off) % 4]
                clsf[sfin + j] = 1

    # --- assembly: head | middle | tail, strand flip, qualities ------------
    total = head + l_new2 + tail
    pre = np.zeros(total, np.uint8)
    pre[head : head + l_new2] = midf
    if head or tail:
        ht_jj = np.concatenate([np.arange(head), np.arange(head + l_new2, total)])
        pool = np.where(ht_jj < head, ht_jj, ht_jj - l_new2)
        u = uniform_at(keys["ht"], np.clip(pool, 0, ht_cap - 1))
        choice = np.minimum(np.floor(u * np.float32(4.0)).astype(np.int32), 3)
        pre[ht_jj] = _BASES[_CHOICE_CODE[choice]]

    if rev:
        comp = np.arange(256, dtype=np.uint8)
        for a, b in ((65, 84), (67, 71)):
            comp[a], comp[b] = b, a
        read = comp[pre[::-1]]
    else:
        read = pre.copy()

    quals = None
    if qual_table is not None:
        breaks_q, vals_q = qual_table
        cls_pre = np.full(total, 3, np.uint8)
        cls_pre[head : head + l_new2] = clsf
        cls_out = cls_pre[::-1] if rev else cls_pre
        u = uniform_at(keys["qual"], np.arange(total, dtype=np.int64))
        quals = np.empty(total, np.uint8)
        for c in range(4):
            msk = cls_out == c
            if msk.any():
                cnt = np.searchsorted(breaks_q[c], u[msk], side="right")
                quals[msk] = vals_q[c, cnt - 1].astype(np.uint8)
        quals = quals + np.uint8(33)

    return dict(
        read=read, quals=quals, mid1=mid1_arr[:l_new1], cls1=cls1,
        l_new2=l_new2, total=total,
        log=(np.asarray(log_keys, np.int64), np.asarray(log_types, np.int64),
             np.asarray(log_lens, np.int64), np.asarray(log_rpos, np.int64)),
    )


def reconstruct_hp_batch(cb, lanes, genome, seed: int, stream: int,
                         ht_cap: int, k: int, hp_tab, hp_mis_rate,
                         l_cap: int, qual_table=None):
    """Reconstruct selected lanes of a meta-only -hp CompactBatch."""
    from ..ops import rng

    out = []
    for b in lanes:
        slot = int(cb.slots[b])
        keys = {
            "iupac": key_root(seed, stream, slot, rng.SITE_IUPAC),
            "ins": key_root(seed, stream, slot, rng.SITE_INS_BASE),
            "hp": key_root(seed, stream, slot, rng.SITE_HOMOPOLYMER),
            "hp_qual": key_root(seed, stream, slot, rng.SITE_HP_QUAL),
            "hp_mis": key_root(seed, stream, slot, rng.SITE_HP_MIS_BASE),
            "ht": key_root(seed, stream, slot, rng.SITE_HEAD_TAIL),
            "qual": key_root(seed, stream, slot, rng.SITE_QUAL),
        }
        ne = int(cb.n_events[b])
        o = int(cb.ev_off[b])
        w = cb.ev_flat[o : o + ne]
        events = (
            (w & np.uint32(0x1FFFF)).astype(np.int64),
            (w >> np.uint32(30)).astype(np.int64),
            ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64),
        )
        chrom = int(cb.chrom[b])
        out.append(reconstruct_hp_lane(
            genome.flat, int(genome.offsets[chrom]), int(cb.pos[b]), events,
            int(cb.middle_ref[b]), int(cb.head[b]), int(cb.tail[b]),
            bool(cb.rev[b]), keys, ht_cap, k, hp_tab, hp_mis_rate, l_cap,
            qual_table=qual_table,
        ))
    return out


def reconstruct_chimeric_lane(genome, seed, stream, slot, rec, ht_cap,
                              qual_table=None):
    """Full chimeric read (head | seg | gap | ... | tail) from replayed part
    event streams; numpy spec of native emit_chimeric_recon.

    rec: dict with head, tail, total, rev, n_seg and per-part lists:
    segs = [(part_off, l_new, mid, g_off, spos, events)], gaps likewise
    (events per-STEP).  Returns (read, quals_or_None, seg_mids list)."""
    from ..ops import rng

    total = rec["total"]
    head, tail = rec["head"], rec["tail"]
    pre = np.zeros(total, np.uint8)
    cls = np.full(total, 3, np.uint8)  # head/tail default
    ks_ht = key_root(seed, stream, slot, rng.SITE_HEAD_TAIL)

    for jj in range(head):
        u = uniform_at(ks_ht, np.asarray([min(jj, ht_cap - 1)]))[0]
        pre[jj] = _BASES[_CHOICE_CODE[min(int(np.float32(u) * np.float32(4.0)), 3)]]
    for x in range(tail):
        u = uniform_at(ks_ht, np.asarray([min(head + x, ht_cap - 1)]))[0]
        pre[total - tail + x] = _BASES[_CHOICE_CODE[min(int(np.float32(u) * np.float32(4.0)), 3)]]

    seg_mids = []
    for s, (poff, lnew, mid, goff, spos, events) in enumerate(rec["segs"]):
        # per-(slot, part) keys: the part id folds in between slot and site
        base_k = _part_key(seed, stream, slot, rng.PART_SEGMENT_BASE + s)
        keys = {
            "iupac": fold_in(base_k, rng.SITE_IUPAC),
            "ins": fold_in(base_k, rng.SITE_INS_BASE),
        }
        bytes_s, cls_s = reconstruct_segment(genome.flat, goff, spos, events, lnew, keys)
        pre[poff : poff + lnew] = np.frombuffer(bytes_s.tobytes(), np.uint8)
        cls[poff : poff + lnew] = cls_s
        seg_mids.append(bytes_s)
    for gi, (poff, lnew, mid, goff, spos, steps) in enumerate(rec["gaps"]):
        base_k = _part_key(seed, stream, slot, rng.PART_GAP_BASE + gi)
        keys = {
            "iupac": fold_in(base_k, rng.SITE_IUPAC),
            "ins": fold_in(base_k, rng.SITE_INS_BASE),
        }
        gr = reconstruct_unaligned_lane(genome.flat, goff, spos, steps, mid,
                                        lnew, False, keys)
        pre[poff : poff + lnew] = np.frombuffer(gr.tobytes(), np.uint8)
        cls[poff : poff + lnew] = 4  # gaps: unmapped qual class, never logged

    if rec["rev"]:
        comp = np.arange(256, dtype=np.uint8)
        for a, b in ((65, 84), (67, 71)):
            comp[a], comp[b] = b, a
        read = comp[pre[::-1]]
    else:
        read = pre
    quals = None
    if qual_table is not None:
        breaks, vals = qual_table
        kq = key_root(seed, stream, slot, rng.SITE_QUAL)
        quals = np.empty(total, np.uint8)
        for j in range(total):
            jj = total - 1 - j if rec["rev"] else j
            u = uniform_at(kq, np.asarray([jj]))[0]
            c = int(cls[jj])
            cnt = int(np.searchsorted(breaks[c], np.float32(u), side="right"))
            quals[j] = vals[c, cnt - 1] + 33
    return read, quals, seg_mids


def _part_key(seed, stream, slot, part):
    k = (np.uint32(np.uint64(seed) >> np.uint64(32)),
         np.uint32(np.uint64(seed) & np.uint64(0xFFFFFFFF)))
    k = fold_in(k, stream)
    k = fold_in(k, slot)
    return fold_in(k, part)
