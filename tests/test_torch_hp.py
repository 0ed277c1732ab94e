"""Homopolymer mode (`-hp -k`) of the port against the JAX package, exactly.

Each ported function of the unfused read path gets the same inputs (made
from a seed with numpy) as its JAX counterpart and must give the same bytes
and integers (tolerance 0): the hp breakpoint tables, run detection, event
suppression, the gather map (all five fields), run resizing, the read
assembly, and whole read-emitting `genome_batch(kmer_bias=6)` programs,
linear and circular, with and without FASTQ.  The plain versions of the
element gather and the read assembly are held against the JAX package's
Pallas kernels in interpret mode.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.ops import apply_errors as japply
from nanosim_tpu.ops import error_walk as jwalk
from nanosim_tpu.ops import homopolymer as jhp
from nanosim_tpu.ops import pallas_assemble, pallas_gather
from nanosim_tpu.ops import window_gather
from nanosim_tpu.ops import rng as jrng
from nanosim_tpu.ops import tables as jtables
from nanosim_tpu.profiles import fixtures as jfixtures
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import apply_errors as tapply
from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda
from nanosim_tpu_torch.ops import homopolymer as thp
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.ops import tables as ttables
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import genome_mode as tgm

from test_torch_assemble import as_tensors, assemble_inputs, assemble_numpy
from test_torch_common import load_both, make_model

SEED = 3
BATCH = 64
K = 6
BASES = np.frombuffer(b"ACGT", np.uint8)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a).astype(np.int64), _np(b).astype(np.int64),
                                  err_msg=msg)


def _runny(rs, shape, stay=0.6):
    """ASCII bases in which each base repeats its predecessor with
    probability `stay`: homopolymer runs of length >= K are common."""
    B, L = shape
    out = BASES[rs.integers(0, 4, shape)]
    keep = rs.random(shape) < stay
    for j in range(1, L):
        out[:, j] = np.where(keep[:, j], out[:, j - 1], out[:, j])
    return out


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hp"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    refs = {"linear": os.path.join(d, "lin.fa"), "circular": os.path.join(d, "circ.fa")}
    # hp_bias raises run density so suppression + resizing fire often
    jfixtures.make_reference_fasta(refs["linear"], [20000, 15000], seed=17, hp_bias=0.6)
    jfixtures.make_reference_fasta(refs["circular"], [20000], seed=18, hp_bias=0.6)
    return d, prefix, refs


@pytest.fixture(scope="module")
def tables(model):
    return load_both(model[1], fastq=True, homopolymer=True)


def _walk(tables, B, E, m_hi, seed):
    """A JAX aligned walk's events as numpy arrays (the same inputs for both
    implementations) and the slot keys' uint32 words."""
    _, jt, _ = tables
    sk = jrng.slot_keys(jrng.base_key(seed), jnp.arange(B, dtype=jnp.int64))
    m = jnp.asarray(np.random.default_rng(seed).integers(100, m_hi, B).astype(np.int32))
    w = jwalk.error_walk(sk, m, jt.first_match, jt.match_markov, jt.mixtures, jt.trans, E)
    ev = [np.array(x) for x in (w.events_pos2x, w.events_type, w.events_len,
                                w.events_valid, w.middle_ref)]
    return ev, np.array(sk)


def test_hp_breakpoints_match_jax(tables):
    """build_hp_breakpoints_from_vecs on explicit regression vectors (a small run
    cap keeps it quick), the numpy lookup, and the tables the two loaders
    build from the fixture's model files."""
    vecs = ([0.4, 0.93, -0.25, 9.0], [0.2, 0.88, -0.2, 7.0], [0.35, 0.06], [0.5, 0.04])
    jb, jv = jtables.build_hp_breakpoints_from_vecs(*vecs, m_tab=48)
    tb, tv = ttables.build_hp_breakpoints_from_vecs(*vecs, m_tab=48)
    assert jb.tobytes() == tb.tobytes() and jv.tobytes() == tv.tobytes()
    assert tb.shape[0] == 2 * 49 and tb.shape[1] > 4
    rs = np.random.default_rng(21)
    for is_at, m, u in zip(rs.random(200) < 0.5, rs.integers(0, 80, 200),
                           rs.random(200, dtype=np.float32)):
        assert (ttables.hp_resize_lookup(tb, tv, is_at, m, u)
                == jtables.hp_resize_lookup(jb, jv, is_at, m, u))
    assert ttables.HP_M_TAB == jtables.HP_M_TAB
    _, jt, tt = tables
    _eq(jt.hp_breaks, tt.hp_breaks)
    _eq(jt.hp_vals, tt.hp_vals)
    assert np.asarray(jt.hp_breaks).tobytes() == tt.hp_breaks.numpy().tobytes()
    assert jt.hp_mis_rate == tt.hp_mis_rate > 0


def test_build_tables_carries_the_hp_tables(model, tables):
    """The port's own load_profile and build_tables give the JAX package's hp
    tables (and none without homopolymer=True)."""
    from nanosim_tpu_torch.sim.bundles import build_tables

    _, jt, _ = tables
    tp = tprofile.load_profile(model[1], mode="genome", homopolymer=True)
    own = build_tables(tp, "cpu")
    assert np.asarray(jt.hp_breaks).tobytes() == own.hp_breaks.numpy().tobytes()
    _eq(jt.hp_vals, own.hp_vals)
    assert own.hp_mis_rate == jt.hp_mis_rate
    plain = build_tables(tprofile.load_profile(model[1], mode="genome"), "cpu")
    assert plain.hp_breaks is None and plain.hp_vals is None


def test_run_info_matches_jax():
    rs = np.random.default_rng(22)
    seq = _runny(rs, (9, 333))
    lengths = np.array([333, 0, 1, 7, 200, 332, 150, 64, 333], np.int32)
    jo = jhp.run_info(jnp.asarray(seq), jnp.asarray(lengths))
    to = thp.run_info(torch.from_numpy(seq), torch.from_numpy(lengths))
    for name, a, b in zip(("run_start", "run_len", "is_start"), jo, to):
        _eq(a, b, name)
    assert to[0].dtype == torch.int32 and to[1].dtype == torch.int32
    assert (_np(to[1]) >= K).any()


def test_suppress_and_gather_map_match_jax(tables):
    """suppress_hp_errors on a runny reference, then build_gather_map (all
    five fields) on the walk's events with the suppressed ones zeroed, and
    materialize_read through the plain byte gather."""
    B, E, l_cap = 32, 256, 2048
    ev, _ = _walk(tables, B, E, 1600, seed=5)
    rs = np.random.default_rng(23)
    ref_seg = _runny(rs, (B, l_cap))
    jkeep = jhp.suppress_hp_errors(jnp.asarray(ref_seg), jnp.asarray(ev[4]),
                                   *(jnp.asarray(x) for x in ev[:4]), K)
    tkeep = thp.suppress_hp_errors(torch.from_numpy(ref_seg), torch.from_numpy(ev[4]),
                                   *(torch.from_numpy(x) for x in ev[:4]), K)
    _eq(jkeep, tkeep, "keep")
    keep = _np(tkeep)
    assert (ev[3] & ~keep).any() and (ev[3] & keep).any()

    ev_len = np.where(keep, ev[2], 0).astype(np.int32)
    for dedup in (True, False):
        jg = japply.build_gather_map(jnp.asarray(ev[0]), jnp.asarray(ev[1]), jnp.asarray(ev_len),
                                     jnp.asarray(ev[3]), jnp.asarray(ev[4]), l_cap,
                                     dedup_ins=dedup)
        tg = tapply.build_gather_map(torch.from_numpy(ev[0]), torch.from_numpy(ev[1]),
                                     torch.from_numpy(ev_len), torch.from_numpy(ev[3]),
                                     torch.from_numpy(ev[4]), l_cap, dedup_ins=dedup)
        for f in ("src", "src_left", "qclass", "valid", "read_len"):
            _eq(getattr(jg, f), getattr(tg, f), f"{f} dedup={dedup}")
        assert tg.src.dtype == tg.src_left.dtype == tg.qclass.dtype == torch.int32
    assert (_np(tg.qclass) == tapply.CLASS_INS).any() and (_np(tg.qclass) == tapply.CLASS_MIS).any()

    u_mis = rs.random((B, l_cap), dtype=np.float32)
    u_ins = rs.random((B, l_cap), dtype=np.float32)
    before = gather_cuda.gather_u8.launches
    jr = japply.materialize_read(jg.src, jg.qclass, jg.valid, jnp.asarray(ref_seg),
                                 jnp.asarray(u_mis), jnp.asarray(u_ins))
    tr = tapply.materialize_read(tg.src, tg.qclass, tg.valid, torch.from_numpy(ref_seg),
                                 torch.from_numpy(u_mis), torch.from_numpy(u_ins))
    _eq(jr, tr, "materialized read")
    assert gather_cuda.gather_u8.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("r_max", [64, 3])
def test_resize_homopolymers_matches_jax(tables, r_max):
    """resize_homopolymers on runny pass-1 reads; r_max=3 overflows the run
    table on most lanes (ok False), and the outputs still agree."""
    _, jt, tt = tables
    B, L = 24, 700
    rs = np.random.default_rng(24)
    read_mid = _runny(rs, (B, L), stay=0.5)
    qclass = rs.integers(0, 3, (B, L)).astype(np.int32)
    l_new = rs.integers(50, L + 1, B).astype(np.int32)
    l_new[:2] = [L, 0]
    sk = np.array(jrng.slot_keys(jrng.base_key(SEED), jnp.arange(B, dtype=jnp.int64)))
    jo = jhp.resize_homopolymers(jnp.asarray(sk), jnp.asarray(read_mid), jnp.asarray(qclass),
                                 jnp.asarray(l_new), jt.hp_breaks, jt.hp_vals, jt.hp_mis_rate,
                                 K, r_max, L)
    to = thp.resize_homopolymers(torch.from_numpy(sk.astype(np.int64)),
                                 torch.from_numpy(read_mid), torch.from_numpy(qclass),
                                 torch.from_numpy(l_new), tt.hp_breaks, tt.hp_vals,
                                 tt.hp_mis_rate, K, r_max, L)
    for name, a, b in zip(("read", "qclass", "new_len", "ok"), jo, to):
        _eq(a, b, name)
    ok = _np(to[3])
    assert (~ok).any() if r_max == 3 else ok.all()
    if r_max == 64:
        new_len = _np(to[2])
        assert (new_len > l_new).any() and (new_len < l_new).any()
        assert (_np(to[1]) == tapply.CLASS_MIS).any()


@pytest.mark.parametrize("fastq", [False, True])
def test_assemble_read_matches_jax(tables, fastq):
    _, jt, tt = tables
    B, l_cap, ht_cap, l_out = 21, 512, 256, 1024
    rs = np.random.default_rng(25)
    read_mid = BASES[rs.integers(0, 4, (B, l_cap))]
    qclass = rs.integers(0, 3, (B, l_cap)).astype(np.int32)
    l_new = rs.integers(0, l_cap + 1, B).astype(np.int32)
    head = rs.integers(0, 200, B).astype(np.int32)
    tail = rs.integers(0, 200, B).astype(np.int32)
    head[:3] = 0
    tail[1:4] = 0
    l_new[4] = l_cap + 40  # beyond the buffer: a lane the program later discards
    sk = np.array(jrng.slot_keys(jrng.base_key(SEED), jnp.arange(B, dtype=jnp.int64)))
    jo = jgm.assemble_read(jnp.asarray(read_mid), jnp.asarray(qclass), jnp.asarray(l_new),
                           jnp.asarray(head), jnp.asarray(tail), jnp.asarray(sk), jt, l_out,
                           ht_cap, fastq)
    before = assemble_cuda.assemble_rolls.launches
    to = tgm.assemble_read(torch.from_numpy(read_mid), torch.from_numpy(qclass),
                           torch.from_numpy(l_new), torch.from_numpy(head),
                           torch.from_numpy(tail), torch.from_numpy(sk.astype(np.int64)), tt,
                           l_out, ht_cap, fastq)
    for name, a, b in zip(("read", "quals", "total", "is_rev"), jo, to):
        _eq(a, b, name)
    assert assemble_cuda.assemble_rolls.launches == before
    assert _np(to[3]).any() and (~_np(to[3])).any()
    assert bool(_np(to[1]).any()) == fastq


HP_FIELDS = ("valid", "total_len", "head", "tail", "middle_ref", "l_new", "chrom", "local_pos",
             "is_reversed", "n_events", "capacity_overflow", "m_ref_init", "read", "quals",
             "read_prehp")


@pytest.mark.parametrize("fastq", [False, True])
@pytest.mark.parametrize("dna", ["linear", "circular"])
def test_hp_read_emitting_batch_matches_jax(model, dna, fastq):
    """The unfused genome_batch(kmer_bias=6, emit_reads=True) against the JAX
    program on every BatchOut field, the suppression-zeroed event lengths
    included."""
    _, prefix, refs = model
    circ = dna == "circular"
    jg = JGenome.from_fasta(refs[dna], dna_type=dna)
    tg = TGenome.from_fasta(refs[dna], dna_type=dna)
    jp = jprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=True)
    tp = tprofile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=True)
    slots = np.arange(2 * BATCH, dtype=np.int64)
    js = jgm.GenomeSimulator(jg, jp, fastq=fastq, circular_dna=circ, batch=BATCH, kmer_bias=K)
    ts = tgm.GenomeSimulator(tg, tp, fastq=fastq, circular_dna=circ, batch=BATCH, kmer_bias=K,
                             device="cpu")
    jo = js.batch_fn(emit_reads=True)(jrng.base_key(SEED), jnp.asarray(slots))
    to = ts.batch_fn(emit_reads=True)(trng.base_key(SEED, device="cpu"), torch.from_numpy(slots))
    for f in HP_FIELDS:
        _eq(getattr(jo, f), getattr(to, f), f)
    live = np.arange(_np(to.ev_type).shape[1])[None, :] < _np(to.n_events)[:, None]
    for f in ("ev_pos2x", "ev_type", "ev_len"):
        _eq(np.where(live, _np(getattr(jo, f)), 0), np.where(live, _np(getattr(to, f)), 0), f)
    v = _np(to.valid)
    assert v.any()
    # not vacuous: runs of length >= K occur in accepted pass-1 middles, and
    # the suppression zeroed some live event of an accepted lane
    pre = _np(to.read_prehp)
    assert sum(any(c * K in pre[b].tobytes() for c in (b"A", b"C", b"G", b"T"))
               for b in np.nonzero(v)[0]) >= 10
    assert (live & (_np(to.ev_len) == 0))[v].any()


def test_hp_meta_only_batch_matches_jax(model):
    """The meta-only program with kmer_bias (no final length filter)."""
    _, prefix, refs = model
    jg, tg = JGenome.from_fasta(refs["linear"]), TGenome.from_fasta(refs["linear"])
    jp = jprofile.load_profile(prefix, mode="genome", homopolymer=True)
    tp = tprofile.load_profile(prefix, mode="genome", homopolymer=True)
    slots = np.arange(2 * BATCH, dtype=np.int64)
    js = jgm.GenomeSimulator(jg, jp, batch=BATCH, kmer_bias=K)
    ts = tgm.GenomeSimulator(tg, tp, batch=BATCH, kmer_bias=K, device="cpu")
    jo = js.batch_fn(emit_reads=False)(jrng.base_key(SEED), jnp.asarray(slots))
    to = ts.batch_fn(emit_reads=False)(trng.base_key(SEED, device="cpu"),
                                       torch.from_numpy(slots))
    for f in HP_FIELDS[:12]:
        _eq(getattr(jo, f), getattr(to, f), f)
    assert to.read is None and to.read_prehp is None and _np(to.valid).any()


def test_kmer_bias_needs_the_hp_profile(model):
    _, prefix, refs = model
    tp = tprofile.load_profile(prefix, mode="genome")
    with pytest.raises(ValueError, match="homopolymer=True"):
        tgm.GenomeSimulator(TGenome.from_fasta(refs["linear"]), tp, kmer_bias=K, device="cpu")


# --- the kernels' plain versions against the Pallas kernels ------------------


@pytest.mark.parametrize("shape", [(8, 1000, 1024), (5, 300, 77)])
def test_gather_u8_plain_matches_pallas_interpret(shape):
    """gather_u8 on CPU tensors (its plain version) against
    pallas_gather.gather_u8 in interpret mode and numpy, for 1-byte and
    2-byte elements."""
    B, W, L = shape
    rs = np.random.default_rng(7)
    parts = rs.integers(0, 256, (B, W), dtype=np.uint8)
    idx = rs.integers(0, W, (B, L), dtype=np.int32)
    want = np.asarray(pallas_gather.gather_u8(jnp.asarray(parts), jnp.asarray(idx),
                                              interpret=True))
    got = gather_cuda.gather_u8(torch.from_numpy(parts), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(parts, idx, axis=1))
    wide = rs.integers(0, 1 << 15, (B, W)).astype(np.int16)
    got16 = gather_cuda.gather_u8(torch.from_numpy(wide), torch.from_numpy(idx))
    assert got16.dtype == torch.int16
    np.testing.assert_array_equal(got16.numpy(), np.take_along_axis(wide, idx, axis=1))


@pytest.mark.parametrize("shape", [(8, 1000, 1024), (5, 301, 77)])
def test_gather_codes_unpacked_matches_pallas_interpret(shape):
    B, W, L = shape
    rs = np.random.default_rng(10)
    codes = rs.integers(0, 4, (B, W), dtype=np.int32)
    idx = rs.integers(0, W, (B, L), dtype=np.int32)
    _eq(pallas_gather.pack_codes(jnp.asarray(codes)),
        gather_cuda.pack_codes(torch.from_numpy(codes)), "pack_codes")
    want = np.asarray(pallas_gather.gather_codes(jnp.asarray(codes), jnp.asarray(idx),
                                                 interpret=True))
    got = gather_cuda.gather_codes_unpacked(torch.from_numpy(codes), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(codes, idx, axis=1))


def test_assemble_rolls_plain_matches_pallas_interpret():
    """assemble_rolls on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode (batch a multiple of 8, as it demands) and the
    numpy reference of the JAX package's own kernel test."""
    B, l_cap, ht_cap, l_out = 16, 256, 128, 384
    mid, ht, head, l_new, total, is_rev = assemble_inputs(B, l_cap, ht_cap, l_out, seed=0)
    got = assemble_cuda.assemble_rolls(
        *as_tensors(mid, ht, head, l_new, total, is_rev), l_out).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        got, assemble_numpy(mid, ht, head, l_new, total, is_rev, l_out))
    pal = np.asarray(pallas_assemble.assemble_rolls(
        jnp.asarray(mid), jnp.asarray(ht), jnp.asarray(head), jnp.asarray(l_new),
        jnp.asarray(total), jnp.asarray(is_rev), l_out, interpret=True))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("B, PB, L, seed", [(8, 700, 2048, 21), (16, 330, 1024, 22)])
def test_gather_codes_plain_matches_windowed_pallas_interpret(B, PB, L, seed):
    """gather_codes on CPU tensors (its plain version) against the JAX
    package's windowed TPU gather in interpret mode followed by the code's
    bit extraction, as fused_read_v2 runs them: indices clipped to the row's
    codes (lane 0 clamped at the row's start, lane 1 at its end), window
    starts from window_starts, compared on the lanes it does not flag."""
    rs = np.random.default_rng(seed)
    packed = rs.integers(0, 256, (B, PB), dtype=np.uint8)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    src = rs.integers(-40, 4 * PB - L, (B, 1)) + np.arange(L)[None, :] + drift
    src[0] -= 600
    src[1] += 4 * PB - int(src[1].min()) - L // 2
    src = np.clip(src, 0, 4 * PB - 1).astype(np.int32)
    assert (src[0] == 0).sum() > 100 and (src[1] == 4 * PB - 1).sum() > 100
    ws, overflow = window_gather.window_starts(jnp.asarray(src), jnp.ones(src.shape, bool),
                                               L // window_gather.TILE)
    byte = np.asarray(window_gather.gather_bytes_windowed(
        jnp.asarray(packed), jnp.asarray(src), ws, interpret=True))
    want = ((byte >> ((src & 3) * 2)) & 3).astype(np.uint8)
    kept = ~np.asarray(overflow)
    assert kept[:2].all() and kept.sum() >= B - 2
    got = gather_cuda.gather_codes(torch.from_numpy(packed), torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(got[kept], want[kept])


@pytest.mark.parametrize("strands", ["forward", "reverse", "mixed"])
def test_assemble_rolls_plain_matches_pallas_interpret_by_strand(strands):
    """assemble_rolls on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode for all-forward, all-reversed and mixed
    batches, with lanes whose head is 0, whose tail is 0, with neither, and
    one whose total is l_out."""
    B, l_cap, ht_cap, l_out = 24, 200, 128, 320  # head + tail stay within the pool
    mid, ht, head, l_new, total, is_rev = assemble_inputs(B, l_cap, ht_cap, l_out, seed=5)
    assert head[0] == total[0] - l_new[0] == 0 and total[4] == l_out
    is_rev = {"forward": np.zeros(B, bool), "reverse": np.ones(B, bool), "mixed": is_rev}[strands]
    got = assemble_cuda.assemble_rolls(
        *as_tensors(mid, ht, head, l_new, total, is_rev), l_out).numpy().view(np.uint16)
    pal = np.asarray(pallas_assemble.assemble_rolls(
        jnp.asarray(mid), jnp.asarray(ht), jnp.asarray(head), jnp.asarray(l_new),
        jnp.asarray(total), jnp.asarray(is_rev), l_out, interpret=True))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, assemble_numpy(mid, ht, head, l_new, total, is_rev, l_out))
