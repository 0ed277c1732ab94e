"""The read-emitting programs of the port against the JAX package, exactly.

Each ported function of the read path gets the same inputs (made from a seed
with numpy) as its JAX counterpart and must give the same bytes and
integers (tolerance 0): IUPAC resolution, the reference gathers, the 2-bit
packing, the fused mutation/assembly (the JAX package's window-free
take_along_axis branch, which the port's gather reproduces), qualities, the
unaligned map and materialization, and the transfer buffer with reads.  Then
whole read-emitting batches, aligned and unaligned, linear and circular.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.ops import apply_errors as japply
from nanosim_tpu.ops import error_walk as jwalk
from nanosim_tpu.ops import rng as jrng
from nanosim_tpu.ops import seqops as jseq
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import compact as jcompact
from nanosim_tpu.sim import extract as jextract
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu.sim import unaligned_mode as jum
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import apply_errors as tapply
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.ops import seqops as tseq
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import compact as tcompact
from nanosim_tpu_torch.sim import extract as textract
from nanosim_tpu_torch.sim import genome_mode as tgm
from nanosim_tpu_torch.sim import unaligned_mode as tum

from test_torch_common import IUPAC_CODES, load_both, make_iupac_reference, make_model

SEED = 3
BATCH = 64


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a).astype(np.int64), _np(b).astype(np.int64),
                                  err_msg=msg)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("emit"))
    prefix = make_model(d, mean_read_len=500, sd_read_len=150)
    circ = os.path.join(d, "circ.fa")
    make_iupac_reference(circ, [20000], seed=5)
    lin = os.path.join(d, "lin.fa")
    make_iupac_reference(lin, [20000, 15000], seed=6)
    return d, prefix, {"circular": circ, "linear": lin}


def _ascii(rs, shape, extra=b""):
    alphabet = np.frombuffer(b"ACGT" * 3 + IUPAC_CODES + extra, np.uint8)
    return alphabet[rs.integers(0, len(alphabet), shape)]


def test_seqops_match_jax():
    rs = np.random.default_rng(11)
    seq = _ascii(rs, (4, 301), extra=b"-a")  # '-' and 'a' pass through
    u = rs.random((4, 301), dtype=np.float32)
    _eq(jseq.resolve_iupac(jnp.asarray(seq), jnp.asarray(u)),
        tseq.resolve_iupac(torch.from_numpy(seq), torch.from_numpy(u)), "resolve_iupac")
    lengths = np.array([301, 0, 150, 7], np.int32)
    _eq(jseq.reverse_complement(jnp.asarray(seq), jnp.asarray(lengths)),
        tseq.reverse_complement(torch.from_numpy(seq), torch.from_numpy(lengths)))
    _eq(jseq.complement(jnp.asarray(seq)), tseq.complement(torch.from_numpy(seq)))


def test_pack_codes4_matches_jax():
    seq = _ascii(np.random.default_rng(12), (3, 1001))
    _eq(japply._pack_codes4(jnp.asarray(seq)), tapply._pack_codes4(torch.from_numpy(seq)))


def test_gather_segments_match_jax(model):
    """Per-byte extraction with the circular wrap (reads crossing the
    origin, starts up to genome_len inclusive) and chunked linear
    extraction with its intra-chunk offset."""
    _, _, refs = model
    rs = np.random.default_rng(13)
    l_cap = 1024
    jg = JGenome.from_fasta(refs["circular"], dna_type="circular")
    jd = jextract.GenomeDevice.from_packed(jg)
    td = textract.GenomeDevice.from_packed(
        TGenome.from_fasta(refs["circular"], dna_type="circular"), "cpu")
    n = jg.total_len
    pos = np.concatenate([rs.integers(0, n + 1, 12), [n, n - 1, n - 500, 0]]).astype(np.int64)
    seg = rs.integers(0, l_cap + 1, len(pos)).astype(np.int32)
    chrom = np.zeros(len(pos), np.int32)
    _eq(jextract.gather_segments(jd, jnp.asarray(chrom), jnp.asarray(pos), jnp.asarray(seg),
                                 l_cap),
        textract.gather_segments(td, torch.from_numpy(chrom), torch.from_numpy(pos),
                                 torch.from_numpy(seg), l_cap), "circular gather")

    jg = JGenome.from_fasta(refs["linear"])
    jd = jextract.GenomeDevice.from_packed(jg)
    td = textract.GenomeDevice.from_packed(TGenome.from_fasta(refs["linear"]), "cpu")
    chrom = rs.integers(0, 2, 16).astype(np.int32)
    pos = (rs.random(16) * (jg.lengths[chrom] - 1)).astype(np.int64)
    jr, jo = jextract.gather_segments_padded(jd, jnp.asarray(chrom), jnp.asarray(pos), l_cap)
    tr, to = textract.gather_segments_padded(td, torch.from_numpy(chrom),
                                             torch.from_numpy(pos), l_cap)
    _eq(jr, tr, "padded rows")
    _eq(jo, to, "seg_off")
    assert _np(to).any()


def _walk(tables, B, E, m_hi, seed, unaligned=False):
    """A JAX walk's events as numpy arrays (the same inputs for both
    implementations)."""
    _, jt, _ = tables
    sk = jrng.slot_keys(jrng.base_key(seed), jnp.arange(B, dtype=jnp.int64))
    m = jnp.asarray(np.random.default_rng(seed).integers(100, m_hi, B).astype(np.int32))
    if unaligned:
        w = jwalk.unaligned_walk(sk, m, jt.mixtures, E)
    else:
        w = jwalk.error_walk(sk, m, jt.first_match, jt.match_markov, jt.mixtures, jt.trans, E)
    ev = [np.array(x) for x in (w.events_pos2x, w.events_type, w.events_len,
                                w.events_valid, w.middle_ref, w.l_new)]
    return ev, np.array(sk)  # uint32 key words


@pytest.fixture(scope="module")
def tables(model):
    return load_both(model[1], fastq=True)


@pytest.mark.parametrize("with_seg_off", [True, False])
def test_fused_read_v2_matches_jax(tables, with_seg_off):
    """The port's fused read (plain gather on the CPU) against JAX's
    use_window=False, on tests/test_fused_v2.py's setup: reversed lanes,
    head/tail bases, IUPAC-free resolved references."""
    B, E, l_cap, ht_cap, l_out = 32, 256, 2048, 1024, 3072
    ev, sk = _walk(tables, B, E, 1600, seed=3)
    rs = np.random.default_rng(1)
    head = rs.integers(0, 200, B).astype(np.int32)
    tail = rs.integers(0, 200, B).astype(np.int32)
    is_rev = rs.random(B) > 0.5
    ref_seg = np.frombuffer(b"ACGT", np.uint8)[rs.integers(0, 4, (B, l_cap + 256))]
    seg_off = rs.integers(0, 256, B).astype(np.int32) if with_seg_off else None
    u_mis = rs.random((B, l_out), dtype=np.float32)
    u_ins = rs.random((B, l_out), dtype=np.float32)
    jcodes = japply._pack_codes4(jnp.asarray(ref_seg))
    tcodes = tapply._pack_codes4(torch.from_numpy(ref_seg))
    _eq(jcodes, tcodes, "packed codes")
    jo = japply.fused_read_v2(
        *(jnp.asarray(x) for x in ev[:5]), jnp.asarray(head), jnp.asarray(tail),
        jnp.asarray(is_rev), jcodes, ref_seg.shape[1],
        None if seg_off is None else jnp.asarray(seg_off), jnp.asarray(sk),  # uint32
        jnp.asarray(u_mis), jnp.asarray(u_ins), l_out, ht_cap, jrng.SITE_HEAD_TAIL,
        use_window=False)
    to = tapply.fused_read_v2(
        *(torch.from_numpy(x) for x in ev[:5]), torch.from_numpy(head),
        torch.from_numpy(tail), torch.from_numpy(is_rev), tcodes, ref_seg.shape[1],
        None if seg_off is None else torch.from_numpy(seg_off),
        torch.from_numpy(sk.astype(np.int64)),
        torch.from_numpy(u_mis), torch.from_numpy(u_ins), l_out, ht_cap)
    for name, a, b in zip(("read", "qclass", "l_new", "total"), jo[:4], to):
        _eq(a, b, name)
    assert is_rev.any() and (~is_rev).any()
    assert (_np(to[1]) == tapply.CLASS_INS).any() and (_np(to[1]) == tapply.CLASS_MIS).any()


def test_qual_sample_matches_jax(model, tables):
    _, _, tt = tables
    jq = jprofile.load_profile(model[1], mode="genome", fastq=True)
    from nanosim_tpu.sim.bundles import build_tables

    jqual = build_tables(jq).qual
    rs = np.random.default_rng(14)
    cls = rs.integers(0, 5, (8, 700)).astype(np.int32)
    u = rs.random((8, 700), dtype=np.float32)
    u[0, :4] = [0.0, np.float32(1) - np.float32(2**-24), 0.5, 1e-30]
    _eq(jqual.sample(jnp.asarray(cls), jnp.asarray(u)),
        tt.qual.sample(torch.from_numpy(cls), torch.from_numpy(u)))


def test_unaligned_map_and_materialize_match_jax(tables):
    B, E, l_cap = 32, 768, 640
    ev, _ = _walk(tables, B, E, 600, seed=9, unaligned=True)
    jgm_, jund, jov = japply.build_unaligned_map(*(jnp.asarray(x) for x in ev[:5]), l_cap)
    tgm_, tund, tov = tapply.build_unaligned_map(*(torch.from_numpy(x) for x in ev[:5]), l_cap)
    for f in ("src", "qclass", "valid", "read_len"):
        _eq(getattr(jgm_, f), getattr(tgm_, f), f)
    _eq(jund, tund, "under_ins")
    _eq(jov, tov, "overflow")
    assert _np(tund).any()
    rs = np.random.default_rng(15)
    ref_seg = _ascii(rs, (B, l_cap))
    u_mis = rs.random((B, l_cap), dtype=np.float32)
    u_ins = rs.random((B, l_cap), dtype=np.float32)
    jr = japply.materialize_read(jgm_.src, jgm_.qclass, jgm_.valid, jnp.asarray(ref_seg),
                                 jnp.asarray(u_mis), jnp.asarray(u_ins), under_ins=jund)
    tr = tapply.materialize_read(tgm_.src, tgm_.qclass, tgm_.valid, torch.from_numpy(ref_seg),
                                 torch.from_numpy(u_mis), torch.from_numpy(u_ins),
                                 under_ins=tund)
    _eq(jr, tr, "materialized read")


@pytest.mark.parametrize("with_events", [False, True])
def test_compact_pack_with_reads_matches_jax(with_events):
    """compact_pack(with reads, FASTQ): the whole transfer buffer, byte for
    byte, and the reads decoded back."""
    rs = np.random.default_rng(16)
    B, L, E = 24, 1300, 40
    total = rs.integers(0, L + 1, B).astype(np.int32)
    valid = rs.random(B) > 0.3
    j = np.arange(L)[None, :]
    read = np.where(j < total[:, None], _ascii(rs, (B, L)), 0).astype(np.uint8)
    quals = np.where(j < total[:, None], rs.integers(34, 80, (B, L)), 0).astype(np.uint8)
    n_ev = rs.integers(0, E + 1, B).astype(np.int32)
    live = np.arange(E)[None, :] < n_ev[:, None]
    ev = [np.where(live, rs.integers(0, hi, (B, E)), 0).astype(np.int32)
          for hi in (2**17, 3, 200)]
    meta = [rs.integers(0, 1000, B).astype(np.int32) for _ in range(5)]
    args = [valid, total, *meta, rs.integers(0, 10**9, B).astype(np.int64),
            rs.random(B) > 0.5, n_ev, rs.random(B) > 0.9, *ev,
            rs.integers(0, 1000, B).astype(np.int32)]
    kw = dict(ne_cap=256, with_events=with_events, with_checksum=not with_events)
    jb = np.asarray(jcompact.compact_pack(
        jnp.asarray(read), jnp.asarray(quals), *(jnp.asarray(a) for a in args),
        nr_cap=256, nq_cap=256, fastq=True, with_reads=True, **kw))
    tb = tcompact.compact_pack(*(torch.from_numpy(a) for a in args),
                               read=torch.from_numpy(read), quals=torch.from_numpy(quals),
                               nr_cap=256, nq_cap=256, **kw).numpy()
    assert jb.tobytes() == tb.tobytes()
    cb, ok = tcompact.decode_compact(tb, B, 256, 256, 256, fastq=True, with_events=with_events)
    assert ok and cb.needs[0] > 0
    # 2-bit packing maps every non-ACGT byte to A
    want = np.frombuffer(b"ACGT", np.uint8)[tapply._ascii_to_code(torch.from_numpy(read)).numpy()]
    lanes = np.nonzero(valid)[0]
    for b, r in zip(lanes, tcompact.decode_reads_ascii(cb, lanes)):
        assert r.tobytes() == want[b, : total[b]].tobytes()
        o = int(cb.qual_off[b])
        assert cb.quals_flat[o : o + total[b]].tobytes() == quals[b, : total[b]].tobytes()


BATCH_FIELDS = ("valid", "total_len", "head", "tail", "middle_ref", "l_new", "chrom",
                "local_pos", "is_reversed", "n_events", "capacity_overflow", "read", "quals")


def _compare_batches(jo, to, fields):
    for f in fields:
        _eq(getattr(jo, f), getattr(to, f), f)
    n = _np(to.n_events)
    live = np.arange(_np(to.ev_type).shape[1])[None, :] < n[:, None]
    for f in ("ev_pos2x", "ev_type", "ev_len"):
        _eq(np.where(live, _np(getattr(jo, f)), 0), getattr(to, f), f)
    assert _np(to.valid).any()


@pytest.mark.parametrize("dna", ["linear", "circular"])
def test_read_emitting_batch_matches_jax(model, dna):
    """genome_batch(emit_reads=True) and unaligned_batch(emit_reads=True)
    against the JAX package's, every field, FASTQ."""
    _, prefix, refs = model
    circ = dna == "circular"
    jg = JGenome.from_fasta(refs[dna], dna_type=dna)
    tg = TGenome.from_fasta(refs[dna], dna_type=dna)
    jp = jprofile.load_profile(prefix, mode="genome", fastq=True)
    tp = tprofile.load_profile(prefix, mode="genome", fastq=True)
    slots = np.arange(4 * BATCH, dtype=np.int64)

    js = jgm.GenomeSimulator(jg, jp, fastq=True, circular_dna=circ, batch=BATCH)
    ts = tgm.GenomeSimulator(tg, tp, fastq=True, circular_dna=circ, batch=BATCH, device="cpu")
    jo = js.batch_fn(emit_reads=True)(jrng.base_key(SEED), jnp.asarray(slots))
    to = ts.batch_fn(emit_reads=True)(trng.base_key(SEED, device="cpu"),
                                      torch.from_numpy(slots))
    _compare_batches(jo, to, BATCH_FIELDS + ("m_ref_init",))
    if circ:  # some accepted read crosses the origin
        v = _np(to.valid)
        assert ((_np(to.local_pos) + _np(to.middle_ref))[v] > jg.total_len).any()

    ju = jum.UnalignedSimulator(jg, jp, fastq=True, circular_dna=circ, batch=BATCH)
    tu = tum.UnalignedSimulator(tg, tp, fastq=True, circular_dna=circ, batch=BATCH,
                                device="cpu")
    jo = ju.batch_fn()(jrng.base_key(SEED, jrng.STREAM_UNALIGNED), jnp.asarray(slots))
    to = tu.batch_fn(emit_reads=True)(trng.base_key(SEED, trng.STREAM_UNALIGNED, device="cpu"),
                                      torch.from_numpy(slots))
    _compare_batches(jo, to, BATCH_FIELDS)


def test_circular_needs_a_circular_genome(model):
    _, prefix, refs = model
    tg = TGenome.from_fasta(refs["circular"])  # loaded as linear
    tp = tprofile.load_profile(prefix, mode="genome")
    with pytest.raises(ValueError, match="loaded as linear"):
        tgm.GenomeSimulator(tg, tp, circular_dna=True, device="cpu")
    with pytest.raises(ValueError, match="loaded as linear"):
        tum.UnalignedSimulator(tg, tp, circular_dna=True, device="cpu")
