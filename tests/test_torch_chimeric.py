"""The modules of the chimeric slice against the JAX package, exactly.

Inputs are made from a seed (the fixture writers and numpy); the JAX side runs
on the CPU as its own tests run it; the port runs with device="cpu".
Tolerance: equality, bit for bit, everywhere.

Covered: the per-(slot, part) keys, the geometric segment count (mixed
precisions), the gap-length KDE draw, the meta-only batch program with packed
and with unpacked walk lanes (field by field and as the packed meta row), a
forced packed spill, the read-emitting batch program (plain and `-hp`), and
the table bundle carried over from the JAX package's arrays.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosim_tpu.io.genome import PackedGenome as JGenome
from nanosim_tpu.ops import rng as jrng
from nanosim_tpu.profiles import error_model as jerror_model
from nanosim_tpu.profiles import fixtures as jfixtures
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import chimeric_mode as jchi
from nanosim_tpu.sim import genome_mode as jgm
from nanosim_tpu_torch.io.genome import PackedGenome as TGenome
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import bundles as tbundles
from nanosim_tpu_torch.sim import chimeric_mode as tchi
from nanosim_tpu_torch.sim import genome_mode as tgm

from test_torch_common import make_model, tables_to_numpy

SEED = 5
BATCH = 48
K = 6
SEGMENT_MEAN = 1.9  # multi-segment reads are common


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chimods"))
    prefix = make_model(d, mean_read_len=400, sd_read_len=150)
    jerror_model.write_chimeric_info(prefix + "_chimeric_info", SEGMENT_MEAN, 0.2)
    ref = os.path.join(d, "ref.fa")
    jfixtures.make_reference_fasta(ref, [30000, 15000], seed=6, hp_bias=0.5)
    return prefix, ref


@functools.lru_cache(maxsize=None)
def _sims_cached(prefix, ref, fastq, kmer_bias):
    kw = dict(fastq=fastq, batch=BATCH, kmer_bias=kmer_bias)
    pkw = dict(mode="genome", chimeric=True, fastq=fastq, homopolymer=kmer_bias is not None)
    js = jchi.ChimericGenomeSimulator(JGenome.from_fasta(ref),
                                      jprofile.load_profile(prefix, **pkw), **kw)
    ts = tchi.ChimericGenomeSimulator(TGenome.from_fasta(ref),
                                      tprofile.load_profile(prefix, **pkw), device="cpu", **kw)
    return js, ts


def _sims(model, fastq=False, kmer_bias=None):
    return _sims_cached(*model, fastq, kmer_bias)


def _slots(start=0):
    return np.arange(start, start + BATCH, dtype=np.int64)


def _jax_batch(js, slots, **overrides):
    fn = functools.partial(jchi.chimeric_batch,
                           species=jnp.zeros((BATCH, js.s_max), jnp.int32),
                           genome=js.genome_dev, tables=js.tables, **{**js.kw, **overrides})
    return fn(jrng.base_key(SEED, jrng.STREAM_ALIGNED), jnp.asarray(slots))


def _torch_batch(ts, slots, **overrides):
    return ts.batch_fn(**overrides)(trng.base_key(SEED, trng.STREAM_ALIGNED, device="cpu"),
                                    torch.from_numpy(slots))


def _np(x):
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
    return a.astype(np.int64) if a.dtype != np.bool_ else a


META_FIELDS = ("valid", "total_len", "head", "tail", "n_seg", "seg_middle_ref", "seg_l_new",
               "seg_offset", "gap_len", "chrom", "local_pos", "is_reversed", "n_events",
               "seg_mref_init", "gap_mref_init", "gap_chrom", "gap_pos", "gap_n_steps",
               "gap_middle")


def _assert_fields_equal(jo, to, fields):
    for f in fields:
        a, b = _np(getattr(jo, f)), _np(getattr(to, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_part_slot_keys_match_jax():
    slots = np.arange(100, 100 + BATCH, dtype=np.int64)
    jk = jrng.slot_keys(jrng.base_key(SEED), jnp.asarray(slots))
    tk = trng.slot_keys(trng.base_key(SEED, device="cpu"), torch.from_numpy(slots))
    assert trng.PART_SEGMENT_BASE == jrng.PART_SEGMENT_BASE
    assert trng.PART_GAP_BASE == jrng.PART_GAP_BASE
    for base in (jrng.PART_SEGMENT_BASE, jrng.PART_GAP_BASE):
        for part in (0, 3, 7):
            np.testing.assert_array_equal(
                _np(jrng.part_slot_keys(jk, base, part)),
                trng.part_slot_keys(tk, base, part).numpy())
        # the packed layout folds a per-lane part id
        parts = np.random.default_rng(1).integers(0, 8, BATCH)
        want = jax.vmap(jax.random.fold_in)(jk, base + jnp.asarray(parts))
        got = trng.part_slot_keys(tk, base, torch.from_numpy(parts))
        np.testing.assert_array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("segment_mean", [1.25, 1.3, 1.9])
def test_geometric_matches_jax(segment_mean):
    """float32 log1p(-u) over the float64 log1p(-p) rounded to float32: equal
    on 1e5 uniforms, the neighbours of 0 and 1 among them, eagerly and under
    jit."""
    rs = np.random.default_rng(int(segment_mean * 100))
    u = rs.random(100000, dtype=np.float32)
    tiny = np.float32(2.0 ** -24)
    u[:8] = [0.0, tiny, 2 * tiny, np.float32(1e-7), 1 - tiny, 1 - 2 * tiny,
             np.nextafter(np.float32(1), np.float32(0)), 0.5]
    p = 1.0 / segment_mean
    got = tchi._geometric(torch.from_numpy(u), p).numpy()
    want = np.asarray(jchi._geometric(jnp.asarray(u), p))
    np.testing.assert_array_equal(got, want)
    want_jit = np.asarray(jax.jit(lambda x: jchi._geometric(x, p))(jnp.asarray(u)))
    np.testing.assert_array_equal(got, want_jit)
    assert got.min() >= 0 and got.max() > 5


def test_gap_kde_draw_matches_jax(model):
    """The one-column draw from the log-transformed gap-length KDE."""
    js, ts = _sims(model)
    assert ts.tables.kde_gap.log_transform
    slots = _slots(500)
    jk = jrng.part_slot_keys(jrng.slot_keys(jrng.base_key(SEED), jnp.asarray(slots)),
                             jrng.PART_GAP_BASE, 2)
    tk = trng.part_slot_keys(trng.slot_keys(trng.base_key(SEED, device="cpu"),
                                            torch.from_numpy(slots)), trng.PART_GAP_BASE, 2)
    want = np.asarray(jgm._kde_draw(jk, jrng.SITE_GAP, js.tables.kde_gap, 1))
    got = tgm._kde_draw(tk, trng.SITE_GAP, ts.tables.kde_gap, 1).numpy()
    assert got.shape == want.shape == (BATCH, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_capacities_match_jax(model):
    js, ts = _sims(model, fastq=True, kmer_bias=K)
    for name in ("l_cap", "ht_cap", "gap_cap", "gap_steps", "l_out", "e_max", "s_max"):
        assert getattr(js, name) == getattr(ts, name), name
    for key, v in ts.kw.items():
        assert js.kw[key] == v, key


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_meta_batch_matches_jax(model, packed):
    js, ts = _sims(model)
    slots = _slots()
    jo = _jax_batch(js, slots, emit_reads=False, packed_walks=packed)
    to = _torch_batch(ts, slots, emit_reads=False, packed_walks=packed)
    _assert_fields_equal(jo, to, META_FIELDS + ("seg_cksum", "gap_cksum", "packed_spill"))
    jm = np.asarray(jchi.pack_chimeric_meta(jo))
    tm = tchi.pack_chimeric_meta(to).numpy()
    assert jm.dtype == tm.dtype == np.int64
    np.testing.assert_array_equal(jm, tm)
    d = tchi.decode_chimeric_meta(tm, ts.s_max)
    assert d["valid"].sum() >= 15 and (d["n_seg"][d["valid"]] > 1).sum() >= 5
    assert not d["spill"].any()
    assert (d["seg_cksum"] >= 0).all() and (d["seg_cksum"] < 2**32).all()
    assert (d["seg_cksum"] >= 2**31).any()  # the checksums use all 32 bits


def test_packed_meta_equals_unpacked_in_the_port(model):
    """Where a pair computes cannot change its draws: the packed program's
    meta rows equal the unpacked program's, byte for byte."""
    _, ts = _sims(model)
    slots = _slots(BATCH)
    packed = tchi.pack_chimeric_meta(_torch_batch(ts, slots, emit_reads=False)).numpy()
    unpacked = ts.chimeric_meta_unpacked(slots, SEED)
    assert packed.shape == unpacked.shape == (
        BATCH, tchi.CHI_META_SCALARS + tchi.CHI_META_SEG * ts.s_max
        + tchi.CHI_META_GAP * (ts.s_max - 1))
    np.testing.assert_array_equal(packed, unpacked)


def test_forced_spill_matches_jax(model):
    """A packed capacity of 8 lanes: the batch spills, every lane is invalid,
    and the meta row still equals the JAX program's."""
    js, ts = _sims(model)
    slots = _slots()
    jo = _jax_batch(js, slots, emit_reads=False, packed_cap=8)
    to = _torch_batch(ts, slots, emit_reads=False, packed_cap=8)
    assert bool(to.packed_spill) and bool(np.asarray(jo.packed_spill))
    assert not bool(to.valid.any())
    np.testing.assert_array_equal(np.asarray(jchi.pack_chimeric_meta(jo)),
                                  tchi.pack_chimeric_meta(to).numpy())


def _assert_emit_equal(jo, to, hp):
    _assert_fields_equal(jo, to, META_FIELDS)
    valid = _np(to.valid)
    assert valid.sum() >= 15
    for f in ("read", "quals"):
        a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    n_flat = _np(to.n_events).T.reshape(-1)  # [S*B] segment-major
    in_prefix = np.arange(to.ev_type.shape[1])[None, :] < n_flat[:, None]
    for f in ("ev_pos2x", "ev_type", "ev_len"):
        a, b = _np(getattr(jo, f)), _np(getattr(to, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(np.where(in_prefix, a, 0), np.where(in_prefix, b, 0),
                                      err_msg=f)
    if hp:  # some event was suppressed inside a run
        walk_len = np.where(in_prefix, _np(to.ev_len), 0)
        assert (walk_len == 0).sum() > 0
    # pass-1 segments (the -hp log's source): the lanes' realized prefixes
    a, b = np.asarray(jo.seg_read_prehp), to.seg_read_prehp.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    for f in ("gap_ev_pos2x", "gap_ev_type", "gap_ev_len"):
        a, b = _np(getattr(jo, f)), _np(getattr(to, f))
        g_flat = _np(to.gap_n_steps).T.reshape(-1)
        mask = np.arange(a.shape[1])[None, :] < g_flat[:, None]
        np.testing.assert_array_equal(np.where(mask, a, 0), np.where(mask, b, 0), err_msg=f)


@pytest.mark.parametrize("kmer_bias", [None, K], ids=["plain", "hp"])
def test_emit_batch_matches_jax(model, kmer_bias):
    """The read-emitting program with FASTQ qualities: reads, qualities,
    events, pass-1 segments and every meta field."""
    js, ts = _sims(model, fastq=True, kmer_bias=kmer_bias)
    slots = _slots()
    jo = _jax_batch(js, slots)
    to = _torch_batch(ts, slots)
    _assert_emit_equal(jo, to, kmer_bias is not None)
    n_seg = _np(to.n_seg)[_np(to.valid)]
    assert (n_seg > 1).sum() >= 5


def test_not_ported_parameters_raise(model):
    _, ts = _sims(model)
    for kw in (dict(metagenome=True), dict(perfect=True), dict(median_len=5000.0, sd_len=1.0)):
        with pytest.raises(NotImplementedError, match="metagenome"):
            _torch_batch(ts, _slots(), **kw)


def test_tables_carry_over_from_jax(model):
    """tables_from_numpy carries kde_gap and the rest of the JAX SimTables
    across, and the batch on the carried tables equals the batch on the
    port's own."""
    js, ts = _sims(model, fastq=True)
    d = tables_to_numpy(js.tables)
    assert any(k.startswith("kde_gap.") for k in d)
    carried = tbundles.tables_from_numpy(d, "cpu")
    for field in tbundles.SimTables._fields:
        own, got = getattr(ts.tables, field), getattr(carried, field)
        assert (own is None) == (got is None), field
    assert carried.kde_gap.log_transform == ts.tables.kde_gap.log_transform
    slots = _slots(3 * BATCH)
    base = trng.base_key(SEED, trng.STREAM_ALIGNED, device="cpu")
    own = ts.batch_fn(emit_reads=False)(base, torch.from_numpy(slots))
    other = functools.partial(tchi.chimeric_batch, genome=ts.genome_dev, tables=carried,
                              **{**ts.kw, "emit_reads": False})(base, torch.from_numpy(slots))
    np.testing.assert_array_equal(tchi.pack_chimeric_meta(own).numpy(),
                                  tchi.pack_chimeric_meta(other).numpy())
    assert bool(own.valid.any())
