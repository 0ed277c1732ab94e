"""The modules of the metagenome slice against the JAX package, exactly.

Inputs are made from a seed (the fixture writers and numpy); the JAX side runs
on the CPU as its own tests run it; the port runs with device="cpu".
Tolerance: equality, bit for bit, everywhere.

Covered: `MetagenomeSet` (with and without a dna-type list), the GenomeDevice
species tables, the abundance machinery (`read_abundance_matrix`,
`add_abundance_var`, `inflate_abun`), the three float64 uniforms per key, the
metagenome position sampler with both of its fallbacks, phase A's host replay
and the greedy species assignment, the resume state file, and the metagenome
batch program (meta-only with packed and unpacked walk lanes, read-emitting,
`-hp`, perfect reads, a forced packed spill).  Whole runs are in
tests/test_torch_metagenome_runs.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanosim_tpu.io.genome import MetagenomeSet as JSet
from nanosim_tpu.ops import rng as jrng
from nanosim_tpu.profiles import profile as jprofile
from nanosim_tpu.sim import chimeric_mode as jchi
from nanosim_tpu.sim import extract as jextract
from nanosim_tpu.sim import run_metagenome as jrm
from nanosim_tpu_torch.io.genome import MetagenomeSet as TSet
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import chimeric_mode as tchi
from nanosim_tpu_torch.sim import extract as textract
from nanosim_tpu_torch.sim import run_metagenome as trm

from test_torch_common import make_metagenome_fixture

SEED = 5
BATCH = 48
K = 6


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_metagenome_fixture(str(tmp_path_factory.mktemp("metamods")))


def _np(x):
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
    return a.astype(np.int64) if a.dtype != np.bool_ else a


@pytest.mark.parametrize("with_dna_list", [True, False], ids=["linear-list", "default-circular"])
def test_metagenome_set_matches_jax(fx, with_dna_list):
    dl = fx.dl if with_dna_list else None
    a, b = JSet.from_genome_list(fx.glist, dl), TSet.from_genome_list(fx.glist, dl)
    assert a.species_names == b.species_names == fx.species
    assert a.packed.names == b.packed.names
    for f in ("flat", "offsets", "lengths", "circular"):
        x, y = getattr(a.packed, f), getattr(b.packed, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("species_of_chrom", "chrom_start_of_species"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.max_chrom_of_species(), b.max_chrom_of_species())
    np.testing.assert_array_equal(a.total_len_of_species(), b.total_len_of_species())
    assert b.packed.circular.all() != with_dna_list
    assert list(b.chrom_start_of_species) == [0, 1, 3, 4]


def test_genome_device_species_tables_match_jax(fx):
    """from_metagenome carries the species tables; from_packed fills one
    species holding every chromosome, as the JAX package's does."""
    js, ts = JSet.from_genome_list(fx.glist, fx.dl), TSet.from_genome_list(fx.glist, fx.dl)
    for jg, tg in ((jextract.GenomeDevice.from_metagenome(js),
                    textract.GenomeDevice.from_metagenome(ts, "cpu")),
                   (jextract.GenomeDevice.from_packed(js.packed),
                    textract.GenomeDevice.from_packed(ts.packed, "cpu"))):
        for f in ("offsets", "lengths", "circular", "species_of_chrom",
                  "chrom_start_of_species"):
            np.testing.assert_array_equal(np.asarray(getattr(jg, f)), getattr(tg, f).numpy(),
                                          err_msg=f)
        assert tg.species_of_chrom.dtype == tg.chrom_start_of_species.dtype == torch.int32
        n = jg.genome_len
        assert tg.genome_len == n
        np.testing.assert_array_equal(np.asarray(jg.flat[:n]), tg.flat[:n].numpy())


def test_abundance_machinery_matches_jax(fx):
    names = set(fx.species)
    jn, jsamples = jrm.read_abundance_matrix(fx.abun, names)
    tn, tsamples = trm.read_abundance_matrix(fx.abun, names)
    assert jn == tn == [120, 80]
    assert jsamples == tsamples
    total_len = {sp: int(x) for sp, x in
                 zip(fx.species, TSet.from_genome_list(fx.glist, fx.dl).total_len_of_species())}
    ra = np.random.default_rng(np.random.SeedSequence([3, 0xAB]))
    rb = np.random.default_rng(np.random.SeedSequence([3, 0xAB]))
    for sample in tsamples:
        for lo, hi in ((-0.5, 0.5), (0.0, 0.9)):
            va = jrm.add_abundance_var(sample, total_len, lo, hi, ra)
            vb = trm.add_abundance_var(sample, total_len, lo, hi, rb)
            assert va == vb
            assert abs(sum(vb.values()) - 100) < 1e-9
        for infl in (0.0, 0.35, 1.0):
            frac = {k: v / 100 for k, v in sample.items()}
            for sp in sample:
                assert jrm.inflate_abun(frac, sp, infl) == trm.inflate_abun(frac, sp, infl)
    assert ra.bit_generator.state == rb.bit_generator.state
    bad = os.path.join(os.path.dirname(fx.abun), "bad_abun.tsv")
    with open(bad, "w") as f:
        f.write("Species\t10\nUnknown species\t100\n")
    with pytest.raises(ValueError, match="reference genome for Unknown_species"):
        trm.read_abundance_matrix(bad, names)


def test_uniform_f64_three_per_key_matches_jax():
    """rng.uniform_f64(keys, (3,)): the draws of jax.random.uniform(k, (3,),
    float64), bit for bit."""
    slots = np.arange(7, 7 + 300, dtype=np.int64)
    jk = jrng.site_keys(jrng.slot_keys(jrng.base_key(SEED), jnp.asarray(slots)),
                        jrng.SITE_SPECIES)
    want = jax.vmap(lambda k: jax.random.uniform(k, (3,), dtype=jnp.float64))(jk)
    tk = trng.site_keys(trng.slot_keys(trng.base_key(SEED, device="cpu"),
                                       torch.from_numpy(slots)), trng.SITE_SPECIES)
    got = trng.uniform_f64(tk, (3,))
    assert got.dtype == torch.float64 and got.shape == (300, 3)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint64), got.numpy().view(np.uint64))


@pytest.mark.parametrize("with_dna_list", [True, False], ids=["linear", "circular"])
def test_sample_metagenome_positions_matches_jax(fx, with_dna_list):
    """Seeded species and lengths, among them lengths that only a longer
    chromosome of the same species holds (Bacillus: 8,000 < l <= 20,000),
    lengths that only another species holds (Salmonella: 25,000 < l <=
    30,000) and lengths no chromosome holds."""
    dl = fx.dl if with_dna_list else None
    jg = jextract.GenomeDevice.from_metagenome(JSet.from_genome_list(fx.glist, dl))
    tg = textract.GenomeDevice.from_metagenome(TSet.from_genome_list(fx.glist, dl), "cpu")
    rs = np.random.default_rng(11)
    n = 600
    species = rs.integers(0, 3, n).astype(np.int32)
    lengths = rs.integers(50, 9000, n).astype(np.int32)
    lengths[0::5] = rs.integers(9000, 20000, len(lengths[0::5]))
    lengths[1::5] = rs.integers(25001, 30000, len(lengths[1::5]))
    lengths[2::50] = 40000
    slots = np.arange(n, dtype=np.int64)
    jk = jrng.slot_keys(jrng.base_key(SEED), jnp.asarray(slots))
    tk = trng.slot_keys(trng.base_key(SEED, device="cpu"), torch.from_numpy(slots))
    want = jextract.sample_metagenome_positions(jk, jnp.asarray(species), jnp.asarray(lengths),
                                                jg, int(jg.lengths.shape[0]))
    got = textract.sample_metagenome_positions(tk, torch.from_numpy(species),
                                               torch.from_numpy(lengths), tg)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    for w, g, f in zip(want, got, ("chrom", "pos", "ok")):
        np.testing.assert_array_equal(_np(w), _np(g), err_msg=f)
    chrom, ok = got[0].numpy(), got[2].numpy()
    sp_of = tg.species_of_chrom.numpy()
    # not vacuous: both fallbacks were taken, and some lanes found nothing
    assert ((sp_of[chrom] == species) & (chrom == 1) & (lengths > 8000)).any()
    assert ((sp_of[chrom] != species) & ok).any()
    assert (~ok).any() and ok[lengths <= 8000].all()


def _sims(fx, **kw):
    return _sims_cached(fx.prefix, fx.glist, fx.dl, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _sims_cached(prefix, glist, dl, kw):
    kw = dict(kw)
    pkw = dict(mode="metagenome", chimeric=kw.get("chimeric", False),
               fastq=kw.get("fastq", False), homopolymer=kw.get("kmer_bias") is not None,
               perfect=kw.get("perfect", False))
    abun = {"Escherichia_coli": 60.0, "Bacillus_subtilis": 30.0, "Salmonella_enterica": 10.0}
    js = jrm.MetagenomeSimulator(JSet.from_genome_list(glist, dl),
                                 jprofile.load_profile(prefix, **pkw), abun, batch=BATCH, **kw)
    ts = trm.MetagenomeSimulator(TSet.from_genome_list(glist, dl),
                                 tprofile.load_profile(prefix, **pkw), abun, batch=BATCH,
                                 device="cpu", **kw)
    return js, ts


def _slots(start=0):
    return np.arange(start, start + BATCH, dtype=np.int64)


def _species(S, seed=4):
    return np.random.default_rng(seed).integers(0, 3, (BATCH, S)).astype(np.int32)


def _jax_batch(js, slots, species, **overrides):
    fn = functools.partial(jchi.chimeric_batch, genome=js.genome_dev, tables=js.tables,
                           **{**js.kw, **overrides})
    return fn(jrng.base_key(SEED, jrng.STREAM_ALIGNED), jnp.asarray(slots), jnp.asarray(species))


def _torch_batch(ts, slots, species, **overrides):
    return ts.batch_fn(**overrides)(trng.base_key(SEED, trng.STREAM_ALIGNED, device="cpu"),
                                    torch.from_numpy(slots), species=torch.from_numpy(species))


META_FIELDS = ("valid", "total_len", "head", "tail", "n_seg", "seg_middle_ref", "seg_l_new",
               "seg_offset", "gap_len", "chrom", "local_pos", "is_reversed", "n_events",
               "seg_mref_init", "gap_mref_init", "gap_chrom", "gap_pos", "gap_n_steps",
               "gap_middle")


def _assert_fields_equal(jo, to, fields):
    for f in fields:
        a, b = _np(getattr(jo, f)), _np(getattr(to, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_capacities_match_jax(fx):
    for kw in (dict(), dict(chimeric=True), dict(perfect=True)):
        js, ts = _sims(fx, **kw)
        for attr in ("s_max", "max_len", "l_cap", "ht_cap", "gap_cap", "gap_steps", "l_out",
                     "e_max"):
            assert getattr(js, attr) == getattr(ts, attr), (kw, attr)
        for key, v in ts.kw.items():
            assert js.kw[key] == v, (kw, key)


@pytest.mark.parametrize("kw", [dict(chimeric=True), dict(), dict(perfect=True)],
                         ids=["chimeric", "plain", "perfect"])
def test_phase_a_and_species_assignment_match_jax(fx, kw):
    """Phase A's host replay of the segment counts and lengths, then two
    batches of greedy species assignment with the quota carried between them."""
    js, ts = _sims(fx, **kw)
    jbase = jrng.base_key(SEED, jrng.STREAM_ALIGNED)
    tbase = trng.base_key(SEED, trng.STREAM_ALIGNED, device="cpu")
    ra = np.random.default_rng(np.random.SeedSequence([SEED, 0xA55]))
    rb = np.random.default_rng(np.random.SeedSequence([SEED, 0xA55]))
    bases_a = np.zeros(3)
    bases_b = np.zeros(3)
    for start in (0, BATCH):
        jn, jm = js._phase_a(jbase, jnp.arange(start, start + BATCH, dtype=jnp.int64))
        tn, tm = ts._phase_a(tbase, _slots(start))
        np.testing.assert_array_equal(jn, tn)
        np.testing.assert_array_equal(jm, tm)
        assert tn.dtype == np.int32 and tm.shape == (BATCH, ts.s_max)
        sa = jrm.assign_species_batch(jm, jn, bases_a, js.abun, js.abun_inflated, ra)
        sb = trm.assign_species_batch(tm, tn, bases_b, ts.abun, ts.abun_inflated, rb)
        np.testing.assert_array_equal(sa, sb)
        seg = np.arange(ts.s_max)[None, :] < tn[:, None]
        np.add.at(bases_a, sa[seg], jm[seg])
        np.add.at(bases_b, sb[seg], tm[seg])
    assert ra.bit_generator.state == rb.bit_generator.state
    if kw.get("chimeric"):
        assert (tn > 1).sum() >= 5
        assert (ts.abun_inflated is None) == (js.abun_inflated is None)
    assert len(np.unique(sb)) == 3


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_meta_batch_matches_jax(fx, packed):
    """The meta-only program with per-segment species (the packed species
    lookup, or the unpacked one) and the gaps' uniform species draw."""
    js, ts = _sims(fx, chimeric=True)
    slots, species = _slots(), _species(ts.s_max)
    jo = _jax_batch(js, slots, species, emit_reads=False, packed_walks=packed)
    to = _torch_batch(ts, slots, species, emit_reads=False, packed_walks=packed)
    _assert_fields_equal(jo, to, META_FIELDS + ("seg_cksum", "gap_cksum", "packed_spill"))
    np.testing.assert_array_equal(np.asarray(jchi.pack_chimeric_meta(jo)),
                                  tchi.pack_chimeric_meta(to).numpy())
    valid, n_seg = _np(to.valid).astype(bool), _np(to.n_seg)
    assert valid.sum() >= 15 and (n_seg[valid] > 1).sum() >= 5
    # segments land on their species' chromosomes; gaps on any species
    sp_of = ts.genome_dev.species_of_chrom.numpy()
    seg = np.arange(ts.s_max)[None, :] < n_seg[:, None]
    assert (sp_of[_np(to.chrom)][seg & valid[:, None]]
            == species[seg & valid[:, None]]).mean() > 0.9
    gap = np.arange(ts.s_max - 1)[None, :] < (n_seg - 1)[:, None]
    assert len(np.unique(sp_of[_np(to.gap_chrom)[gap]])) == 3


def test_packed_meta_equals_unpacked_in_the_port(fx):
    js, ts = _sims(fx, chimeric=True)
    slots, species = _slots(BATCH), _species(ts.s_max, seed=8)
    packed = tchi.pack_chimeric_meta(_torch_batch(ts, slots, species,
                                                  emit_reads=False)).numpy()
    np.testing.assert_array_equal(packed, ts.chimeric_meta_unpacked(slots, SEED, species))


def test_forced_spill_matches_jax(fx):
    js, ts = _sims(fx, chimeric=True)
    slots, species = _slots(), _species(ts.s_max)
    jo = _jax_batch(js, slots, species, emit_reads=False, packed_cap=8)
    to = _torch_batch(ts, slots, species, emit_reads=False, packed_cap=8)
    assert bool(to.packed_spill) and not bool(to.valid.any())
    np.testing.assert_array_equal(np.asarray(jchi.pack_chimeric_meta(jo)),
                                  tchi.pack_chimeric_meta(to).numpy())


def _assert_emit_equal(jo, to):
    _assert_fields_equal(jo, to, META_FIELDS)
    assert _np(to.valid).sum() >= 15
    for f in ("read", "quals", "seg_read_prehp"):
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


@pytest.mark.parametrize("kw", [dict(chimeric=True, fastq=True),
                                dict(chimeric=True, fastq=True, kmer_bias=K),
                                dict(fastq=True)],
                         ids=["chimeric", "chimeric-hp", "plain"])
def test_emit_batch_matches_jax(fx, kw):
    """The read-emitting program: reads, qualities, events, pass-1 segments
    and every meta field."""
    js, ts = _sims(fx, **kw)
    slots, species = _slots(), _species(ts.s_max)
    _assert_emit_equal(_jax_batch(js, slots, species), _torch_batch(ts, slots, species))


@pytest.mark.parametrize("emit", [False, True], ids=["meta-only", "read-emitting"])
def test_perfect_batch_matches_jax(fx, emit):
    """Perfect reads: no head or tail, no walk (zero events, the middle is the
    drawn length in [min_len, max_len]), never packed."""
    js, ts = _sims(fx, perfect=True, fastq=True)
    slots, species = _slots(), _species(ts.s_max)
    jo = _jax_batch(js, slots, species, emit_reads=emit)
    to = _torch_batch(ts, slots, species, emit_reads=emit)
    if emit:
        _assert_emit_equal(jo, to)
    else:
        _assert_fields_equal(jo, to, META_FIELDS + ("seg_cksum", "gap_cksum"))
        np.testing.assert_array_equal(np.asarray(jchi.pack_chimeric_meta(jo)),
                                      tchi.pack_chimeric_meta(to).numpy())
    valid = _np(to.valid).astype(bool)
    assert valid.sum() >= 15
    assert (_np(to.head) == 0).all() and (_np(to.tail) == 0).all()
    assert (_np(to.n_events) == 0).all()
    np.testing.assert_array_equal(_np(to.total_len)[valid], _np(to.seg_middle_ref)[valid, 0])


def test_resume_state_file_matches_jax(tmp_path):
    rs = np.random.default_rng(np.random.SeedSequence([1, 0xA55]))
    rs.random(5)
    bases = np.array([1234.0, 5.0, 0.0])
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    jrm.MetaResumeState(a).write(192, 150, bases, rs.bit_generator.state)
    trm.MetaResumeState(b).write(192, 150, bases, rs.bit_generator.state)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    st = trm.MetaResumeState(b)
    assert st.loaded and (st.slot_start, st.accepted) == (192, 150)
    assert st.current_bases == list(bases) and st.rng_state == rs.bit_generator.state
    assert not trm.MetaResumeState(str(tmp_path / "none.json")).loaded
