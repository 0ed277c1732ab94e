"""The transcriptome slice's device functions in the PyTorch port against the
JAX package, on the CPU, exactly: `to_uracil`, the 2D-KDE nearest-of-pool
draw (exact ties included), the transcript choice, the clamped head/tail
draw, the polyA length, both transcript position samplers, the intron
retention tables and walk (a '-' strand structure included), every branch
of `transcriptome_batch` (meta-only and read-emitting; plain, `-hp`,
`--perfect`, intron retention) and the meta transfer row.  Inputs are made
from a seed with numpy; whole runs are in tests/test_torch_transcriptome_runs.py.
"""

import functools
import os

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

SEED = 11
B = 48


def _flip_strands(gff: str, names) -> None:
    """Rewrite the structures of `names` onto the '-' strand."""
    out = []
    with open(gff) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if len(c) >= 9 and c[8].split("=")[-1] in names:
                c[6] = "-"
            out.append("\t".join(c))
    with open(gff, "w") as f:
        f.write("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """A transcriptome model (with homopolymer parameters and an IR Markov
    table that retains often), 25 transcripts with expression and polyA
    lists, and an intron-retention fixture with two '-' strand structures."""
    from nanosim_tpu.profiles import error_model, fixtures

    d = str(tmp_path_factory.mktemp("trxmod"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=700, sd_read_len=200, transcriptome=True,
                            mean_2d_ref_len=1500, n_kde_points=300)
    error_model.write_ir_markov(prefix + "_IR_markov_model",
                                np.array([[0.5, 0.5], [0.5, 0.5], [0.3, 0.7]]))
    # transcripts with long homopolymer runs, so that `-hp -k 6` fires
    trx_fa = os.path.join(d, "trx.fa")
    lengths = [1500 + 97 * i for i in range(25)]
    fixtures.make_reference_fasta(trx_fa, lengths, seed=3, name_prefix="ENST", hp_bias=0.5)
    trxs = [(f"ENST{i + 1}", n) for i, n in enumerate(lengths)]
    exp = os.path.join(d, "exp.tsv")
    fixtures.make_expression_tsv(exp, trxs, seed=4)
    polya = os.path.join(d, "polya.txt")
    with open(polya, "w") as f:
        f.write("".join(n + "\n" for n, _ in trxs[:12]))
    ird = os.path.join(d, "ir")
    genome_fa, ir_trx_fa, gff, ir_trxs = fixtures.make_ir_fixture(ird, n_transcripts=10, seed=7)
    _flip_strands(gff, {ir_trxs[1][0], ir_trxs[4][0]})
    ir_exp = os.path.join(ird, "exp.tsv")
    fixtures.make_expression_tsv(ir_exp, ir_trxs, seed=8)
    os.symlink(gff, prefix + "_added_intron_final.gff3")
    return dict(prefix=prefix, trx=trx_fa, exp=exp, polya=polya, genome=genome_fa,
                ir_trx=ir_trx_fa, ir_exp=ir_exp)


def _sims(fx, ir: bool, perfect: bool = False, kmer_bias=None, uracil: bool = False,
          fastq: bool = True, polya: bool = True, exact_conditional: bool = False):
    """(JAX TranscriptomeSimulator, the port's on the CPU), same arguments."""
    from nanosim_tpu.io import PackedGenome as JG
    from nanosim_tpu.profiles import profile as jp
    from nanosim_tpu.sim.run_transcriptome import POLYA_SCALE
    from nanosim_tpu.sim.run_transcriptome import TranscriptomeSimulator as JS
    from nanosim_tpu_torch.io.genome import PackedGenome as TG
    from nanosim_tpu_torch.profiles import profile as tp
    from nanosim_tpu_torch.sim.run_transcriptome import TranscriptomeSimulator as TS

    trx, exp = (fx["ir_trx"], fx["ir_exp"]) if ir else (fx["trx"], fx["exp"])
    kw = dict(mode="transcriptome", perfect=perfect, fastq=fastq, model_ir=ir,
              homopolymer=kmer_bias is not None, polya_path=fx["polya"] if polya else None)
    out = []
    for G, P, S, extra in ((JG, jp, JS, {}), (TG, tp, TS, {"device": "cpu"})):
        g = G.from_fasta(trx)
        prof = P.load_profile(fx["prefix"], **kw)
        expr = P.load_expression(exp, dict(zip(g.names, (int(x) for x in g.lengths))))
        out.append(S(g, prof, expr, fastq=fastq, perfect=perfect, uracil=uracil,
                     polya_scale=POLYA_SCALE["guppy"] if polya else 0.0, model_ir=ir,
                     ir_genome=G.from_fasta(fx["genome"]) if ir else None, batch=B,
                     kmer_bias=kmer_bias, exact_conditional=exact_conditional, **extra))
    return out


def _keys(n=B, seed=SEED, start=0):
    import jax.numpy as jnp

    from nanosim_tpu.ops import rng as jr
    from nanosim_tpu_torch.ops import rng as tr

    slots = np.arange(start, start + n, dtype=np.int64)
    jsk = jr.slot_keys(jr.base_key(seed, jr.STREAM_ALIGNED), jnp.asarray(slots))
    tsk = tr.slot_keys(tr.base_key(seed, tr.STREAM_ALIGNED, device="cpu"), torch.as_tensor(slots))
    assert np.array_equal(np.asarray(jsk).astype(np.int64), tsk.numpy())
    return jsk, tsk


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    assert np.array_equal(a, b.astype(a.dtype) if a.dtype != b.dtype else b), what


def test_to_uracil_matches_jax():
    import jax.numpy as jnp

    from nanosim_tpu.ops import seqops as js
    from nanosim_tpu_torch.ops import seqops as ts

    seq = np.random.default_rng(1).integers(0, 256, (7, 300)).astype(np.uint8)
    seq[0, :8] = list(b"TtUuACGT")
    got = ts.to_uracil(torch.as_tensor(seq))
    assert got.dtype == torch.uint8
    _eq(js.to_uracil(jnp.asarray(seq)), got)
    assert bytes(got[0, :8].tolist()) == b"UuUuACGU"


def test_nearest_pool_draw_matches_jax_with_exact_ties():
    """Pools where two samples are exactly equally near the condition (a
    duplicated data row with equal normals, and samples mirrored around the
    condition): the first such sample wins in both."""
    import jax.numpy as jnp

    from nanosim_tpu.ops.tables import KdeDevice as JK
    from nanosim_tpu_torch.ops.tables import KdeDevice as TK

    rs = np.random.default_rng(5)
    n, K, Bn = 64, 256, 200
    data = np.stack([rs.integers(200, 4000, n), rs.integers(100, 3000, n)], 1).astype(np.float32)
    data[1] = data[0]
    bw = np.float32(1.0)
    comp = rs.random((Bn, K), dtype=np.float32)
    z0 = rs.standard_normal((Bn, K)).astype(np.float32)
    z1 = rs.standard_normal((Bn, K)).astype(np.float32)
    cond = rs.integers(200, 4000, Bn).astype(np.float32)
    # lanes 0-9: the two best samples come from the duplicated row with equal z0
    comp[:10, 3] = 0.0 / n + 1e-6
    comp[:10, 7] = 1.0 / n + 1e-6
    z0[:10, [3, 7]] = 0.0
    cond[:10] = data[0, 0]
    # lanes 10-19: samples at cond - 5 and cond + 5 (exact in float32), the
    # other samples of the pool far from it (row 5)
    data[5, 0] = 20000.0
    comp[10:20] = 5.0 / n + 1e-6
    comp[10:20, 2] = 2.0 / n + 1e-6
    comp[10:20, 9] = 2.0 / n + 1e-6
    z0[10:20, 2], z0[10:20, 9] = -5.0, 5.0
    cond[10:20] = data[2, 0]
    jk = JK(data=jnp.asarray(data), bandwidth=jnp.float32(bw), log_transform=False)
    tk = TK(data=torch.as_tensor(data), bandwidth=torch.tensor(bw), log_transform=False)
    want = np.asarray(jk.sample_nearest_pool(jnp.asarray(cond), jnp.asarray(comp),
                                             jnp.asarray(z0), jnp.asarray(z1)))
    got = tk.sample_nearest_pool(torch.as_tensor(cond), torch.as_tensor(comp),
                                 torch.as_tensor(z0), torch.as_tensor(z1))
    _eq(want, got)
    # the tie lanes took the first sample (column 3, column 2)
    assert np.allclose(want[:10], data[0, 1] + z1[:10, 3])
    assert np.allclose(want[10:20], data[2, 1] + z1[10:20, 2])


def test_transcript_choice_ht_and_polya_match_jax(fx):
    import jax.numpy as jnp

    from nanosim_tpu.sim import transcriptome_mode as jt
    from nanosim_tpu_torch.sim import transcriptome_mode as tt

    js, ts = _sims(fx, ir=False)
    jsk, tsk = _keys(4000)
    w = np.random.default_rng(2).gamma(0.5, 1.0, 300)
    w[[3, 4, 100]] = 0.0  # repeated cumulative values: the left search
    cum = np.cumsum(w / w.sum())
    _eq(jt.pick_transcripts(jsk, jnp.asarray(cum)), tt.pick_transcripts(tsk, torch.as_tensor(cum)))
    for a, b in zip(jt.draw_ht_clamped(jsk, js.tables, js.ht_cap),
                    tt.draw_ht_clamped(tsk, ts.tables, ts.ht_cap)):
        _eq(a, b)
    retain = np.random.default_rng(3).random(4000) < 0.8
    for scale in (2.409858743694814, 4.168299657168961):
        _eq(jt.polya_length(jsk, jnp.asarray(retain), scale),
            tt.polya_length(tsk, torch.as_tensor(retain), scale))


def test_transcript_position_samplers_match_jax(fx):
    import jax.numpy as jnp

    from nanosim_tpu.sim import extract as je
    from nanosim_tpu_torch.sim import extract as te

    js, ts = _sims(fx, ir=False, polya=False)
    jsk, tsk = _keys(600)
    rs = np.random.default_rng(4)
    n_trx = js.genome_host.n_chrom
    trx = rs.integers(0, n_trx, 600).astype(np.int32)
    lens = js.genome_host.lengths[trx]
    mref = (lens * rs.uniform(0.1, 1.1, 600)).astype(np.int32)  # some longer than the transcript
    for a, b in zip(je.sample_transcript_positions(jsk, jnp.asarray(trx), jnp.asarray(mref),
                                                   js.genome_dev),
                    te.sample_transcript_positions(tsk, torch.as_tensor(trx),
                                                   torch.as_tensor(mref), ts.genome_dev)):
        _eq(a, b)
    ulen = rs.integers(50, int(lens.max()) + 500, 600).astype(np.int32)  # some too long for all
    for a, b in zip(je.sample_uniform_chrom_positions(jsk, jnp.asarray(ulen), js.genome_dev,
                                                      n_trx),
                    te.sample_uniform_chrom_positions(tsk, torch.as_tensor(ulen),
                                                      ts.genome_dev)):
        _eq(a, b)


def test_ir_tables_and_walk_match_jax(fx):
    """Every table and every output of the IR walk, on structures with '-'
    strands, from lanes of every eligible transcript."""
    import jax.numpy as jnp

    from nanosim_tpu.sim import ir as jir
    from nanosim_tpu_torch.sim import ir as tir

    js, ts = _sims(fx, ir=True)
    assert js.with_ir and ts.with_ir
    jt_, tt_ = js.ir_tables, ts.ir_tables
    assert jt_.f_max == tt_.f_max
    for f in ("feat_offset", "is_intron", "chrom", "start", "length", "n_feats", "strand_neg",
              "last_end", "ir_cum"):
        _eq(getattr(jt_, f), getattr(tt_, f), f)
    assert bool(np.asarray(tt_.strand_neg).any())
    n = 400
    jsk, tsk = _keys(n, seed=3)
    rs = np.random.default_rng(6)
    eli = np.asarray(js.trx_of_eligible)
    trx = eli[rs.integers(0, len(eli), n)].astype(np.int32)
    tlen = js.genome_host.lengths[trx].astype(np.int32)
    mref = (tlen * rs.uniform(0.2, 0.95, n)).astype(np.int32)
    l_cap = js.l_cap
    want = jir.ir_walk_and_extract(jsk, jnp.asarray(trx), jnp.asarray(mref), jnp.asarray(tlen),
                                   jt_, js.ir_genome_dev, l_cap)
    got = tir.ir_walk_and_extract(tsk, torch.as_tensor(trx), torch.as_tensor(mref),
                                  torch.as_tensor(tlen), tt_, ts.ir_genome_dev, l_cap)
    names = ("seg", "rep_pos", "extracted_len", "has_ir", "ir_intervals", "n_ir", "reach_end",
             "feat_start", "feat_take")
    for nm, a, b in zip(names, want, got):
        _eq(a, b, nm)
    has_ir = np.asarray(want[3])
    neg = np.asarray(jt_.strand_neg)[trx]
    assert has_ir.sum() > 50 and (has_ir & neg).sum() > 5


BRANCHES = {  # id -> (ir, emit_reads, simulator options)
    "meta": (False, False, {}),
    "meta-ir": (True, False, {}),
    "meta-perfect": (False, False, {"perfect": True}),
    "emit-uracil": (False, True, {"uracil": True}),
    "emit-hp": (False, True, {"kmer_bias": 6}),
    "emit-perfect": (False, True, {"perfect": True}),
    "emit-ir": (True, True, {}),
    "meta-exact": (False, False, {"exact_conditional": True}),
    "emit-exact-ir": (True, True, {"exact_conditional": True}),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_transcriptome_batch_matches_jax(fx, branch):
    """Every output of the batch program, for two batches of slots."""
    import jax.numpy as jnp

    from nanosim_tpu.ops import rng as jr
    from nanosim_tpu.sim import transcriptome_mode as jt
    from nanosim_tpu_torch.ops import rng as tr

    ir, emit, opts = BRANCHES[branch]
    js, ts = _sims(fx, ir=ir, **opts)
    jfn = functools.partial(
        jt.transcriptome_batch, genome=js.genome_dev, tables=js.tables,
        cum_weights=js.cum_weights, trx_of_eligible=js.trx_of_eligible,
        polya_mask=js.polya_mask, ir_tables=js.ir_tables, ir_genome=js.ir_genome_dev,
        emit_reads=emit, **js.kw)
    tfn = ts.batch_fn(emit_reads=emit)
    jbase = jr.base_key(SEED, jr.STREAM_ALIGNED)
    tbase = tr.base_key(SEED, tr.STREAM_ALIGNED, device="cpu")
    n_valid = 0
    for start in (0, B):
        slots = np.arange(start, start + B, dtype=np.int64)
        want = jfn(jbase, jnp.asarray(slots))
        got = tfn(tbase, torch.as_tensor(slots))
        live = (np.arange(got.ev_pos2x.shape[1])[None, :]
                < got.n_events.numpy()[:, None])
        for name, g in got._asdict().items():
            if g is None:  # the meta-only program moves no read rows
                continue
            w = getattr(want, name)
            if name.startswith("ev_") and name != "ev_cksum":
                # events are defined on each lane's prefix only
                w, g = np.where(live, w, 0), np.where(live, g.numpy(), 0)
            _eq(w, g, name)
        n_valid += int(got.valid.sum())
        if ir:
            n_ir = int(got.has_ir.sum())
            assert n_ir > 5
    assert n_valid > B


def test_pack_trx_meta_matches_jax(fx):
    import jax.numpy as jnp

    from nanosim_tpu.ops import rng as jr
    from nanosim_tpu.sim import transcriptome_mode as jt
    from nanosim_tpu_torch.ops import rng as tr
    from nanosim_tpu_torch.sim import transcriptome_mode as tt

    js, ts = _sims(fx, ir=True)
    slots = np.arange(B, dtype=np.int64)
    jfn = functools.partial(
        jt.transcriptome_batch, genome=js.genome_dev, tables=js.tables,
        cum_weights=js.cum_weights, trx_of_eligible=js.trx_of_eligible,
        polya_mask=js.polya_mask, ir_tables=js.ir_tables, ir_genome=js.ir_genome_dev,
        emit_reads=False, **js.kw)
    jo = jfn(jr.base_key(SEED, jr.STREAM_ALIGNED), jnp.asarray(slots))
    to = ts.batch_fn(emit_reads=False)(tr.base_key(SEED, tr.STREAM_ALIGNED, device="cpu"),
                                       torch.as_tensor(slots))
    jirc = js.ir_tables.chrom[js.ir_tables.feat_offset[jo.trx]]
    tirc = ts.ir_tables.chrom[ts.ir_tables.feat_offset[to.trx.long()].long()]
    want = np.asarray(jt.pack_trx_meta(jo, jirc))
    got = tt.pack_trx_meta(to, tirc)
    _eq(want, got)
    d = tt.decode_trx_meta(got.numpy(), min(16, ts.ir_tables.f_max), ts.ir_tables.f_max)
    assert d["has_ir"].any() and (d["feat_take"].sum(axis=1) >= 0).all()
