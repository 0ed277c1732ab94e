"""Multi-host runs of the port (`--num_hosts`): per-host shard files merge to
the single-host output, and each shard is the JAX package's shard, byte for
byte.

The cases of tests/test_multihost.py, against the port's single-host run
(ranks emulated in one process): four hosts merge to the single-host
output with gapless numbering, the shards are disjoint, and the chimeric
genome, transcriptome, metagenome (with the species-quota feedback) and
unaligned passes merge to their single-host outputs.  Then every shard of
genome (linear and circular), chimeric genome, the unaligned pass,
transcriptome and chimeric metagenome runs against the JAX package's shard
for the same host count, seed and batch (JAX on its virtual CPU devices,
one device a host), and two and four ranks as as many processes joined by a
gloo process group against the emulated ranks (the four merged against the
single-host run), and a rank's card made current before its first launch.
Small fixtures: one 30 kb chromosome, batches of 64.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from nanosim_tpu_torch import parallel
from nanosim_tpu_torch.sim import output as tout

from test_torch_common import make_metagenome_fixture, read_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = "Seq_name\tSeq_pos\terror_type\terror_length\tref_base\tseq_base\n"


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """A model (and a chimeric one, segment mean 1.6), one 30 kb chromosome,
    a transcriptome with expression, and the metagenome fixture of
    tests/test_metagenome.py."""
    from nanosim_tpu.profiles import error_model, fixtures

    d = str(tmp_path_factory.mktemp("torch_mh"))
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=300, sd_read_len=100)
    cprefix = os.path.join(d, "ctraining")
    fixtures.make_model_dir(cprefix, mean_read_len=300, sd_read_len=100)
    error_model.write_chimeric_info(cprefix + "_chimeric_info", 1.6, 0.2)
    ref = os.path.join(d, "ref.fa")
    fixtures.make_reference_fasta(ref, [30000], seed=7)
    hp_ref = os.path.join(d, "hp_ref.fa")  # long runs: suppression and resizing fire
    fixtures.make_reference_fasta(hp_ref, [30000], seed=7, hp_bias=0.6)
    tprefix = os.path.join(d, "ttraining")
    fixtures.make_model_dir(tprefix, mean_read_len=500, sd_read_len=150, transcriptome=True,
                            mean_2d_ref_len=1200)
    trx = os.path.join(d, "trx.fa")
    trxs = fixtures.make_transcript_reference(trx, n_transcripts=20, mean_len=1500, seed=3)
    exp = os.path.join(d, "exp.tsv")
    fixtures.make_expression_tsv(exp, trxs, seed=4)
    os.makedirs(os.path.join(d, "meta"))
    meta = make_metagenome_fixture(os.path.join(d, "meta"))
    return dict(d=d, prefix=prefix, cprefix=cprefix, ref=ref, hp_ref=hp_ref, tprefix=tprefix,
                trx=trx, exp=exp, meta=meta)


def _records(path):
    """[(name, seq, qual or None)] of a FASTA/FASTQ file."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return []
    if lines[0].startswith("@"):
        return [(lines[i][1:], lines[i + 1], lines[i + 3]) for i in range(0, len(lines), 4)]
    return [(lines[i][1:], lines[i + 1], None) for i in range(0, len(lines), 2)]


def _index(name: str) -> int:
    """A read's sequence number: the token after aligned/perfect/unaligned."""
    toks = name.replace(";", "_").split("_")
    for i, t in enumerate(toks):
        if t in ("aligned", "perfect", "unaligned"):
            return int(toks[i + 1])
    raise AssertionError(name)


def _sorted_records(path):
    return sorted(_records(path), key=lambda r: _index(r[0]))


def _err_rows(path, header=True):
    rows = {}
    with open(path) as f:
        if header:
            assert f.readline() == HEADER
        for line in f:
            rows.setdefault(line.split("\t", 1)[0], []).append(line)
    return rows


def _merge(out: str, shards, suffix: str, header: str = "") -> str:
    path = out + "_merged" + suffix
    parallel.merge_host_shards(path, [s + suffix for s in shards], header=header)
    return path


def _assert_merged_equal(flat: str, shards, suffix: str, gapless: bool = True) -> None:
    merged = _merge(flat, shards, suffix)
    a, b = _sorted_records(flat + suffix), _sorted_records(merged)
    assert [r[0] for r in a] == [r[0] for r in b]
    assert [r[1:] for r in a] == [r[1:] for r in b]
    if gapless:
        assert [_index(r[0]) for r in b] == list(range(len(b)))


def _genome(out, n, **kw):
    from nanosim_tpu_torch.sim.run import simulate_genome

    tout.RUN_STATS.reset()
    got = simulate_genome(kw.pop("ref"), kw.pop("prefix"), out, n, seed=kw.pop("seed", 11),
                          batch=64, device="cpu", **kw)
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return got


@pytest.fixture(scope="module")
def four_hosts(fx):
    """A genome run (FASTQ, error profile, unaligned pass), single-host and
    as four emulated hosts: (flat prefix, [shard prefixes])."""
    d = fx["d"]
    flat = os.path.join(d, "flat")
    _genome(flat, 200, ref=fx["ref"], prefix=fx["prefix"], fastq=True)
    shards = []
    for h in range(4):
        out = os.path.join(d, "four")
        _genome(out, 200, ref=fx["ref"], prefix=fx["prefix"], fastq=True, n_hosts=4, host_id=h)
        shards.append(out)
    return flat, shards


def test_four_hosts_merge_equals_single(four_hosts):
    flat, shards = four_hosts
    tags = [s + f"_aligned_reads_h{h}" for h, s in enumerate(shards)]
    merged = shards[0] + "_merged_aligned_reads.fastq"
    parallel.merge_host_shards(merged, [t + ".fastq" for t in tags])
    a, b = _sorted_records(flat + "_aligned_reads.fastq"), _sorted_records(merged)
    assert len(a) > 100
    assert a == b
    assert [_index(r[0]) for r in b] == list(range(len(b)))  # gapless 0..n-1
    # the error profile: host 0 writes the header, rows grouped by read agree
    errs = [s + f"_aligned_error_profile_h{h}" for h, s in enumerate(shards)]
    assert read_file(errs[0]).startswith(HEADER.encode())
    assert not any(read_file(e).startswith(HEADER.encode()) for e in errs[1:])
    merged_err = shards[0] + "_merged_error_profile"
    parallel.merge_host_shards(merged_err, errs)
    assert _err_rows(flat + "_aligned_error_profile") == _err_rows(merged_err)
    # the unaligned pass is sharded too
    ushards = [s + f"_unaligned_reads_h{h}.fastq" for h, s in enumerate(shards)]
    umerged = shards[0] + "_merged_unaligned.fastq"
    parallel.merge_host_shards(umerged, ushards)
    ua, ub = _sorted_records(flat + "_unaligned_reads.fastq"), _sorted_records(umerged)
    assert len(ua) > 5 and ua == ub


def test_host_shards_are_disjoint(four_hosts):
    _, shards = four_hosts
    seen = set()
    sizes = []
    for h, s in enumerate(shards):
        names = [r[0] for r in _records(s + f"_aligned_reads_h{h}.fastq")]
        sizes.append(len(names))
        for name in names:
            assert name not in seen
            seen.add(name)
    assert len(seen) == sum(sizes) and min(sizes) > 0


def _port_runner(kind, sim, H, h):
    cls = {"mode": parallel.MultiHostModeRunner,
           "meta": parallel.MultiHostMetagenomeRunner}[kind]
    return cls(sim, n_hosts=H, host_id=h)


def test_multihost_chimeric_genome(fx):
    """Chimeric genome mode: 2 emulated hosts == single host."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.chimeric_mode import ChimericGenomeSimulator

    d = fx["d"]
    genome = PackedGenome.from_fasta(fx["ref"])
    prof = profile.load_profile(fx["cprefix"], mode="genome", chimeric=True)
    quota, seed = 90, 13

    def sim():
        return ChimericGenomeSimulator(genome, prof, batch=64, device="cpu")

    def run(out, runner=None):
        fw = tout.FastxWriter(out + ".fasta", False)
        el = tout.ErrorLogWriter(out + "_err", header=runner is None)
        w = tout.ChimericBatchWriter(fw, el)
        got = (runner or sim()).run(quota, w, seed=seed)
        fw.close()
        el.close()
        return got

    flat = os.path.join(d, "cflat")
    assert run(flat) == quota
    shards = [os.path.join(d, f"cshard{h}") for h in range(2)]
    written = [run(s, _port_runner("mode", sim(), 2, h)) for h, s in enumerate(shards)]
    assert sum(written) == quota
    _assert_merged_equal(flat, shards, ".fasta")
    assert b"_chimeric" in read_file(flat + ".fasta")  # not vacuous
    merged_err = _merge(flat, shards, "_err")
    assert _err_rows(flat + "_err") == _err_rows(merged_err, header=False)


def test_multihost_transcriptome(fx):
    """Transcriptome mode: 2 emulated hosts == single host."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.run_transcriptome import TranscriptomeSimulator, TrxBatchWriter

    d = fx["d"]
    trx = PackedGenome.from_fasta(fx["trx"])
    prof = profile.load_profile(fx["tprefix"], mode="transcriptome", model_ir=False)
    expr = profile.load_expression(fx["exp"], dict(zip(trx.names, (int(x) for x in trx.lengths))))
    quota, seed = 80, 9

    def sim():
        return TranscriptomeSimulator(trx, prof, expr, model_ir=False, batch=64, device="cpu")

    def run(out, runner=None):
        fw = tout.FastxWriter(out + ".fasta", False)
        el = tout.ErrorLogWriter(out + "_err", header=runner is None)
        got = (runner or sim()).run(quota, TrxBatchWriter(fw, el), seed=seed)
        fw.close()
        el.close()
        return got

    flat = os.path.join(d, "tflat")
    assert run(flat) == quota
    shards = [os.path.join(d, f"tshard{h}") for h in range(2)]
    assert sum(run(s, _port_runner("mode", sim(), 2, h)) for h, s in enumerate(shards)) == quota
    _assert_merged_equal(flat, shards, ".fasta")
    assert _err_rows(flat + "_err") == _err_rows(_merge(flat, shards, "_err"), header=False)


def test_multihost_metagenome(fx):
    """Metagenome (chimeric) mode: 2 emulated hosts == single host, the
    species-quota feedback summed over the ranks."""
    from nanosim_tpu_torch.io.genome import MetagenomeSet
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.run_metagenome import MetagenomeSimulator

    m = fx["meta"]
    mset = MetagenomeSet.from_genome_list(m.glist, m.dl)
    prof = profile.load_profile(m.prefix, mode="metagenome", chimeric=True)
    abun = {"Escherichia_coli": 60.0, "Bacillus_subtilis": 30.0, "Salmonella_enterica": 10.0}
    quota, seed = 100, 5

    def sim():
        return MetagenomeSimulator(mset, prof, abun, chimeric=True, batch=64, device="cpu")

    def run(out, runner=None):
        fw = tout.FastxWriter(out + ".fasta", False)
        el = tout.ErrorLogWriter(out + "_err")
        w = tout.ChimericBatchWriter(fw, el, species_names=mset.species_names,
                                     species_of_chrom=mset.species_of_chrom, metagenome=True)
        s = sim() if runner is None else runner.sim
        w.species_bases = s.current_bases
        got = (runner or s).run(quota, w, seed=seed)
        fw.close()
        el.close()
        return got, s.current_bases

    flat = os.path.join(m.d, "mflat")
    got, _ = run(flat)
    assert got == quota
    shards = [os.path.join(m.d, f"mshard{h}") for h in range(2)]
    res = [run(s, _port_runner("meta", sim(), 2, h)) for h, s in enumerate(shards)]
    assert sum(r[0] for r in res) == quota
    # every rank advanced the same quota state
    np.testing.assert_array_equal(res[0][1], res[1][1])
    assert (res[0][1] > 0).sum() == 3
    _assert_merged_equal(flat, shards, ".fasta")
    assert _err_rows(flat + "_err", header=False) == _err_rows(_merge(flat, shards, "_err"),
                                                                header=False)


def test_multihost_unaligned(fx):
    """Unaligned pass: 2 emulated hosts == single host."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

    d = fx["d"]
    genome = PackedGenome.from_fasta(fx["ref"])
    prof = profile.load_profile(fx["prefix"], mode="genome")
    quota, seed = 60, 17

    def run(out, runner=None):
        fw = tout.FastxWriter(out + ".fasta", False)
        sim = UnalignedSimulator(genome, prof, batch=64, device="cpu")
        got = (runner(sim) if runner else sim).run(quota, UnalignedBatchWriter(fw), seed=seed)
        fw.close()
        return got

    flat = os.path.join(d, "uflat")
    assert run(flat) == quota
    shards = [os.path.join(d, f"ushard{h}") for h in range(2)]
    written = [run(s, lambda sim, h=h: _port_runner("mode", sim, 2, h))
               for h, s in enumerate(shards)]
    assert sum(written) == quota
    _assert_merged_equal(flat, shards, ".fasta")


# --- every shard against the JAX package's shard ---------------------------

GENOME_SUFFIXES = ("_aligned_reads{t}{ext}", "_aligned_error_profile{t}", "_unaligned_reads{t}{ext}")


def _same_shards(a: str, b: str, suffixes, h: int, fastq: bool) -> int:
    """Compare the files of host h of the JAX run `a` and the port's run `b`;
    returns the number of records in the aligned shard."""
    ext = ".fastq" if fastq else ".fasta"
    n = 0
    for suf in suffixes:
        path = suf.format(t=f"_h{h}", ext=ext)
        if not os.path.exists(a + path):
            assert not os.path.exists(b + path), path
            continue
        assert read_file(a + path) == read_file(b + path), path
        if "aligned_reads" in path and "unaligned" not in path:
            n = len(_records(b + path))
    return n


@pytest.fixture
def jax_mesh_of(monkeypatch):
    """Make the JAX runners' default mesh one virtual CPU device a host."""
    from nanosim_tpu.parallel import mesh, multihost

    def use(H):
        monkeypatch.setattr(multihost, "make_mesh", lambda n=None, axis="data":
                            mesh.make_mesh(H, axis))

    return use


GENOME_CASES = {  # id -> (model, reference, reads, options, NANOSIM_TPU_RECON)
    "linear": ("prefix", "ref", 200, dict(fastq=True), None),
    "circular": ("prefix", "ref", 150, dict(dna_type="circular"), None),
    "chimeric": ("cprefix", "ref", 120, dict(chimeric=True, fastq=True), None),
    # the read-emitting chimeric program: its segment-major event rows
    # (ev_row = s*B + lane) laid out for the shard's own B/H lanes
    "chimeric-recon0": ("cprefix", "ref", 120, dict(chimeric=True, fastq=True), "0"),
    # -hp -k 6 on the host reconstruction and on the read-emitting program
    "hp": ("prefix", "hp_ref", 200, dict(fastq=True, kmer_bias=6), None),
    "hp-recon0": ("prefix", "hp_ref", 200, dict(fastq=True, kmer_bias=6), "0"),
}


@pytest.mark.parametrize("case", sorted(GENOME_CASES))
def test_genome_shards_equal_jax(fx, jax_mesh_of, monkeypatch, case):
    """simulate_genome with n_hosts=2 (linear, circular, chimeric and -hp
    on both routes): each host's aligned reads, error profile and unaligned
    reads equal the JAX package's shard."""
    from nanosim_tpu.sim.run import simulate_genome as jax_simulate_genome

    model, ref, n, opts, recon = GENOME_CASES[case]
    if recon is not None:
        monkeypatch.setenv("NANOSIM_TPU_RECON", recon)
    H = 2
    jax_mesh_of(H)
    d = fx["d"]
    total = 0
    for h in range(H):
        a = os.path.join(d, f"jax_{case}")
        b = os.path.join(d, f"torch_{case}")
        jax_simulate_genome(fx[ref], fx[model], a, n, seed=21, batch=64, n_hosts=H,
                            host_id=h, homopolymer="kmer_bias" in opts, **opts)
        _genome(b, n, ref=fx[ref], prefix=fx[model], seed=21, n_hosts=H, host_id=h, **opts)
        total += _same_shards(a, b, GENOME_SUFFIXES, h, opts.get("fastq", False))
    assert total > n // 2  # the aligned share of n, split over the hosts


def test_unaligned_shards_equal_jax(fx, jax_mesh_of):
    """The unaligned pass alone (FASTQ), four hosts: the runner's shards
    equal the JAX runner's on STREAM_UNALIGNED."""
    from nanosim_tpu.io import PackedGenome as JaxGenome
    from nanosim_tpu.ops import rng as jax_rng
    from nanosim_tpu.parallel import MultiHostModeRunner as JaxModeRunner
    from nanosim_tpu.parallel import make_mesh
    from nanosim_tpu.profiles import profile as jax_profile
    from nanosim_tpu.sim import output as jax_out
    from nanosim_tpu.sim.unaligned_mode import UnalignedBatchWriter as JaxWriter
    from nanosim_tpu.sim.unaligned_mode import UnalignedSimulator as JaxSim
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

    H, quota, seed = 4, 90, 23
    d = fx["d"]
    jg, tg = JaxGenome.from_fasta(fx["ref"]), PackedGenome.from_fasta(fx["ref"])
    jp = jax_profile.load_profile(fx["prefix"], mode="genome", fastq=True)
    tp = profile.load_profile(fx["prefix"], mode="genome", fastq=True)
    total = 0
    for h in range(H):
        a, b = os.path.join(d, f"jax_u{h}.fastq"), os.path.join(d, f"torch_u{h}.fastq")
        fw = jax_out.FastxWriter(a, True)
        JaxModeRunner(JaxSim(jg, jp, fastq=True, batch=64), H, h, mesh=make_mesh(H),
                      stream=jax_rng.STREAM_UNALIGNED).run(quota, JaxWriter(fw), seed=seed)
        fw.close()
        fw = tout.FastxWriter(b, True)
        total += parallel.MultiHostModeRunner(
            UnalignedSimulator(tg, tp, fastq=True, batch=64, device="cpu"), H, h).run(
            quota, UnalignedBatchWriter(fw), seed=seed)
        fw.close()
        assert read_file(a) == read_file(b)
    assert total == quota


def test_transcriptome_shards_equal_jax(fx, jax_mesh_of):
    """simulate_transcriptome with n_hosts=2 (FASTQ): each host's aligned
    shards equal the JAX package's; host 0 alone writes the unaligned pass."""
    from nanosim_tpu.sim.run_transcriptome import simulate_transcriptome as jax_run
    from nanosim_tpu_torch.sim.run_transcriptome import simulate_transcriptome

    H, n = 2, 120
    jax_mesh_of(H)
    d = fx["d"]
    a, b = os.path.join(d, "jax_trx"), os.path.join(d, "torch_trx")
    total = 0
    for h in range(H):
        args = (fx["trx"], "", fx["exp"], fx["tprefix"])
        kw = dict(number=n, seed=31, batch=64, fastq=True, model_ir=False, n_hosts=H, host_id=h)
        jax_run(*args, a, **kw)
        simulate_transcriptome(*args, b, device="cpu", **kw)
        total += _same_shards(a, b, ("_aligned_reads{t}{ext}", "_aligned_error_profile{t}"),
                              h, True)
    assert total > n // 2
    assert read_file(a + "_unaligned_reads.fastq") == read_file(b + "_unaligned_reads.fastq")


@pytest.mark.parametrize("recon", [None, "0"], ids=["route-a", "recon0"])
def test_metagenome_shards_equal_jax(fx, jax_mesh_of, monkeypatch, recon):
    """simulate_metagenome --chimeric with n_hosts=2 over two samples, on the
    reconstruction route and the read-emitting program: each host's shards of
    each sample equal the JAX package's (the per-species feedback summed over
    the ranks); host 0 writes the unaligned passes."""
    from nanosim_tpu.sim.run_metagenome import simulate_metagenome as jax_run
    from nanosim_tpu_torch.sim.run_metagenome import simulate_metagenome

    if recon is not None:
        monkeypatch.setenv("NANOSIM_TPU_RECON", recon)
    m = fx["meta"]
    H = 2
    jax_mesh_of(H)
    tag = recon or ""
    a, b = os.path.join(m.d, "jax_meta" + tag), os.path.join(m.d, "torch_meta" + tag)
    total = 0
    for h in range(H):
        kw = dict(seed=3, batch=64, chimeric=True, n_hosts=H, host_id=h)
        jax_run(m.glist, m.abun, m.dl, m.prefix, a, **kw)
        simulate_metagenome(m.glist, m.abun, m.dl, m.prefix, b, device="cpu", **kw)
        for sample in ("_sample0", "_sample1"):
            total += _same_shards(a + sample, b + sample,
                                  ("_aligned_reads{t}{ext}", "_aligned_error_profile{t}"), h,
                                  False)
    assert total > 150  # most of the 200 reads are aligned
    for sample in ("_sample0", "_sample1"):
        path = sample + "_unaligned_reads.fasta"
        assert read_file(a + path) == read_file(b + path)


# --- ranks as processes ------------------------------------------------------

RANK_SCRIPT = """
import sys
import torch
torch.set_num_threads(1)
from nanosim_tpu_torch.parallel import init_distributed
mode, out, host_id, coordinator = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
n_hosts = int(sys.argv[5])
init_distributed(coordinator, n_hosts, host_id, timeout_s=120)
if mode == "genome":
    from nanosim_tpu_torch.sim.run import simulate_genome
    simulate_genome(sys.argv[6], sys.argv[7], out, 200, fastq=True, seed=11, batch=64,
                    n_hosts=n_hosts, host_id=host_id, coordinator=coordinator, device="cpu")
else:
    from nanosim_tpu_torch.sim.run_metagenome import simulate_metagenome
    simulate_metagenome(sys.argv[6], sys.argv[7], sys.argv[8], sys.argv[9], out, seed=3,
                        batch=64, chimeric=True, n_hosts=2, host_id=host_id,
                        coordinator=coordinator, device="cpu")
"""

JOIN_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_ranks(mode: str, out: str, args, n_hosts: int = 2) -> None:
    """Run the ranks as n_hosts processes; kill them all and fail if any has
    not exited after JOIN_TIMEOUT_S."""
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, mode, out, str(h), coordinator,
                               str(n_hosts), *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for h in range(n_hosts)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_two_gloo_ranks_equal_the_emulated_ranks(fx, four_hosts, n_hosts):
    """simulate_genome(n_hosts=2 or 4, coordinator=...) in as many processes:
    the shards equal those of the same run with the ranks emulated, and the
    four ranks' shards, merged, the single-host run's files record for
    record."""
    d = fx["d"]
    b = os.path.join(d, f"gloo{n_hosts}")
    _gloo_ranks("genome", b, [fx["ref"], fx["prefix"]], n_hosts)
    if n_hosts == 4:
        flat, emulated = four_hosts
        e = emulated[0]
    else:
        e = os.path.join(d, "emulated2")
        for h in range(2):
            _genome(e, 200, ref=fx["ref"], prefix=fx["prefix"], fastq=True, n_hosts=2, host_id=h)
    total = 0
    for h in range(n_hosts):
        total += _same_shards(e, b, GENOME_SUFFIXES, h, True)
    assert total > 100
    if n_hosts == 4:
        for kind in ("_aligned_reads", "_unaligned_reads"):
            merged = f"{b}_merged{kind}.fastq"
            parallel.merge_host_shards(merged, [f"{b}{kind}_h{h}.fastq" for h in range(4)])
            assert _sorted_records(flat + kind + ".fastq") == _sorted_records(merged)
        merged = b + "_merged_error_profile"
        parallel.merge_host_shards(merged, [f"{b}_aligned_error_profile_h{h}" for h in range(4)])
        assert _err_rows(flat + "_aligned_error_profile") == _err_rows(merged)


def test_two_gloo_ranks_metagenome_equal_the_emulated_ranks(fx):
    """simulate_metagenome --chimeric over two samples in two processes (the
    ranks join the group once and re-enter it per sample; the per-species
    bases are summed over the group): the shards equal the emulated ranks'."""
    from nanosim_tpu_torch.sim.run_metagenome import simulate_metagenome

    m = fx["meta"]
    b = os.path.join(m.d, "gloo_meta")
    _gloo_ranks("metagenome", b, [m.glist, m.abun, m.dl, m.prefix])
    e = os.path.join(m.d, "emulated_meta")
    for h in range(2):
        simulate_metagenome(m.glist, m.abun, m.dl, m.prefix, e, seed=3, batch=64, chimeric=True,
                            n_hosts=2, host_id=h, device="cpu")
    for sample in ("_sample0", "_sample1"):
        for h in range(2):
            assert _same_shards(e + sample, b + sample,
                                ("_aligned_reads{t}{ext}", "_aligned_error_profile{t}"), h,
                                False) > 10
        path = sample + "_unaligned_reads.fasta"
        assert read_file(e + path) == read_file(b + path)


# --- the pieces ---------------------------------------------------------------


def test_batch_must_divide_over_the_hosts(fx):
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator

    sim = GenomeSimulator(PackedGenome.from_fasta(fx["ref"]),
                          profile.load_profile(fx["prefix"], mode="genome"), batch=60,
                          device="cpu")
    with pytest.raises(ValueError, match="batch 60 not divisible by 8 devices"):
        parallel.MultiHostModeRunner(sim, n_hosts=8, host_id=0, full_events=True)
    with pytest.raises(ValueError, match="not a rank"):
        parallel.HostGroup(2, 2)


def test_shard_steps_number_like_one_host():
    """shard_sim_batch_numbered on a toy batch function:
    every rank's shard, the exclusive prefix of the counts and the total
    (with a summed per-shard vector), and each shard computed as its own
    call of B/H slots."""
    from types import SimpleNamespace

    calls = []

    def batch_fn(slots, weights):
        calls.append(len(slots))
        return SimpleNamespace(valid=np.asarray((slots % 3 == 0) & (weights > 0)), slots=slots)

    def count(out):
        return int(out.valid.sum())

    slots = np.arange(100, 124, dtype=np.int64)
    weights = np.ones(24)
    weights[:3] = 0
    want = (slots % 3 == 0) & (weights > 0)
    for H in (1, 2, 4):
        for h in range(H):
            step = parallel.shard_sim_batch_numbered(
                batch_fn, parallel.HostGroup(H, h), count,
                reduce=lambda o: np.array([o.valid.sum(), len(o.slots)], np.int64))
            calls.clear()
            out, offsets, total, summed = step(slots, weights)
            s = 24 // H
            assert calls == [s] * H
            np.testing.assert_array_equal(out.slots, slots[h * s:(h + 1) * s])
            assert offsets[h] == want[: h * s].sum() and total == want.sum()
            np.testing.assert_array_equal(summed, [want.sum(), 24])


def test_init_distributed_is_a_no_op_for_one_process():
    import torch.distributed as dist

    parallel.init_distributed("127.0.0.1:1", 1, 0)
    parallel.init_distributed(None, None, None)
    assert not dist.is_initialized()


def test_a_rank_makes_its_card_current_before_its_first_launch(fx, monkeypatch):
    """simulate_genome's multi-rank branch with the card calls monkeypatched
    (four cards, card 0 current): rank h builds its simulator, whose
    construction is its first device work, on card h with card h current,
    so that the kernels' launchers launch on the card of their stream."""
    import torch

    from nanosim_tpu_torch.sim import run as trun

    current = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.__setitem__(0, torch.device(d).index))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])

    class Built(Exception):
        pass

    seen = []

    def simulator(genome, prof, *, device, **kwargs):
        seen.append((torch.device(device), torch.cuda.current_device()))
        raise Built

    monkeypatch.setattr(trun, "GenomeSimulator", simulator)
    for h in (2, 1, 3, 0):
        with pytest.raises(Built):
            trun.simulate_genome(fx["ref"], fx["prefix"], os.path.join(fx["d"], "cards"), 20,
                                 n_hosts=4, host_id=h, device="cuda")
        assert seen[-1] == (torch.device("cuda", h), h)


def test_rank_device():
    import torch

    assert parallel.rank_device("cpu", 3) == torch.device("cpu")
    assert parallel.rank_device(torch.device("cuda", 1), 0) == torch.device("cuda", 1)
    if not torch.cuda.is_available():  # a plain "cuda" stays the card, which then raises
        assert parallel.rank_device("cuda", 1) == torch.device("cuda")
