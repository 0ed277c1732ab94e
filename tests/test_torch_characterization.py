"""The port's model-fitting commands (`characterize`, `quantify`,
`quantify_paf`) against the JAX package's, byte for byte.

The inputs are made once per module.  Genome reads are simulated by the port
on the CPU at the JAX round trip's size (700 aligned + 78 unaligned reads,
mean 800), with an alignment SAM built from the simulator's own ground truth
(tests/test_characterization.py's builder, profiles.fixtures.
build_sam_from_ground_truth in the port); a few read pairs are joined into
chimeric reads with SA-tagged supplementary records.  The
metagenome reads come from two species the same way.  The transcriptome is a
synthetic annotated one (profiles.fixtures.make_transcriptome_alignments,
on make_ir_fixture's structures) with reads drawn from a seeded numpy
generator: spliced (`N`) genome alignments, retained
introns, secondary transcriptome alignments and unaligned reads.

Each case runs the JAX function and the port's into separate directories:
every text file must be the same bytes, and every `*.pkl` (a length KDE)
must hold bit-equal data and an equal bandwidth as both packages' `load_kde`
read it.  The port writes a plain pickle where the JAX package writes
sklearn's object through joblib; each loader reads the other's file.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nanosim_tpu_torch.io.fastx import read_fastx
from nanosim_tpu_torch.io.genome import PackedGenome
from nanosim_tpu_torch.profiles import fixtures
from nanosim_tpu_torch.profiles import profile as tprofile
from nanosim_tpu_torch.sim import output as out_mod
from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator
from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def simulate_with_truth(d, ref_fa, prefix, n_aligned, n_unaligned, seed, tag):
    """(reads FASTQ, ground-truth SAM): the port's genome simulator on the
    CPU, aligned and unaligned reads in one file."""
    from nanosim_tpu_torch.io.fastx import mangle_name

    genome = PackedGenome.from_fasta(ref_fa)
    raw = {mangle_name(n): n for n, _, _ in read_fastx(ref_fa)}
    prof = tprofile.load_profile(prefix, mode="genome", fastq=True)
    al, un, err = (os.path.join(d, f"{tag}_{s}") for s in ("al.fastq", "un.fastq", "err"))
    sim = GenomeSimulator(genome, prof, fastq=True, batch=256, device="cpu")
    fw = out_mod.FastxWriter(al, True)
    el = out_mod.ErrorLogWriter(err)
    assert sim.run(n_aligned, out_mod.GenomeBatchWriter(fw, el), seed=seed) == n_aligned
    fw.close()
    el.close()
    usim = UnalignedSimulator(genome, prof, fastq=True, batch=256, device="cpu")
    ufw = out_mod.FastxWriter(un, True)
    assert usim.run(n_unaligned, UnalignedBatchWriter(ufw), seed=seed) == n_unaligned
    ufw.close()
    records = list(read_fastx(al)) + list(read_fastx(un))
    errors = {}
    with open(err) as f:
        for line in f:
            nm, key, et, elen, rb, sb = line.rstrip("\n").split("\t")
            errors.setdefault(nm, []).append((int(key), et, int(elen), rb, sb))
    reads = os.path.join(d, f"{tag}_reads.fastq")
    with open(reads, "w") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    sam = os.path.join(d, f"{tag}_gt.sam")
    fixtures.build_sam_from_ground_truth(genome, records, errors, sam, raw)
    return reads, sam


# --- module inputs ---

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("char_inputs"))
    x = {"dir": d}
    # genome: the JAX round trip's model, reference and read counts
    prefix = os.path.join(d, "model")
    fixtures.make_model_dir(prefix, mean_read_len=800, sd_read_len=250)
    x["ref"] = os.path.join(d, "ref.fa")
    fixtures.make_reference_fasta(x["ref"], [60000, 30000], seed=21)
    x["reads"], x["sam"] = simulate_with_truth(d, x["ref"], prefix, 700, 78, 9, "genome")
    x["chim_sam"] = os.path.join(d, "genome_chimeric.sam")
    fixtures.add_chimeric_pairs(x["sam"], x["chim_sam"], 40)
    # metagenome: two species, simulated from their tagged concatenation
    species = {"Alpha": ([30000, 12000], 31, "ac"), "Beta_coli": ([25000], 32, "bc")}
    combined = os.path.join(d, "meta_combined.fa")
    x["glist"] = os.path.join(d, "genome_list.tsv")
    x["glist3"] = os.path.join(d, "genome_list_expected.tsv")
    with open(combined, "w") as comb, open(x["glist"], "w") as gl, open(x["glist3"], "w") as g3:
        for sp, (lens, sd, pfx) in species.items():
            fa = os.path.join(d, f"{sp}.fa")
            fixtures.make_reference_fasta(fa, lens, seed=sd, name_prefix=pfx)
            gl.write(f"{sp.replace('_', ' ')}\t{fa}\n")
            g3.write(f"{sp.replace('_', ' ')}\t{fa}\t{60 if sp == 'Alpha' else 40}\n")
            for name, seq, _ in read_fastx(fa):
                comb.write(f">{sp}_{name}\n{seq}\n")
    x["meta_reads"], meta_sam = simulate_with_truth(d, combined, prefix, 260, 30, 5, "meta")
    x["meta_sam"] = os.path.join(d, "meta_chimeric.sam")
    fixtures.add_chimeric_pairs(meta_sam, x["meta_sam"], 30)
    # transcriptome
    (x["genome_fa"], x["trx_fa"], x["annot"], x["trx_reads"], x["g_sam"],
     x["t_sam"]) = fixtures.make_transcriptome_alignments(d)
    return x


# --- running both packages and comparing their files ---

def _load_both(path):
    from nanosim_tpu.profiles import kde as jkde
    from nanosim_tpu_torch.profiles import kde as tkde

    return jkde.load_kde(path), tkde.load_kde(path)


def assert_same_kde(a, b):
    """Both packages' loaders give bit-equal data and an equal bandwidth for
    both files."""
    models = [*_load_both(a), *_load_both(b)]
    d0 = np.asarray(models[0].data, np.float64)
    for m in models:
        got = np.asarray(m.data, np.float64)
        assert got.shape == d0.shape and got.tobytes() == d0.tobytes(), (a, b)
        assert float(m.bandwidth) == float(models[0].bandwidth), (a, b)


def assert_same_outputs(dj, dt):
    fj, ft = sorted(os.listdir(dj)), sorted(os.listdir(dt))
    assert fj == ft
    assert fj, "no output"
    for name in fj:
        a, b = os.path.join(dj, name), os.path.join(dt, name)
        if name.endswith(".pkl"):
            assert_same_kde(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return fj


def run_both(tmp_path, fn_name, *args, raises=None, **kw):
    """Run characterization.main.<fn_name> of each package into its own
    directory (prefix <dir>/training); returns the files written.  With
    `raises`, both must raise that exception with the same message."""
    from nanosim_tpu.characterization import main as jmain
    from nanosim_tpu_torch.characterization import main as tmain

    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    errors = []
    for mod, dd in ((jmain, dj), (tmain, dt)):
        os.makedirs(dd)
        call = lambda: getattr(mod, fn_name)(*args, prefix=os.path.join(dd, "training"), **kw)
        if raises is None:
            call()
            continue
        with pytest.raises(raises) as e:
            call()
        errors.append((type(e.value), str(e.value)))
    if raises is not None:
        assert errors[0] == errors[1]
    return assert_same_outputs(dj, dt)


# The JAX package's homopolymer analysis always raises once a MAF holds a
# homopolymer: hp_model.analyze_homopolymers counts its rows with np.unique(
# ..., axis=0) on an object array, which numpy refuses ("The axis argument to
# unique is not supported for dtype object").  The port keeps that behaviour
# (ROADMAP §3); these cases hold the error and every file written before it.
HP_ERROR = TypeError


GENOME_CASES = {
    "plain": {},
    "fastq": {"fastq": True, "model_fit": False},
    "chimeric": {"chimeric": True, "fastq": True, "model_fit": False},
    "hp": {"homopolymer": 5, "fastq": True, "model_fit": False},
    "no_model_fit": {"model_fit": False},
}


@pytest.mark.parametrize("case", list(GENOME_CASES))
def test_characterize_genome(inputs, tmp_path, case):
    kw = dict(GENOME_CASES[case])
    sam = inputs["chim_sam"] if kw.get("chimeric") else inputs["sam"]
    hp = case == "hp"
    files = run_both(tmp_path, "characterize_genome", inputs["reads"], inputs["ref"],
                     g_alnm=sam, raises=HP_ERROR if hp else None, **kw)
    assert ("training_model_profile" in files) == kw.get("model_fit", True)
    # the homopolymer analysis runs before the base-quality models
    assert ("training_base_qualities_model_parameters.tsv" in files) == (
        kw.get("fastq", False) and not hp)
    assert ("training_processed.maf" in files) == hp
    if kw.get("chimeric"):
        assert "training_gap_length.pkl" in files and "training_chimeric_info" in files


def test_characterize_genome_from_bam(inputs, tmp_path):
    """The same alignments given as BAM (written by each package's own
    bam.write_bam) give the SAM run's files."""
    from nanosim_tpu.characterization import bam as jbam
    from nanosim_tpu.characterization import sam as jsam
    from nanosim_tpu_torch.characterization import bam as tbam
    from nanosim_tpu_torch.characterization import sam as tsam

    def records(mod):
        header, recs = [], []
        for kind, item in mod.read_sam(inputs["sam"]):
            (header if kind == "header" else recs).append(item)
        return header, recs

    jb, tb = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    jbam.write_bam(jb, *records(jsam))
    tbam.write_bam(tb, *records(tsam))
    with open(jb, "rb") as fa, open(tb, "rb") as fb:
        assert fa.read() == fb.read()
    assert tbam.is_bam(tb) and not tbam.is_bam(inputs["sam"])
    from nanosim_tpu.characterization import main as jmain
    from nanosim_tpu_torch.characterization import main as tmain

    dirs = {}
    for tag, mod, bam in (("jax", jmain, jb), ("torch", tmain, tb), ("sam", tmain, None)):
        dd = dirs[tag] = str(tmp_path / tag)
        os.makedirs(dd)
        mod.characterize_genome(inputs["reads"], inputs["ref"], os.path.join(dd, "training"),
                                g_alnm=bam or inputs["sam"], fastq=True, model_fit=False)
    assert_same_outputs(dirs["jax"], dirs["torch"])
    # the BAM's records equal the SAM's: the same model (the primary SAM
    # copies the input lines, which BAM rebuilds from its fields)
    for name in os.listdir(dirs["sam"]):
        if name.endswith("_primary.sam"):
            continue
        a, b = os.path.join(dirs["sam"], name), os.path.join(dirs["torch"], name)
        if name.endswith(".pkl"):
            assert_same_kde(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_characterize_metagenome(inputs, tmp_path):
    files = run_both(tmp_path, "characterize_metagenome", inputs["meta_reads"],
                     inputs["glist"], g_alnm=inputs["meta_sam"], chimeric=True,
                     quantification=True, fastq=True, model_fit=False)
    assert "training_quantification.tsv" in files and "training_chimeric_info" in files
    with open(tmp_path / "torch" / "training_chimeric_info") as f:
        assert "Shrinkage rate (beta)" in f.read()


TRANSCRIPTOME_CASES = {
    "ir_q_n": {"quantification": True, "normalize": True, "fastq": True},
    "hp": {"homopolymer": 5, "model_fit": False},
    "no_intron_retention": {"model_ir": False, "model_fit": False},
}


@pytest.mark.parametrize("case", list(TRANSCRIPTOME_CASES))
def test_characterize_transcriptome(inputs, tmp_path, case):
    kw = TRANSCRIPTOME_CASES[case]
    files = run_both(tmp_path, "characterize_transcriptome", inputs["trx_reads"],
                     inputs["genome_fa"], inputs["trx_fa"], inputs["annot"],
                     g_alnm=inputs["g_sam"], t_alnm=inputs["t_sam"],
                     raises=HP_ERROR if case == "hp" else None, **kw)
    assert ("training_transcriptome_quantification.tsv" in files) == kw.get(
        "quantification", False)
    assert "training_aligned_region_2d.pkl" in files
    assert ("training_IR_markov_model" in files) == kw.get("model_ir", True)
    if kw.get("model_ir", True):
        with open(tmp_path / "torch" / "training_IR_markov_model") as f:
            rows = [line.split("\t") for line in f.read().splitlines()[1:]]
        assert float(rows[0][2]) > 0  # reads retain introns


@pytest.mark.parametrize("mode", ["trans", "meta"])
def test_quantify(inputs, tmp_path, mode):
    if mode == "trans":
        files = run_both(tmp_path, "quantify", "unused", mode="trans", t_alnm=inputs["t_sam"])
    else:
        files = run_both(tmp_path, "quantify", "unused", mode="meta",
                         genome_list=inputs["glist3"], g_alnm=inputs["meta_sam"])
    assert "training_quantification.tsv" in files


def test_detect_ir(inputs, tmp_path):
    files = run_both(tmp_path, "detect_ir", inputs["annot"], g_alnm=inputs["g_sam"],
                     t_alnm=inputs["t_sam"])
    assert {"training_IR_markov_model", "training_IR_info",
            "training_added_intron_final.gff3"} <= set(files)


def test_quantify_paf(tmp_path):
    from nanosim_tpu.characterization import paf_abundance as jpaf
    from nanosim_tpu_torch.characterization import paf_abundance as tpaf

    rs = np.random.default_rng(3)
    paf = str(tmp_path / "aln.paf")
    with open(paf, "w") as f:
        for r in range(300):
            qlen = int(rs.integers(300, 2000))
            for k in range(1 + int(rs.random() < 0.3) + int(rs.random() < 0.1)):
                t = int(rs.integers(0, 12))
                tlen = int(rs.integers(qlen, 3 * qlen))
                qs, qe = int(rs.integers(0, 30)), qlen - int(rs.integers(0, 30))
                ts = int(rs.integers(0, tlen - (qe - qs)))
                m = int((qe - qs) * rs.uniform(0.85, 0.99))
                f.write(f"r{r}\t{qlen}\t{qs}\t{qe}\t+\tT{t}\t{tlen}\t{ts}\t{ts + qe - qs}\t"
                        f"{m}\t{qe - qs}\t60\n")
    for mod, out in ((jpaf, "j.tsv"), (tpaf, "t.tsv")):
        mod.main(["-i", paf, "-o", str(tmp_path / out), "-n", "10"])
    with open(tmp_path / "j.tsv", "rb") as a, open(tmp_path / "t.tsv", "rb") as b:
        got = b.read()
        assert a.read() == got
    assert got.startswith(b"target_id\test_counts\ttpm\n") and got.count(b"\n") > 5


def test_missing_aligner_raises_the_jax_message(inputs, tmp_path, monkeypatch):
    """Without minimap2 or lastal on PATH both packages raise the same
    RuntimeError."""
    from nanosim_tpu.characterization import align as jalign
    from nanosim_tpu_torch.characterization import align as talign

    monkeypatch.setenv("PATH", str(tmp_path))
    msgs = []
    for mod in (jalign, talign):
        for call in (lambda m: m.run_minimap2(inputs["ref"], inputs["reads"],
                                              str(tmp_path / "x.sam")),
                     lambda m: m.run_last(inputs["ref"], inputs["reads"],
                                          str(tmp_path / "x.maf"), str(tmp_path / "p"))):
            with pytest.raises(RuntimeError) as e:
                call(mod)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]
    assert "minimap2" in msgs[0] and "last" in msgs[1].lower()


def test_kde_files_load_in_both_packages(tmp_path):
    """A KDE written by either package's save_kde loads in both, with
    bit-equal data and bandwidth; the port writes a plain pickle."""
    from nanosim_tpu.profiles import kde as jkde
    from nanosim_tpu_torch.profiles import kde as tkde

    rs = np.random.default_rng(5)
    for data, bw in ((rs.normal(800, 250, 500), 10.0), (rs.random((300, 2)) * 1e3, 0.37)):
        a, b = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
        jkde.save_kde(a, data, bw)
        tkde.save_kde(b, data, bw)
        assert_same_kde(a, b)
        want = np.asarray(data, np.float64).reshape(len(data), -1)
        assert np.asarray(tkde.load_kde(b).data).tobytes() == want.tobytes()
        with open(b, "rb") as f:
            assert b"sklearn" not in f.read()


def test_cli_characterize_genome_same_files(inputs, tmp_path):
    """`python -m nanosim_tpu_torch characterize genome ...` against `python
    -m nanosim_tpu characterize genome ...` with the same files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    for pkg in ("nanosim_tpu", "nanosim_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", pkg, "characterize", "genome", "-i", inputs["reads"],
             "-rg", inputs["ref"], "-ga", inputs["sam"], "-o", str(d / "training"),
             "--fastq", "--no_model_fit"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
    assert_same_outputs(str(tmp_path / "nanosim_tpu"), str(tmp_path / "nanosim_tpu_torch"))


def test_cli_quantify_paf_runs(tmp_path):
    paf = str(tmp_path / "aln.paf")
    with open(paf, "w") as f:
        f.write("r1\t500\t0\t480\t+\tT1\t1000\t5\t490\t450\t500\t60\n")
        f.write("r2\t400\t0\t380\t+\tT1\t1000\t2\t400\t370\t400\t60\n")
        f.write("r3\t300\t0\t290\t+\tT2\t800\t3\t300\t280\t300\t60\n")
    out = str(tmp_path / "abun.tsv")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "nanosim_tpu_torch", "quantify_paf", "-i", paf,
                          "-o", out], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-500:]
    lines = open(out).read().strip().split("\n")
    assert lines[0] == "target_id\test_counts\ttpm"
    vals = {line.split("\t")[0]: float(line.split("\t")[2]) for line in lines[1:]}
    assert abs(vals["T1"] - 2 / 3 * 1e6) < 1e3 and abs(vals["T2"] - 1 / 3 * 1e6) < 1e3
