"""Rules of the PyTorch port: it imports neither JAX, the JAX package nor the
bench scripts, its entry points run on the card unless the caller asks for
the CPU, and one function picks the route of every mode's pass."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nanosim_tpu_torch")


def _sources():
    for root, _, files in os.walk(PKG):
        if "_build" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                yield os.path.join(root, f)


def _modules():
    for path in _sources():
        if path.endswith(".py"):
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            yield rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def test_importing_every_module_loads_no_jax():
    mods = sorted(_modules())
    assert "nanosim_tpu_torch.ops.walk_cuda" in mods
    assert "nanosim_tpu_torch.ops.walk_ablate" in mods
    assert "nanosim_tpu_torch.sim.chimeric_mode" in mods
    for m in ("ops.gather_window", "sim.ir", "sim.transcriptome_mode", "sim.run_transcriptome",
              "sim.run_metagenome", "io.genome", "cli_analysis", "characterization"):
        assert "nanosim_tpu_torch." + m in mods
    for m in ("sam", "bam", "primary", "lengths", "error_hist", "quals", "fitting", "hp_model",
              "ir_model", "align", "paf_abundance", "main"):
        assert "nanosim_tpu_torch.characterization." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'nanosim_tpu' or m.startswith('nanosim_tpu.')"
        " or m == 'bench' or m.startswith('bench.'))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


# The one line that may spell the JAX package's name: an output value, the
# GFF source column of the annotations `characterize transcriptome` writes,
# which must be the JAX package's bytes.  It names no module.
NAME_IN_OUTPUT = {os.path.join("characterization", "align.py"): 'GFF_SOURCE = "nanosim_tpu"'}


def test_no_source_names_jax_the_jax_package_or_bench():
    imp = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
                     r"|import\s+bench\b|from\s+bench\b)", re.M)
    pkg = re.compile(r"nanosim_tpu(?!_torch)")
    for path in _sources():
        with open(path) as f:
            text = f.read()
        allowed = NAME_IN_OUTPUT.get(os.path.relpath(path, PKG))
        if allowed is not None:
            assert text.count(allowed) == 1, path
            text = text.replace(allowed, "")
        assert not imp.search(text), path
        assert not pkg.search(text), path


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures, profile
    from nanosim_tpu_torch.sim import chimeric_mode, genome_mode, unaligned_mode
    from nanosim_tpu_torch.sim.run import simulate_genome

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    prefix = str(tmp_path / "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=100, n_kde_points=100)
    ref = str(tmp_path / "ref.fa")
    fixtures.make_reference_fasta(ref, [20000], seed=2)
    g = PackedGenome.from_fasta(ref)
    prof = profile.load_profile(prefix, mode="genome")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        genome_mode.GenomeSimulator(g, prof)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        unaligned_mode.UnalignedSimulator(g, prof)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_genome(ref, prefix, str(tmp_path / "out"), 10)
    chi_prof = profile.load_profile(prefix, mode="genome", chimeric=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        chimeric_mode.ChimericGenomeSimulator(g, chi_prof)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_genome(ref, prefix, str(tmp_path / "out"), 10, chimeric=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_genome(ref, prefix, str(tmp_path / "out"), 10, perfect=True)
    # asked for explicitly, the CPU runs
    genome_mode.GenomeSimulator(g, prof, device="cpu")
    chimeric_mode.ChimericGenomeSimulator(g, chi_prof, device="cpu")


def test_transcriptome_entry_points_default_to_the_card(tmp_path):
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import gather_window
    from nanosim_tpu_torch.profiles import fixtures, profile
    from nanosim_tpu_torch.sim import unaligned_mode
    from nanosim_tpu_torch.sim.run_transcriptome import (TranscriptomeSimulator,
                                                         simulate_transcriptome)

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    prefix, trx, exp = _transcriptome_fixture(tmp_path)
    t = PackedGenome.from_fasta(trx)
    prof = profile.load_profile(prefix, mode="transcriptome", model_ir=False)
    expr = profile.load_expression(exp, dict(zip(t.names, (int(x) for x in t.lengths))))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TranscriptomeSimulator(t, prof, expr)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        unaligned_mode.UnalignedSimulator(t, prof, transcriptome_mode=True, uracil=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_transcriptome(trx, "", exp, prefix, str(tmp_path / "out"), 10, model_ir=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        gather_window.measure_gather_variants()
    # asked for explicitly, the CPU runs
    TranscriptomeSimulator(t, prof, expr, device="cpu")


def test_windowed_gather_wrapper_never_runs_its_plain_version_off_the_cpu():
    """K8's wrapper runs the plain version for CPU tensors only: a CUDA
    tensor it cannot take (a wrong type, a wrong shape) and a tensor on
    another device raise before any launch."""
    import torch

    from nanosim_tpu_torch.ops import gather_window as gw

    class OnCard(torch.Tensor):  # a CPU tensor that says it lies on the card
        @property
        def is_cuda(self):
            return True

    def card(t):
        return torch.Tensor._make_subclass(OnCard, t)

    packed = torch.zeros((8, 300), dtype=torch.uint8)
    idx = torch.zeros((8, 1024), dtype=torch.int32)
    ws = torch.zeros((8, 1), dtype=torch.int32)
    launches = gw.gather_windowed.launches
    with pytest.raises(ValueError, match="int32 idx"):
        gw.gather_windowed(card(packed), card(idx.long()), card(ws), 4, 8)
    with pytest.raises(ValueError, match="shapes"):
        gw.gather_windowed(card(packed), card(idx), card(torch.zeros((8, 2), dtype=torch.int32)),
                           4, 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gw.gather_windowed(packed.to("meta"), idx.to("meta"), ws.to("meta"), 4, 8)
    assert gw.gather_windowed.launches == launches
    assert gw.gather_windowed(packed, idx, ws, 4, 8).shape == (8, 1024)


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Every command of the JAX package is ported: `characterize` and
    `quantify_paf` dispatch to their parsers, which answer missing arguments
    with their usage, and nothing is refused as not ported."""
    for argv, usage in ((["characterize"], "usage: nanosim-tpu-torch characterize"),
                        (["characterize", "genome"],
                         "usage: nanosim-tpu-torch characterize genome"),
                        (["quantify_paf"], "-i INPUT")):
        res = subprocess.run([sys.executable, "-m", "nanosim_tpu_torch", *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert usage in res.stderr
        assert "not ported" not in res.stderr + res.stdout


# the sub-commands' arguments of the option checks below (no files needed)
TRANSCRIPTOME = ["transcriptome", "-rt", "trx.fa", "-e", "exp.tsv", "--no_model_ir"]
METAGENOME = ["metagenome", "-gl", "genome_list.tsv", "-a", "abun.tsv"]


@pytest.mark.parametrize("options,message", [
    (["transcriptome", "-rt", "trx.fa", "-e", "exp.tsv"],
     "Please provide a reference genome to simulate intron retention events"),
    (TRANSCRIPTOME + ["--polya", "polya.txt"], "Please input basecaller"),
], ids=["ir-without-genome", "polya-without-basecaller"])
def test_cli_transcriptome_checks_keep_their_messages(capsys, options, message):
    from nanosim_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(options)
    assert e.value.code == 1
    got = capsys.readouterr()
    assert message in got.out + got.err


@pytest.mark.parametrize("extra", [[], ["-dna_type", "circular", "--fastq"],
                                   ["-hp", "-k", "6"]], ids=["linear", "circular-fastq", "hp"])
def test_cli_accepts_perfect(tmp_path, extra):
    """`--perfect` passes the CLI and reaches the simulator."""
    _cli_reaches_the_simulator(tmp_path, ["--perfect", *extra])


@pytest.mark.parametrize("extra", [["--fastq"], ["--uracil", "--perfect"], ["-hp", "-k", "6"]],
                         ids=["cdna-fastq", "drna-perfect", "hp"])
def test_cli_accepts_transcriptome(tmp_path, extra):
    """`simulate transcriptome` passes the CLI and reaches the simulator,
    which asks for the card."""
    import torch

    from nanosim_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the options on the card are driven by chip_smoke.py")
    prefix, trx, exp = _transcriptome_fixture(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["transcriptome", "-rt", trx, "-e", exp, "-c", prefix, "--no_model_ir",
                  "-o", str(tmp_path / "out"), "-n", "10", *extra])


def _transcriptome_fixture(tmp_path):
    from nanosim_tpu_torch.profiles import fixtures

    prefix = str(tmp_path / "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=100, n_kde_points=100,
                            transcriptome=True, mean_2d_ref_len=800)
    trx = str(tmp_path / "trx.fa")
    names = fixtures.make_transcript_reference(trx, n_transcripts=5, mean_len=1200, seed=2)
    exp = str(tmp_path / "exp.tsv")
    fixtures.make_expression_tsv(exp, names, seed=3)
    return prefix, trx, exp


def test_cli_accepts_circular_dna(tmp_path):
    """`-dna_type circular` passes the CLI and reaches the simulator, which
    asks for the card (without one it raises rather than fall back)."""
    _cli_reaches_the_simulator(tmp_path, ["-dna_type", "circular"])


@pytest.mark.parametrize("extra", [[], ["-dna_type", "circular", "--fastq"]],
                         ids=["linear", "circular-fastq"])
def test_cli_accepts_hp(tmp_path, extra):
    """`-hp -k 6` passes the CLI and reaches the simulator."""
    _cli_reaches_the_simulator(tmp_path, ["-hp", "-k", "6", *extra])


@pytest.mark.parametrize("mode,extra", [
    ("genome", ["-med", "5000", "-sd", "1.0"]), ("genome", ["-x", "10"]),
    ("transcriptome", ["-x", "10"]), ("metagenome", ["-med", "5000", "-sd", "1.0"]),
], ids=["med-sd", "coverage", "transcriptome-coverage", "metagenome-med-sd"])
def test_cli_accepts_lognormal_lengths_and_coverage(tmp_path, mode, extra):
    """`-med/-sd` (genome, metagenome) and `-x` (genome, transcriptome) pass
    the CLI and reach the simulator, which asks for the card."""
    import torch

    from nanosim_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the options on the card are driven by chip_smoke.py")
    if mode == "genome":
        _cli_reaches_the_simulator(tmp_path, extra)
        return
    out = ["-o", str(tmp_path / "out")]
    if mode == "transcriptome":
        prefix, trx, exp = _transcriptome_fixture(tmp_path)
        argv = ["transcriptome", "-rt", trx, "-e", exp, "-c", prefix, "--no_model_ir", "-n", "10"]
    else:  # the abundance file gives the metagenome's read counts
        prefix, glist, abun = _metagenome_fixture(tmp_path)
        argv = ["metagenome", "-gl", glist, "-a", abun, "-c", prefix]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv + out + extra)


@pytest.mark.parametrize("extra", [[], ["--fastq"], ["-dna_type", "circular"],
                                   ["-hp", "-k", "6", "--fastq"]],
                         ids=["linear", "fastq", "circular", "hp-fastq"])
def test_cli_accepts_chimeric(tmp_path, extra):
    """`--chimeric` passes the CLI and reaches the chimeric simulator."""
    _cli_reaches_the_simulator(tmp_path, ["--chimeric", *extra])


@pytest.mark.parametrize("options,message,code", [
    (["--chimeric", "-med", "5000", "-sd", "1.0"], "Lognormal distributed reads cannot be chimeric",
     1),
    (["--chimeric", "--perfect"], "Perfect reads cannot be chimeric", 1),
    (["--chimeric", "-x", "10", "--num_hosts", "2"], None, None),
], ids=["med-sd", "perfect", "coverage"])
def test_cli_chimeric_refusals_keep_their_messages(tmp_path, capsys, options, message, code):
    """The chimeric option checks keep their messages; `-x` with
    `--num_hosts 2` (one process emulating both ranks) passes them and
    reaches the simulator."""
    from nanosim_tpu_torch import cli

    if message is None:
        _cli_reaches_the_simulator(tmp_path, options)
        return
    with pytest.raises(SystemExit) as e:
        cli.main(["genome", "-rg", "ref.fa", *options])
    assert e.value.code == code
    got = capsys.readouterr()
    assert message in got.out + got.err


def test_chimeric_simulator_needs_a_chimeric_profile(tmp_path):
    """A profile loaded without chimeric=True has no gap KDE: the simulator
    says so instead of failing inside the batch."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures, profile
    from nanosim_tpu_torch.sim import chimeric_mode

    prefix = str(tmp_path / "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=100, n_kde_points=100)
    ref = str(tmp_path / "ref.fa")
    fixtures.make_reference_fasta(ref, [20000], seed=2)
    with pytest.raises(ValueError, match="chimeric=True"):
        chimeric_mode.ChimericGenomeSimulator(
            PackedGenome.from_fasta(ref), profile.load_profile(prefix, mode="genome"),
            device="cpu")


def test_shared_header_is_a_source_of_both_walk_libraries():
    """An edit to csrc/walk_common.cuh rebuilds walk.cu's and walk_ablate.cu's
    libraries: the build tracks the headers a source includes."""
    from nanosim_tpu_torch.ops import cuda_build, walk_ablate, walk_cuda

    header = os.path.join(cuda_build.CSRC_DIR, "walk_common.cuh")
    for lib in (walk_cuda.LIBRARY, walk_ablate.LIBRARY):
        srcs = cuda_build.sources_of(lib.src)
        assert srcs[0] == lib.src and header in srcs
    from nanosim_tpu_torch.ops import gather_cuda

    assert cuda_build.sources_of(gather_cuda.LIBRARY.src) == [gather_cuda.LIBRARY.src]


def _cli_reaches_the_simulator(tmp_path, options):
    import torch

    from nanosim_tpu_torch import cli
    from nanosim_tpu_torch.profiles import fixtures

    if torch.cuda.is_available():
        pytest.skip("a card is present: the options on the card are driven by chip_smoke.py")
    prefix = str(tmp_path / "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=100, n_kde_points=100)
    ref = str(tmp_path / "ref.fa")
    fixtures.make_reference_fasta(ref, [20000], seed=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["genome", "-rg", ref, "-c", prefix, "-o", str(tmp_path / "out"), "-n", "10",
                  *options])


def test_cli_hp_needs_a_kmer_bias(capsys):
    from nanosim_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["genome", "-rg", "ref.fa", "-hp"])
    assert e.value.code == 1
    assert "kmer bias" in capsys.readouterr().out


def _metagenome_fixture(tmp_path):
    """Two species (the port's own fixture writers), a one-sample abundance
    file and a model with chimeric info."""
    from nanosim_tpu_torch.profiles import error_model, fixtures

    prefix = str(tmp_path / "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=100, n_kde_points=100)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.5, 0.2)
    glist = str(tmp_path / "genome_list.tsv")
    with open(glist, "w") as f:
        for i, sp in enumerate(("Escherichia_coli", "Bacillus_subtilis")):
            p = str(tmp_path / f"{sp}.fa")
            fixtures.make_reference_fasta(p, [20000], seed=2 + i, name_prefix=f"{sp[:3]}chr")
            f.write(f"{sp}\t{p}\n")
    abun = str(tmp_path / "abun.tsv")
    with open(abun, "w") as f:
        f.write("Species\t10\nEscherichia coli\t70\nBacillus subtilis\t30\n")
    return prefix, glist, abun


def test_metagenome_entry_points_default_to_the_card(tmp_path):
    import torch

    from nanosim_tpu_torch.io.genome import MetagenomeSet
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.run_metagenome import MetagenomeSimulator, simulate_metagenome

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is exercised by chip_smoke.py")
    prefix, glist, abun = _metagenome_fixture(tmp_path)
    mset = MetagenomeSet.from_genome_list(glist)
    prof = profile.load_profile(prefix, mode="metagenome", chimeric=True)
    share = {"Escherichia_coli": 70.0, "Bacillus_subtilis": 30.0}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MetagenomeSimulator(mset, prof, share, chimeric=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_metagenome(glist, abun, None, prefix, str(tmp_path / "out"))
    # asked for explicitly, the CPU runs: -med/-sd (refused before they were
    # ported) gives the JAX package's files
    MetagenomeSimulator(mset, prof, share, chimeric=True, device="cpu")
    from nanosim_tpu.sim.run_metagenome import simulate_metagenome as jax_simulate_metagenome

    outs = {}
    for name, sim, kw in (("jax", jax_simulate_metagenome, {}),
                          ("torch", simulate_metagenome, {"device": "cpu"})):
        outs[name] = str(tmp_path / name / "sim")
        os.makedirs(os.path.dirname(outs[name]))
        sim(glist, abun, None, prefix, outs[name], median_len=400, sd_len=0.3, batch=16,
            seed=2, **kw)
    for suf in ("_aligned_reads.fasta", "_aligned_error_profile", "_unaligned_reads.fasta"):
        with open(outs["jax"] + "_sample0" + suf, "rb") as a, \
                open(outs["torch"] + "_sample0" + suf, "rb") as b:
            assert a.read() == b.read(), suf


@pytest.mark.parametrize("options,message", [
    (["-med", "5000"], "Please provide both mean and standard deviation of read length"),
    (["-med", "5000", "-sd", "1.0", "--chimeric"], "Lognormal distributed reads cannot be chimeric"),
    (["--perfect", "--chimeric"], "Perfect reads cannot be chimeric"),
], ids=["med-without-sd", "med-sd-chimeric", "perfect-chimeric"])
def test_cli_metagenome_checks_keep_their_messages(capsys, options, message):
    from nanosim_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(METAGENOME + options)
    assert e.value.code == 1
    got = capsys.readouterr()
    assert message in got.out + got.err


@pytest.mark.parametrize("extra", [[], ["--chimeric", "--fastq"], ["--perfect"],
                                   ["-hp", "-k", "6"], ["--abun_var", "-0.5", "0.5"]],
                         ids=["plain", "chimeric-fastq", "perfect", "hp", "abun-var"])
def test_cli_accepts_metagenome(tmp_path, extra):
    """`simulate metagenome` passes the CLI and reaches the simulator, which
    asks for the card (without one it raises rather than fall back)."""
    import torch

    from nanosim_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the options on the card are driven by chip_smoke.py")
    prefix, glist, abun = _metagenome_fixture(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["metagenome", "-gl", glist, "-a", abun, "-c", prefix,
                  "-o", str(tmp_path / "out"), *extra])


# mode -> whether a pass runs Route A (meta-only program, host
# reconstruction) for (circular_dna, hp, direct_rna), NANOSIM_TPU_RECON unset
ROUTE_A = {
    "genome": lambda circular, hp, rna: not circular,
    "chimeric": lambda circular, hp, rna: not (circular or hp),
    "metagenome": lambda circular, hp, rna: not hp,
    "transcriptome": lambda circular, hp, rna: not hp,
    "unaligned": lambda circular, hp, rna: not (circular or rna),
}


@pytest.mark.parametrize("recon_env", [None, "1", "0"], ids=["unset", "1", "0"])
@pytest.mark.parametrize("mode", list(ROUTE_A))
def test_route_table(monkeypatch, mode, recon_env):
    """`want_recon`, the one place that picks a pass's route: linear DNA
    reconstructs on the host (metagenome and transcriptome count as linear),
    `-hp` only in genome mode, direct-RNA unaligned reads never, and
    NANOSIM_TPU_RECON=0 sends every pass to the read-emitting program."""
    import itertools

    from nanosim_tpu_torch.sim.route import RECON_MODES, want_recon

    assert set(RECON_MODES) == set(ROUTE_A)
    if recon_env is None:
        monkeypatch.delenv("NANOSIM_TPU_RECON", raising=False)
    else:
        monkeypatch.setenv("NANOSIM_TPU_RECON", recon_env)
    for circular, hp, rna in itertools.product((False, True), repeat=3):
        want = recon_env != "0" and ROUTE_A[mode](circular, hp, rna)
        got = want_recon(mode, circular_dna=circular, hp=hp, direct_rna=rna)
        assert got is want, (circular, hp, rna)
    with pytest.raises(ValueError, match="unknown pass mode"):
        want_recon(mode + "_x")
