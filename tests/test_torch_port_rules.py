"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

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
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'nanosim_tpu' or m.startswith('nanosim_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_names_jax_or_the_jax_package():
    imp = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b)",
                     re.M)
    pkg = re.compile(r"nanosim_tpu(?!_torch)")
    for path in _sources():
        with open(path) as f:
            text = f.read()
        assert not imp.search(text), path
        assert not pkg.search(text), path


def test_entry_points_default_to_the_card(tmp_path):
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures, profile
    from nanosim_tpu_torch.sim import genome_mode, unaligned_mode
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
    # asked for explicitly, the CPU runs
    genome_mode.GenomeSimulator(g, prof, device="cpu")


def test_cli_refuses_what_is_not_ported(tmp_path):
    for argv in (["simulate", "transcriptome", "-rt", "x"], ["characterize", "genome"]):
        res = subprocess.run([sys.executable, "-m", "nanosim_tpu_torch", *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert "not ported" in res.stderr


# genome options the port does not run yet: the CLI names them and exits 2
NOT_PORTED_OPTIONS = {
    "--perfect": ["--perfect"],
    "-hp --perfect": ["-hp", "-k", "6", "--perfect"],
    "--chimeric": ["--chimeric"],
    "-med/-sd": ["-med", "5000", "-sd", "1.0"],
    "-x": ["-x", "10"],
    "--num_hosts": ["--num_hosts", "2"],
}


@pytest.mark.parametrize("what", sorted(NOT_PORTED_OPTIONS))
def test_cli_refuses_genome_options_not_ported(capsys, what):
    from nanosim_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["genome", "-rg", "ref.fa", *NOT_PORTED_OPTIONS[what]])
    assert e.value.code == 2
    assert f"{what.split()[-1]} is not ported" in capsys.readouterr().err


def test_cli_accepts_circular_dna(tmp_path):
    """`-dna_type circular` passes the CLI and reaches the simulator, which
    asks for the card (without one it raises rather than fall back)."""
    _cli_reaches_the_simulator(tmp_path, ["-dna_type", "circular"])


@pytest.mark.parametrize("extra", [[], ["-dna_type", "circular", "--fastq"]],
                         ids=["linear", "circular-fastq"])
def test_cli_accepts_hp(tmp_path, extra):
    """`-hp -k 6` passes the CLI and reaches the simulator."""
    _cli_reaches_the_simulator(tmp_path, ["-hp", "-k", "6", *extra])


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
