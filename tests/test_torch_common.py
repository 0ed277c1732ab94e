"""Shared helpers for the PyTorch port's parity tests (no tests here).

The JAX package is the reference: inputs are made from a seed with numpy,
JAX runs on the CPU, and the port runs with ``device="cpu"``.
"""

import dataclasses
import os

import numpy as np
import torch

from nanosim_tpu_torch.sim import bundles as torch_bundles

# The suite runs with several worker processes on a few cores.  PyTorch's CPU
# operators would start one OpenMP thread per core in every worker, and the
# workers then spend their time waiting on each other's threads (the chimeric
# run tests took 17 times as long in three concurrent processes).  The
# tensors of these tests are small: one thread per worker is the fast setting.
torch.set_num_threads(1)

# The JAX package is imported inside the helpers that use it, so that the
# card-only tests (which import this module) also run where JAX is absent.


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper takes its card
    path, and must refuse it before it builds or launches anything."""

    @property
    def is_cuda(self):
        return True


def on_card(t):
    return torch.Tensor._make_subclass(OnCard, t)


def make_model(dirpath: str, **kw) -> str:
    """A synthetic model directory (the JAX package's fixture writer)."""
    from nanosim_tpu.profiles import fixtures as jax_fixtures

    prefix = os.path.join(dirpath, "training")
    kw.setdefault("mean_read_len", 600)
    kw.setdefault("sd_read_len", 200)
    kw.setdefault("n_kde_points", 200)
    jax_fixtures.make_model_dir(prefix, **kw)
    return prefix


IUPAC_CODES = b"YRWSKMDVHBNX"


def make_iupac_reference(path: str, lengths, seed: int) -> None:
    """A random FASTA reference (70-column lines) in which about one base in
    150 is an ambiguity code, every code of IUPAC_CODES included, some of
    them lowercase (the loaders uppercase them)."""
    rs = np.random.default_rng(seed)
    with open(path, "w") as f:
        for ci, n in enumerate(lengths):
            seq = np.frombuffer(b"ACGT", np.uint8)[rs.integers(0, 4, n)].copy()
            pos = rs.choice(n, max(len(IUPAC_CODES), n // 150), replace=False)
            seq[pos] = np.frombuffer(IUPAC_CODES, np.uint8)[np.arange(len(pos)) % len(IUPAC_CODES)]
            low = pos[::7]
            seq[low] = seq[low] + 32
            s = seq.tobytes().decode()
            f.write(f">chr{ci + 1}\n")
            for i in range(0, n, 70):
                f.write(s[i : i + 70] + "\n")


def tables_to_numpy(t) -> dict:
    """The JAX SimTables' leaves as {"<field>.<attr>": ndarray}."""
    d = {}
    for name, v in t._asdict().items():
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                d[f"{name}.{f.name}"] = np.asarray(getattr(v, f.name))
        elif name == "strandness_rate" or (name.startswith("hp_") and t.hp_breaks is not None):
            d[name] = np.asarray(v)
    return d


def load_both(prefix: str, fastq: bool = False, homopolymer: bool = False):
    """(JAX profile, JAX SimTables, port SimTables on the CPU built from the
    JAX tables' arrays)."""
    from nanosim_tpu.profiles import profile as jax_profile
    from nanosim_tpu.sim import bundles as jax_bundles

    prof = jax_profile.load_profile(prefix, mode="genome", fastq=fastq, homopolymer=homopolymer)
    jt = jax_bundles.build_tables(prof)
    return prof, jt, torch_bundles.tables_from_numpy(tables_to_numpy(jt), "cpu")


def port_tables(dirpath: str, device):
    """The port's own fixture writer, loader and table builder (no JAX):
    for the card-only tests."""
    from nanosim_tpu_torch.profiles import fixtures, profile

    prefix = os.path.join(dirpath, "training")
    fixtures.make_model_dir(prefix, mean_read_len=600, sd_read_len=200, n_kde_points=200)
    prof = profile.load_profile(prefix, mode="genome")
    return torch_bundles.build_tables(prof, device)


# --- whole `simulate genome --chimeric` runs (tests/test_torch_chimeric*_runs.py) ---

RUN_FILES = ("_aligned_reads", "_aligned_error_profile", "_unaligned_reads")
CHIMERIC_SEED = 3
CHIMERIC_BATCH = 64
CHIMERIC_N = 150


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def assert_same_files(a: str, b: str, fastq: bool) -> None:
    ext = ".fastq" if fastq else ".fasta"
    for suf in RUN_FILES:
        path = suf if suf.endswith("profile") else suf + ext
        assert read_file(a + path) == read_file(b + path), path


def make_chimeric_model(d: str):
    """(dir, model prefix, linear reference, circular reference): a model whose
    segment mean is 1.9, so that multi-segment reads are common, and
    references with runs long enough for `-hp -k 6`."""
    from nanosim_tpu.profiles import error_model, fixtures

    prefix = make_model(d, mean_read_len=400, sd_read_len=150)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.9, 0.2)
    lin, circ = os.path.join(d, "lin.fa"), os.path.join(d, "circ.fa")
    fixtures.make_reference_fasta(lin, [30000, 15000], seed=6, hp_bias=0.5)
    fixtures.make_reference_fasta(circ, [20000], seed=7, hp_bias=0.5)
    return d, prefix, lin, circ


def _chimeric_env(mp, recon0: bool, packed_cap) -> None:
    if recon0:
        mp.setenv("NANOSIM_TPU_RECON", "0")
    if packed_cap is not None:
        mp.setenv("NANOSIM_TPU_PACKED_CAP", str(packed_cap))


def jax_chimeric_runs(model):
    """get(tag, fastq, ...) -> output prefix of the JAX package's whole
    `--chimeric` run, each made once."""
    import pytest

    from nanosim_tpu.sim import run as jrun

    d, prefix, lin, circ = model
    done = {}

    def get(tag, fastq, dna="linear", recon0=False, kmer_bias=None):
        if tag not in done:
            out = os.path.join(d, "jax_" + tag)
            with pytest.MonkeyPatch.context() as mp:
                _chimeric_env(mp, recon0, None)
                jrun.simulate_genome(circ if dna == "circular" else lin, prefix, out, CHIMERIC_N,
                                     seed=CHIMERIC_SEED, batch=CHIMERIC_BATCH, fastq=fastq,
                                     dna_type=dna, chimeric=True, kmer_bias=kmer_bias,
                                     homopolymer=kmer_bias is not None)
            done[tag] = out
        return done[tag]

    return get


def torch_chimeric_run(model, tag, fastq, dna="linear", recon0=False, kmer_bias=None,
                       packed_cap=None) -> str:
    """The port's whole `--chimeric` run on the CPU -> its output prefix."""
    import pytest

    from nanosim_tpu_torch.sim import output as tout
    from nanosim_tpu_torch.sim import run as trun

    d, prefix, lin, circ = model
    out = os.path.join(d, "torch_" + tag)
    tout.RUN_STATS.reset()
    with pytest.MonkeyPatch.context() as mp:
        _chimeric_env(mp, recon0, packed_cap)
        counts = trun.simulate_genome(circ if dna == "circular" else lin, prefix, out, CHIMERIC_N,
                                      seed=CHIMERIC_SEED, batch=CHIMERIC_BATCH, fastq=fastq,
                                      dna_type=dna, chimeric=True, kmer_bias=kmer_bias,
                                      device="cpu")
    assert counts["aligned"] > 0 and counts["unaligned"] > 0
    assert tout.RUN_STATS.checksum_fallback_lanes == 0
    return out


def chimeric_share(prefix_out: str, fastq: bool):
    """(reads named `_chimeric`, reads in all) of the aligned file."""
    path = prefix_out + "_aligned_reads" + (".fastq" if fastq else ".fasta")
    lines = read_file(path).split(b"\n")
    names = [n for n in (lines[0::4] if fastq else lines[0::2]) if n]
    return sum(1 for n in names if b"_chimeric_" in n), len(names)


# --- `simulate metagenome` (tests/test_torch_metagenome*.py) ---

META_SPECIES = ("Escherichia_coli", "Bacillus_subtilis", "Salmonella_enterica")


def make_metagenome_fixture(d: str):
    """The fixture of tests/test_metagenome.py: three species (Bacillus with
    two chromosomes), a model with segment mean 1.6, a two-sample abundance
    matrix (120 and 80 reads) and a dna-type list making every chromosome
    linear.  Returns a namespace (d, prefix, glist, abun, dl, species)."""
    import types

    from nanosim_tpu.profiles import error_model, fixtures

    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=400, sd_read_len=120)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.6, 0.2)
    species = list(META_SPECIES)
    sizes = [[30000], [20000, 8000], [25000]]
    gpaths = []
    for i, (sp, sz) in enumerate(zip(species, sizes)):
        p = os.path.join(d, f"{sp}.fa")
        fixtures.make_reference_fasta(p, sz, seed=10 + i, name_prefix=f"{sp[:3]}chr")
        gpaths.append(p)
    glist = os.path.join(d, "genome_list.tsv")
    with open(glist, "w") as f:
        for sp, p in zip(species, gpaths):
            f.write(f"{sp}\t{p}\n")
    abun = os.path.join(d, "abun.tsv")
    with open(abun, "w") as f:
        f.write("Species\t120\t80\n")
        f.write("Escherichia coli\t60\t20\n")
        f.write("Bacillus subtilis\t30\t50\n")
        f.write("Salmonella enterica\t10\t30\n")
    dl = os.path.join(d, "dna_types.tsv")
    with open(dl, "w") as f:
        for sp, sz in zip(species, sizes):
            for ci in range(len(sz)):
                f.write(f"{sp}\t{sp[:3]}chr{ci + 1}\tlinear\n")
    return types.SimpleNamespace(d=d, prefix=prefix, glist=glist, abun=abun, dl=dl,
                                 species=species)
