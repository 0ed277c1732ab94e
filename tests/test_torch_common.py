"""Shared helpers for the PyTorch port's parity tests (no tests here).

The JAX package is the reference: inputs are made from a seed with numpy,
JAX runs on the CPU, and the port runs with ``device="cpu"``.
"""

import dataclasses
import os

import numpy as np

from nanosim_tpu_torch.sim import bundles as torch_bundles

# The JAX package is imported inside the helpers that use it, so that the
# card-only tests (which import this module) also run where JAX is absent.


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
