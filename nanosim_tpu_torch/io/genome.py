"""Packed reference sequences for on-device extraction.

The reference keeps per-chromosome Python strings and slices them per read
(simulator.py:1694-1781).  Here every reference is ONE flat uppercase-ASCII
uint8 array (uploaded once to HBM) plus chromosome offset tables; read
extraction becomes a batched gather, boundary rejection a ``searchsorted``
over the offsets, and circular wrap a modulo — all on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .fastx import mangle_name, read_fastx

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)


@dataclasses.dataclass
class PackedGenome:
    """A genome/transcriptome as one flat token array.

    Attributes:
      flat: [total_len] uint8 uppercase ASCII bases.
      names: chromosome (or transcript) names, reference-mangled.
      lengths: [n_chrom] int64.
      offsets: [n_chrom + 1] int64 exclusive cumulative lengths; chromosome c
        occupies flat[offsets[c]:offsets[c+1]].
      circular: [n_chrom] bool DNA topology per chromosome.
    """

    flat: np.ndarray
    names: list
    lengths: np.ndarray
    offsets: np.ndarray
    circular: np.ndarray

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

    @property
    def max_chrom(self) -> int:
        return int(self.lengths.max()) if len(self.lengths) else 0

    @property
    def n_chrom(self) -> int:
        return len(self.names)

    def name_index(self) -> dict:
        return {n: i for i, n in enumerate(self.names)}

    @classmethod
    def from_fasta(cls, path: str, dna_type: str = "linear") -> "PackedGenome":
        names, seqs = [], []
        for name, seq, _ in read_fastx(path):
            names.append(mangle_name(name))
            seqs.append(_UPPER[np.frombuffer(seq.encode(), dtype=np.uint8)])
        if not names:
            raise ValueError(f"no sequences in {path}")
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        flat = np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.uint8)
        circ = np.full(len(seqs), dna_type == "circular")
        return cls(flat=flat, names=names, lengths=lengths, offsets=offsets, circular=circ)

    def slice(self, chrom: int, start: int, length: int) -> np.ndarray:
        """Host-side extraction with circular wrap (for tests/oracles)."""
        off = self.offsets[chrom]
        ln = self.lengths[chrom]
        if start + length <= ln:
            return self.flat[off + start : off + start + length]
        if not self.circular[chrom]:
            raise IndexError("slice beyond linear chromosome")
        first = self.flat[off + start : off + ln]
        return np.concatenate([first, self.flat[off : off + length - (ln - start)]])


def _stream_refseq(url: str):
    """Stream a RefSeq assembly directory's ``<dir>_genomic.fna.gz``
    (simulator.py:295-315): ftp is rewritten to http, the header line is
    split on underscores/whitespace with the first token dropped, joined
    with dashes, and truncated at the first dot.

    Yields (chr_name, seq_str).
    """
    import gzip as _gz
    import re as _re
    from urllib.request import Request, urlopen

    http_addr = url.replace("ftp://", "http://").strip()
    dir_name = http_addr.split("/")[-1]
    req = Request(http_addr + "/" + dir_name + "_genomic.fna.gz")
    req.add_header("Accept-Encoding", "gzip")
    response = urlopen(req)
    chr_name = None
    seqs = []
    with _gz.GzipFile(fileobj=response) as f:
        for raw in f:
            line = raw.decode("utf-8").strip()
            if not line:
                continue
            if line[0] == ">":
                if chr_name is not None:
                    yield chr_name, "".join(seqs)
                info = _re.split(r"[_\s]\s*", line)
                chr_name = "-".join(info[1:]).split(".")[0]
                seqs = []
            else:
                seqs.append(line)
    if chr_name is not None:
        yield chr_name, "".join(seqs)


@dataclasses.dataclass
class MetagenomeSet:
    """Multiple species genomes packed into one flat array.

    Chromosomes from all species are concatenated; `species_of_chrom` maps each
    global chromosome index to its species.  Mirrors the nested dicts of the
    reference's metagenome read_profile (simulator.py:284-339).
    """

    packed: PackedGenome
    species_names: list
    species_of_chrom: np.ndarray  # [n_chrom] int32
    chrom_start_of_species: np.ndarray  # [n_species + 1] int32 — chroms grouped by species

    @classmethod
    def from_genome_list(cls, genome_list_path: str, dna_type_list_path=None) -> "MetagenomeSet":
        """Parse the tsv genome list (species\\tfasta_path) and optional
        dna-type list (species\\tchrom\\t{circular|linear}); default topology is
        circular for local files (simulator.py:316-326)."""
        species, paths = [], []
        with open(genome_list_path) as f:
            for line in f:
                if not line.strip():
                    continue
                fields = line.split("\t")
                species.append("_".join(fields[0].split()))
                paths.append(fields[1].strip("\n"))

        all_names, all_seqs, all_species_idx = [], [], []
        chrom_start = [0]
        default_circ = []
        for si, path in enumerate(paths):
            n_before = len(all_names)
            if path.startswith(("ftp", "http")):
                # RefSeq streaming: names pre-mangled by the URL rule,
                # topology defaults to linear (simulator.py:295-311)
                for name, seq in _stream_refseq(path):
                    all_names.append(name)
                    all_seqs.append(_UPPER[np.frombuffer(seq.encode(), dtype=np.uint8)])
                    all_species_idx.append(si)
                    default_circ.append(False)
            else:
                for name, seq, _ in read_fastx(path):
                    all_names.append(mangle_name(name))
                    all_seqs.append(_UPPER[np.frombuffer(seq.encode(), dtype=np.uint8)])
                    all_species_idx.append(si)
                    default_circ.append(True)  # circular by default
            if len(all_names) == n_before:
                raise ValueError(f"no sequences for species {species[si]} in {path}")
            chrom_start.append(len(all_names))

        lengths = np.array([len(s) for s in all_seqs], dtype=np.int64)
        offsets = np.zeros(len(all_seqs) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        circ = np.array(default_circ, dtype=bool)

        if dna_type_list_path:
            import re as _re

            name_to_idx = {}
            for gi, (si, nm) in enumerate(zip(all_species_idx, all_names)):
                name_to_idx[(species[si], nm)] = gi
            with open(dna_type_list_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    fields = line.split("\t")
                    sp = "_".join(fields[0].split())
                    chrom_raw = _re.split(r"[_\s]\s*", fields[1].partition(" ")[0])
                    chrom = "-".join(chrom_raw).split(".")[0]
                    typ = fields[2].strip("\n")
                    if sp not in species:
                        raise ValueError(f"You didn't provide a reference genome for {sp}")
                    key = (sp, chrom)
                    if key in name_to_idx:
                        circ[name_to_idx[key]] = typ == "circular"

        packed = PackedGenome(
            flat=np.concatenate(all_seqs),
            names=all_names,
            lengths=lengths,
            offsets=offsets,
            circular=circ,
        )
        return cls(
            packed=packed,
            species_names=species,
            species_of_chrom=np.array(all_species_idx, dtype=np.int32),
            chrom_start_of_species=np.array(chrom_start, dtype=np.int32),
        )

    def max_chrom_of_species(self) -> np.ndarray:
        out = np.zeros(len(self.species_names), dtype=np.int64)
        for si in range(len(self.species_names)):
            lo, hi = self.chrom_start_of_species[si], self.chrom_start_of_species[si + 1]
            out[si] = self.packed.lengths[lo:hi].max()
        return out

    def total_len_of_species(self) -> np.ndarray:
        out = np.zeros(len(self.species_names), dtype=np.int64)
        for si in range(len(self.species_names)):
            lo, hi = self.chrom_start_of_species[si], self.chrom_start_of_species[si + 1]
            out[si] = self.packed.lengths[lo:hi].sum()
        return out
