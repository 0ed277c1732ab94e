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
