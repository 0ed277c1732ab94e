"""Batched reference extraction: position sampling + gathers.

Replaces the reference's per-read string slicing (`extract_read`,
simulator.py:1694-1781).  The genome lives on the device as one flat uint8
ASCII array; start positions are sampled per lane with the reference's
semantics (uniform over the concatenated genome, rejecting reads that span a
chromosome boundary; circular chromosomes wrap), and the read-emitting
programs turn a lane's reference segment into a [B, L] gather.  (The
meta-only program reads no genome bytes: the host reconstructs them.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .genome import PackedGenome
from . import rng

CHUNK = 256
# The flat array is padded with 'A' to a multiple of 4 MiB, as the JAX
# package pads its 2-bit upload to 1 MiB of packed bytes; no gather reaches
# the padding inside a chromosome, but the chunked gather's clip point (the
# last chunk) then matches it too.
_PAD_TO = 4 << 20


@dataclasses.dataclass
class GenomeDevice:
    """Device-resident packed genome."""

    flat: torch.Tensor  # [padded total] uint8 ASCII ('A' past the genome)
    flat_chunks: torch.Tensor  # [padded total / CHUNK, CHUNK] view of flat
    offsets: torch.Tensor  # [n_chrom + 1] int64
    lengths: torch.Tensor  # [n_chrom] int64
    circular: torch.Tensor  # [n_chrom] bool
    genome_len: int

    @classmethod
    def from_packed(cls, g: PackedGenome, device) -> "GenomeDevice":
        n = len(g.flat)
        flat = np.full(max(-(-n // _PAD_TO), 1) * _PAD_TO, ord("A"), np.uint8)
        flat[:n] = g.flat
        flat_dev = torch.as_tensor(flat, device=device)
        return cls(
            flat=flat_dev,
            flat_chunks=flat_dev.view(-1, CHUNK),
            offsets=torch.as_tensor(g.offsets, dtype=torch.int64, device=device),
            lengths=torch.as_tensor(g.lengths, dtype=torch.int64, device=device),
            circular=torch.as_tensor(g.circular, dtype=torch.bool, device=device),
            genome_len=g.total_len,
        )



def sample_genome_positions(
    slot_keys: torch.Tensor,  # [B, 2]
    lengths: torch.Tensor,  # [B] int32 middle_ref per lane
    genome: GenomeDevice,
    dna_type_circular: bool,
    n_retries: int = 8,
    site: int = rng.SITE_POSITION,
):
    """Sample start positions, genome mode (simulator.py:1750-1781).

    Linear: uniform global position over the concatenated genome, rejected
    unless the read fits inside one chromosome; up to `n_retries` fresh draws
    per lane (the reference retries unboundedly; failures here surface in
    `ok` and the slot is rejected upstream).

    Circular (single chromosome): any position, wraps.

    Returns (chrom [B] i32, local_pos [B] i64, ok [B] bool).
    """
    B = slot_keys.shape[0]
    dev = slot_keys.device
    pos_keys = rng.site_keys(slot_keys, site)
    glen = genome.genome_len

    def draw(r):
        u = rng.uniform_f64(rng.fold_in(pos_keys, r))
        # random.randint(0, genome_len) is inclusive on both ends
        return (u * (glen + 1)).to(torch.int64).clamp_max(glen)

    if dna_type_circular:
        return (torch.zeros(B, dtype=torch.int32, device=dev), draw(0),
                torch.ones(B, dtype=torch.bool, device=dev))

    n_chrom = genome.lengths.shape[0]
    chrom = torch.zeros(B, dtype=torch.int32, device=dev)
    local = torch.zeros(B, dtype=torch.int64, device=dev)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    for r in range(n_retries):
        g = draw(r)
        c = (torch.searchsorted(genome.offsets, g, right=True) - 1).clamp(0, n_chrom - 1)
        lp = g - genome.offsets[c]
        fits = lp + lengths.to(torch.int64) <= genome.lengths[c]
        take = (~ok) & fits
        chrom = torch.where(take, c.to(torch.int32), chrom)
        local = torch.where(take, lp, local)
        ok = ok | fits
    return chrom, local, ok


def gather_segments_padded(genome: GenomeDevice, chrom: torch.Tensor, local_pos: torch.Tensor,
                           l_cap: int):
    """Chunked linear extraction: returns (ref_padded [B, l_cap + CHUNK]
    uint8, off [B] int32) with the segment at ref_padded[b, off[b]:...].

    Whole CHUNK-byte rows are fetched per lane; the residual intra-chunk
    offset is folded into the downstream mutation gather.  Linear
    chromosomes only (circular wrap breaks chunk contiguity — callers use the
    per-byte path there)."""
    B = chrom.shape[0]
    gstart = genome.offsets[chrom.long()] + local_pos  # global byte start
    n_chunks = l_cap // CHUNK + 1
    chunk0 = gstart // CHUNK
    off = (gstart % CHUNK).to(torch.int32)
    idx = (chunk0[:, None] + torch.arange(n_chunks, device=chrom.device)[None, :]).clamp(
        0, genome.flat_chunks.shape[0] - 1)
    return genome.flat_chunks[idx].reshape(B, n_chunks * CHUNK), off


def gather_segments(genome: GenomeDevice, chrom: torch.Tensor, local_pos: torch.Tensor,
                    seg_len: torch.Tensor, l_cap: int) -> torch.Tensor:
    """[B, l_cap] uint8 reference slices with circular wrap (`raw % clen` on
    circular chromosomes); positions >= seg_len are 0."""
    c = chrom.long()
    i = torch.arange(l_cap, dtype=torch.int64, device=chrom.device)[None, :]
    clen = genome.lengths[c][:, None]
    raw = local_pos.long()[:, None] + i
    wrapped = torch.where(genome.circular[c][:, None], raw % clen, raw)
    idx = genome.offsets[c][:, None] + torch.minimum(wrapped, clen - 1)
    seg = genome.flat[idx.clamp(0, genome.flat.shape[0] - 1)]
    return torch.where(i < seg_len[:, None], seg, 0).to(torch.uint8)
