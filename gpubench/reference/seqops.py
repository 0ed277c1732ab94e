"""Elementwise sequence ops: IUPAC resolution and reverse complement.

All operate on [B, L] uint8 ASCII buffers with per-lane valid lengths.  The
maps are 256-entry lookup tables indexed by the byte (a gather is cheap on a
GPU); what they compute is the JAX package's compare/select chains, value for
value.
"""

from __future__ import annotations

import torch

# IUPAC candidate sets (case_convert, simulator.py:743-755), in the order the
# uniform draw picks from
_IUPAC = {
    "Y": "CT", "R": "AG", "W": "AT", "S": "GC", "K": "TG", "M": "CA",
    "D": "AGT", "V": "ACG", "H": "ACT", "B": "CGT",
    "N": "ATCG", "X": "ATCG",
}


def _tables():
    """(count [256] int32, options [256 * 4] uint8, complement [256] uint8).

    A byte outside the IUPAC sets (A, C, G, T included) has count 1 and
    itself as its only option, so it passes through."""
    cnt = torch.ones(256, dtype=torch.int32)
    opts = torch.arange(256, dtype=torch.uint8)[:, None].repeat(1, 4)
    for ch, o in _IUPAC.items():
        cnt[ord(ch)] = len(o)
        # slots past the set repeat its last option (never drawn)
        opts[ord(ch)] = torch.tensor([ord(c) for c in (o + 3 * o[-1])[:4]], dtype=torch.uint8)
    comp = torch.arange(256, dtype=torch.uint8)
    for a, b in ("AT", "TA", "CG", "GC"):
        comp[ord(a)] = ord(b)
    return cnt, opts.reshape(-1), comp


_CNT, _OPTS, _COMP = _tables()


def resolve_iupac(seq: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """ASCII + uniforms -> ASCII with ambiguity codes randomized (uniform
    choice among the candidate set, like the reference's random.choice).
    Non-IUPAC characters pass through."""
    s = seq.long()
    cnt = _CNT.to(seq.device)[s]
    # float32 uniform times int32 count is a float32 product, as in JAX
    idx = torch.minimum(torch.floor(u * cnt).to(torch.int32), cnt - 1)
    return _OPTS.to(seq.device)[s * 4 + idx]


def complement(seq: torch.Tensor) -> torch.Tensor:
    """A<->T, C<->G; other characters unchanged (simulator.py:1675-1680)."""
    return _COMP.to(seq.device)[seq.long()]


_CHOICE_ASCII = torch.tensor(list(b"ATCG"), dtype=torch.uint8)


def to_uracil(seq: torch.Tensor) -> torch.Tensor:
    """T -> U and t -> u (direct RNA reads); every other byte unchanged."""
    out = torch.where(seq == ord("T"), ord("U"), seq)
    return torch.where(seq == ord("t"), ord("u"), out).to(torch.uint8)


def random_bases(u: torch.Tensor) -> torch.Tensor:
    """uniforms -> ASCII bases, uniform over A/T/C/G (np.random.choice order)."""
    idx = torch.floor(u * 4.0).to(torch.int32).clamp_max(3)
    return _CHOICE_ASCII.to(u.device)[idx.long()]


def reverse_complement(seq: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-lane reverse complement of the valid prefix; padding stays 0."""
    L = seq.shape[1]
    j = torch.arange(L, device=seq.device)[None, :]
    src = (lengths.long()[:, None] - 1 - j).clamp(0, L - 1)
    out = complement(torch.gather(seq, 1, src))
    return torch.where(j < lengths[:, None], out, torch.zeros_like(out))


def reverse_quals(quals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-lane reversal (for base_quals.reverse() on reversed reads)."""
    L = quals.shape[1]
    j = torch.arange(L, device=quals.device)[None, :]
    src = (lengths.long()[:, None] - 1 - j).clamp(0, L - 1)
    out = torch.gather(quals, 1, src)
    return torch.where(j < lengths[:, None], out, torch.zeros_like(out))
