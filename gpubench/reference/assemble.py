"""Read assembly in plain PyTorch: a frozen copy of the port's plain version
of its assembly kernel (K5): head bases | mutated middle | tail bases, the
strand flip riding along, as 16-bit base|class values."""

from __future__ import annotations

import torch

from . import seqops


def assemble_rolls(packed_mid, packed_ht, head, l_new, total, is_rev, l_out: int):
    """One gather from the concatenation [packed_mid | packed_ht]: output
    position j maps to the pre-reverse coordinate jj (j, or total-1-j on
    reversed lanes) and selects its part index arithmetically."""
    l_cap = packed_mid.shape[1]
    ht_cap = packed_ht.shape[1]
    parts = torch.cat([packed_mid, packed_ht], dim=1)  # [B, l_cap + ht_cap]
    j = torch.arange(l_out, dtype=torch.int32, device=packed_mid.device)[None, :]
    headc = head[:, None]
    l_newc = l_new[:, None]
    totalc = total[:, None]
    rev = is_rev[:, None]
    jj = torch.where(rev, totalc - 1 - j, j)  # pre-reverse coord
    in_head = jj < headc
    in_mid = (jj >= headc) & (jj < headc + l_newc)
    idx = torch.where(in_mid, jj - headc,
                      torch.where(in_head, l_cap + jj, l_cap + jj - l_newc))
    fetched = torch.gather(parts, 1, idx.clamp(0, l_cap + ht_cap - 1).long())
    base = (fetched & 0xFF).to(torch.uint8)
    base = torch.where(rev, seqops.complement(base), base)
    out = (fetched & ~0xFF) | base.to(fetched.dtype)
    return torch.where(j < totalc, out, 0).to(packed_mid.dtype)
