"""The read assembly (csrc/assemble.cu) and its plain PyTorch version.

`assemble_rolls(packed_mid, packed_ht, head, l_new, total, is_rev, l_out)`
returns, per lane, ``head bases | mutated middle | tail bases`` in final
orientation as packed 16-bit ``base | class << 8`` values: reversed lanes are
flipped and their low byte complemented, positions at and beyond ``total``
are 0.  The 16-bit values are held as ``torch.int16`` (classes stay far below
128, so the sign bit is never set; the kernel sees the same bits as uint16).

For tensors on the CPU it runs the plain version in this module, the
concatenate-and-one-gather formulation of the JAX package's `assemble_read`;
for CUDA tensors it launches the kernel or raises — there is no fallback.
``assemble_rolls.launches`` counts the kernel's launches.  The kernel
replaces the JAX package's roll-based TPU assembly kernel and has none of its
restrictions (any batch size).
"""

from __future__ import annotations

import ctypes

import torch

from . import seqops
from .cuda_build import KernelLibrary, current_raw_stream


def _bind(lib):
    p = ctypes.c_void_p
    lib.launch_assemble.argtypes = [p, ctypes.c_int64, p, ctypes.c_int64, p, p, p, p,
                                    ctypes.c_int, ctypes.c_int64, p, p]
    lib.launch_assemble.restype = ctypes.c_int


LIBRARY = KernelLibrary("assemble.cu", _bind)


def assemble_rolls_plain(packed_mid, packed_ht, head, l_new, total, is_rev, l_out: int):
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


def assemble_rolls(packed_mid: torch.Tensor, packed_ht: torch.Tensor, head: torch.Tensor,
                   l_new: torch.Tensor, total: torch.Tensor, is_rev: torch.Tensor,
                   l_out: int) -> torch.Tensor:
    """packed_mid [B, l_cap] and packed_ht [B, ht_cap] int16 base|class,
    head/l_new/total [B] int32, is_rev [B] bool -> [B, l_out] int16: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.

    On the card the call runs one device kernel and nothing else: the output
    is allocated uninitialised and the bool strand flags are passed as the
    bytes they are (0 or 1)."""
    if not packed_mid.is_cuda:
        return assemble_rolls_plain(packed_mid, packed_ht, head, l_new, total, is_rev, l_out)
    args = (packed_mid, packed_ht, head, l_new, total, is_rev)
    dev = packed_mid.get_device()
    if any(a.get_device() != dev for a in args[1:]):
        raise ValueError("assemble_rolls: the inputs lie on different devices")
    if packed_mid.dtype is not torch.int16 or packed_ht.dtype is not torch.int16:
        raise ValueError(f"assemble_rolls: needs int16 packed values, got {packed_mid.dtype} "
                         f"and {packed_ht.dtype}")
    if (head.dtype is not torch.int32 or l_new.dtype is not torch.int32
            or total.dtype is not torch.int32 or is_rev.dtype is not torch.bool):
        raise ValueError("assemble_rolls: needs int32 head, l_new, total and bool is_rev")
    mshape, hshape = packed_mid.shape, packed_ht.shape
    if len(mshape) != 2 or len(hshape) != 2 or hshape[0] != mshape[0]:
        raise ValueError("assemble_rolls: shapes are not [B, l_cap], [B, ht_cap] and [B]")
    B, l_cap, ht_cap = mshape[0], mshape[1], hshape[1]
    lane = (B,)
    if head.shape != lane or l_new.shape != lane or total.shape != lane or is_rev.shape != lane:
        raise ValueError("assemble_rolls: shapes are not [B, l_cap], [B, ht_cap] and [B]")
    if l_cap == 0 or ht_cap == 0 or l_out < 0:
        raise ValueError(f"assemble_rolls: l_cap={l_cap}, ht_cap={ht_cap} (at least 1 each), "
                         f"l_out={l_out} (at least 0)")
    launch = LIBRARY.load().launch_assemble  # typed when the library loads
    mid, ht, head, l_new, total, is_rev = (a if a.is_contiguous() else a.contiguous()
                                           for a in args)
    out = mid.new_empty((B, l_out))
    rc = launch(mid.data_ptr(), l_cap, ht.data_ptr(), ht_cap, head.data_ptr(), l_new.data_ptr(),
                total.data_ptr(), is_rev.data_ptr(), B, l_out, out.data_ptr(),
                current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"assemble kernel launch failed: cudaError {rc}")
    assemble_rolls.launches += 1
    return out


assemble_rolls.launches = 0
