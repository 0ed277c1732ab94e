"""The read path's gathers in plain PyTorch: a frozen copy of the port's
plain versions of its gather kernels (K3, the packed-code gather of the
fused read; K4, the element gather of the homopolymer path)."""

from __future__ import annotations

import torch


def gather_codes(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """packed [B, PB] uint8 (code 4w+k at bits 2k of byte w), src [B, L]
    int32 -> codes [B, L] uint8: the byte holding each code (row index
    clamped to the row), then the code's two bits."""
    byte = torch.gather(packed, 1, (src >> 2).clamp(0, packed.shape[1] - 1).long())
    return ((byte.to(torch.int32) >> ((src & 3) * 2)) & 3).to(torch.uint8)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """[B, W] 2-bit codes -> [B, ceil(W/4)] packed uint8 bytes (code k of
    byte w is bits [2k, 2k+2); base index = 4w + k)."""
    B, W = codes.shape
    pad = (-W) % 4
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    c = codes.to(torch.uint8).reshape(B, (W + pad) // 4, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def gather_codes_unpacked(codes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(codes, idx, axis=1) for 2-bit codes: [B, L] int32."""
    return gather_codes(pack_codes(codes), idx.to(torch.int32)).to(torch.int32)


def gather_u8(parts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, j] = parts[b, idx[b, j]], idx already clipped to the row."""
    return torch.gather(parts, 1, idx.long())
