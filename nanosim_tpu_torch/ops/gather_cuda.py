"""The read path's gathers (csrc/gather.cu) and their plain PyTorch versions:
the packed-code gather of the fused read and the element gather of the
unfused (homopolymer-mode) path.

`gather_codes(packed, src)` returns, per lane b and position j, the 2-bit
code ``src[b, j]`` of the lane's packed reference row (4 codes per byte, code
4w+k at bits 2k of byte w), as uint8.  For a tensor on the CPU it runs the
plain version in this module; for a CUDA tensor it launches the kernel or
raises — there is no fallback.  ``gather_codes.launches`` counts the kernel's
launches.

The kernel replaces the JAX package's windowed TPU gather, and its result
does not depend on a window: the JAX package's output is window-invariant by
construction (lanes that overflow the window are re-run without it), and on
the CPU it runs the window-free ``take_along_axis`` branch that the plain
version here reproduces.

`gather_u8(parts, idx)` is ``take_along_axis(parts, idx, axis=1)`` on 1-byte
or 2-byte integer elements with ``idx`` already clipped to the row: the plain
version (`gather_u8_plain`, a torch.gather) for CPU tensors, the second kernel of
csrc/gather.cu for CUDA tensors, counted in ``gather_u8.launches`` (and per
element width in ``gather_u8.launches_by_width``).  It
replaces the JAX package's one-hot TPU gather, whose packed-code variant is
`gather_codes_unpacked` here: `pack_codes` followed by the packed-code kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary, current_raw_stream


def _bind(lib):
    p = ctypes.c_void_p
    for fn in (lib.launch_gather_codes, lib.launch_gather_u8, lib.launch_gather_u16):
        fn.argtypes = [p, ctypes.c_int64, p, ctypes.c_int, ctypes.c_int64, p, p]
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("gather.cu", _bind)


def gather_codes_plain(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The byte holding each code (row index clamped to the row), then the
    code's two bits: the kernel's reference."""
    byte = torch.gather(packed, 1, (src >> 2).clamp(0, packed.shape[1] - 1).long())
    return ((byte.to(torch.int32) >> ((src & 3) * 2)) & 3).to(torch.uint8)


def gather_codes(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """packed [B, PB] uint8, src [B, L] int32 -> codes [B, L] uint8: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.

    The launch path reads each attribute once: the read-emitting program
    calls it once per batch, and at small shapes its host time is the
    call's."""
    if not src.is_cuda:
        return gather_codes_plain(packed, src)
    if packed.dtype is not torch.uint8 or src.dtype is not torch.int32:
        raise ValueError(f"gather_codes: needs uint8 packed and int32 src, got "
                         f"{packed.dtype} and {src.dtype}")
    shape, pshape = src.shape, packed.shape
    if len(shape) != 2 or len(pshape) != 2 or pshape[0] != shape[0] or pshape[1] == 0:
        raise ValueError(f"gather_codes: shapes {tuple(pshape)} and {tuple(shape)} "
                         "are not [B, PB] and [B, L] with PB at least 1")
    dev = src.get_device()
    if packed.get_device() != dev:
        raise ValueError(f"gather_codes: packed is on {packed.device}, src on {src.device}")
    launch = LIBRARY.load().launch_gather_codes  # typed when the library loads
    if not packed.is_contiguous():
        packed = packed.contiguous()
    if not src.is_contiguous():
        src = src.contiguous()
    out = src.new_empty(shape, dtype=torch.uint8)
    rc = launch(packed.data_ptr(), pshape[1], src.data_ptr(), shape[0], shape[1], out.data_ptr(),
                current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {rc}")
    gather_codes.launches += 1
    return out


gather_codes.launches = 0


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
    """take_along_axis(codes, idx, axis=1) for 2-bit codes: 4-per-byte packing,
    then the packed-code gather.  codes: [B, W] integers 0..3; idx int32,
    clipped to [0, W).  Returns [B, L] int32."""
    return gather_codes(pack_codes(codes), idx.to(torch.int32)).to(torch.int32)


def gather_u8_plain(parts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """torch.gather with an int64 index: the kernel's reference (it raises on
    an index outside the row)."""
    return torch.gather(parts, 1, idx.long())


_ROW = {}  # element dtype -> (bound launcher, element bytes)


def _row_launchers() -> dict:
    """The element gather's launchers by element dtype, resolved and typed
    once, when the library loads."""
    if not _ROW:
        lib = LIBRARY.load()
        for dtypes, fn, es in (((torch.uint8, torch.int8, torch.bool), lib.launch_gather_u8, 1),
                               ((torch.int16, torch.uint16), lib.launch_gather_u16, 2)):
            _ROW.update({dt: (fn, es) for dt in dtypes})
    return _ROW


def gather_u8(parts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """parts [B, W] of 1-byte (uint8, int8, bool) or 2-byte (int16, uint16)
    elements, idx [B, L] int32 in [0, W) -> out[b, j] = parts[b, idx[b, j]]:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    The launch path reads each attribute once: it runs once per batch on
    the read-emitting routes, where its host time is of the order of the
    kernel's device time."""
    if not idx.is_cuda:
        return gather_u8_plain(parts, idx)
    row = _ROW or _row_launchers()
    dtype = parts.dtype
    entry = row.get(dtype)
    if entry is None or idx.dtype is not torch.int32:
        raise ValueError(f"gather_u8: needs 1- or 2-byte integer parts and int32 idx, got "
                         f"{dtype} and {idx.dtype}")
    shape, pshape = idx.shape, parts.shape
    if len(shape) != 2 or len(pshape) != 2 or pshape[0] != shape[0] or pshape[1] == 0:
        raise ValueError(f"gather_u8: shapes {tuple(pshape)} and {tuple(shape)} "
                         "are not [B, W] and [B, L] with W at least 1")
    dev = idx.get_device()
    if parts.get_device() != dev:
        raise ValueError(f"gather_u8: parts is on {parts.device}, idx on {idx.device}")
    if not parts.is_contiguous():
        parts = parts.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    out = idx.new_empty(shape, dtype=dtype)
    launch, es = entry
    rc = launch(parts.data_ptr(), pshape[1], idx.data_ptr(), shape[0], shape[1], out.data_ptr(),
                current_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {rc}")
    gather_u8.launches += 1
    by_width = gather_u8.launches_by_width
    by_width[es] = by_width.get(es, 0) + 1
    return out


gather_u8.launches = 0
gather_u8.launches_by_width = {}  # element bytes (1 or 2) -> launches at that width
