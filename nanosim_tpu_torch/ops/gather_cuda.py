"""The packed-code read gather (csrc/gather.cu) and its plain PyTorch version.

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
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary

MAX_LANES = 65535  # the kernel's grid puts the lane on blockIdx.y


def _bind(lib):
    p = ctypes.c_void_p
    lib.launch_gather_codes.argtypes = [p, ctypes.c_int64, p, ctypes.c_int, ctypes.c_int64,
                                        p, p]
    lib.launch_gather_codes.restype = ctypes.c_int


LIBRARY = KernelLibrary("gather.cu", _bind)


def gather_codes_plain(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The byte holding each code (row index clamped to the row), then the
    code's two bits: the kernel's reference."""
    byte = torch.gather(packed, 1, (src >> 2).clamp(0, packed.shape[1] - 1).long())
    return ((byte.to(torch.int32) >> ((src & 3) * 2)) & 3).to(torch.uint8)


def gather_codes(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """packed [B, PB] uint8, src [B, L] int32 -> codes [B, L] uint8: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not src.is_cuda:
        return gather_codes_plain(packed, src)
    if packed.device != src.device:
        raise ValueError(f"gather_codes: packed is on {packed.device}, src on {src.device}")
    if packed.dtype != torch.uint8 or src.dtype != torch.int32:
        raise ValueError(f"gather_codes: needs uint8 packed and int32 src, got "
                         f"{packed.dtype} and {src.dtype}")
    if packed.dim() != 2 or src.dim() != 2 or packed.shape[0] != src.shape[0]:
        raise ValueError(f"gather_codes: shapes {tuple(packed.shape)} and {tuple(src.shape)} "
                         "are not [B, PB] and [B, L]")
    B, L = src.shape
    PB = packed.shape[1]
    if B > MAX_LANES or PB == 0:
        raise ValueError(f"gather_codes: B={B} (at most {MAX_LANES}), PB={PB} (at least 1)")
    lib = LIBRARY.load()
    packed = packed.contiguous()
    src = src.contiguous()
    out = torch.empty((B, L), dtype=torch.uint8, device=src.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(src.device).cuda_stream)
    rc = lib.launch_gather_codes(ctypes.c_void_p(packed.data_ptr()), PB,
                                 ctypes.c_void_p(src.data_ptr()), B, L,
                                 ctypes.c_void_p(out.data_ptr()), stream)
    if rc != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {rc}")
    gather_codes.launches += 1
    return out


gather_codes.launches = 0
