"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit), and the least time a launch can take on them.

Copied from the port's record-keeping script, with the derivation: the
67 TFLOP/s float32 peak counts a fused multiply-add as two operations over
128 float32 lanes per SM, so the float32 pipe issues 33.5e12 instructions
(a compare, a subtract) per second; Hopper has 64 int32 lanes per SM, half
that.  HBM3 moves 3.35 TB/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.75e12


def lookup_ops(n: int) -> int:
    """Compares of a binary search in a sorted row of n entries."""
    return (n - 1).bit_length() + 1


def bound_s(n_bytes: int, int_ops: int, f32_ops: int):
    """The least time on the card: bytes over the memory rate, or the
    integer and float32 pipes' operations over their instruction rates,
    whichever is larger (the two pipes may overlap, so each is its own
    bound).  Returns (seconds, "bytes" or "operations")."""
    bytes_s = n_bytes / HBM_BYTES_PER_S
    ops_s = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S)
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"
