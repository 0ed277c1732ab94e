"""K2, the unaligned walk (`nanosim_tpu_torch/csrc/walk.cu`,
`unaligned_walk_kernel`): its operations, copied from the port's
record-keeping script.  No per-layer metric reads it yet."""

from __future__ import annotations

from .k1 import THREEFRY_INT_OPS
from .peaks import lookup_ops

UNALIGNED_STATE_INT_OPS = 25


def unaligned_ops(n_t: int, steps: int, err_steps: int):
    """(integer, float32) operations of the unaligned steps: three hashes and
    two uniforms per step, the three type thresholds, and the mixture row only
    on the steps that drew an error."""
    ints = steps * (3 * THREEFRY_INT_OPS + 2 * 2 + UNALIGNED_STATE_INT_OPS)
    f32 = steps * (2 + 3) + err_steps * lookup_ops(n_t)
    return ints, f32
