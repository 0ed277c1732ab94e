"""K3, the packed-code read gather (`nanosim_tpu_torch/csrc/gather.cu`,
`gather_codes_kernel`): its bytes.  Each input byte read once (the packed
reference rows, [B, PB] bytes; the source positions, [B, L] int32), each
output byte written once ([B, L] codes)."""

from __future__ import annotations

from .peaks import bound_s

MODULE = "nanosim_tpu_torch.ops.gather_cuda"
FUNCTION = "gather_codes"
TRACE_NAME = "gather_codes_kernel"
TRACE_NOT = None


def launch_bound_s(B: int, L: int, PB: int):
    return bound_s(B * PB + 4 * B * L + B * L, 0, 0)


def describe(args, result) -> dict:
    packed, src = args[0], args[1]
    return {"B": int(src.shape[0]), "L": int(src.shape[1]), "PB": int(packed.shape[1])}


def bound_of(launch: dict) -> float:
    return launch_bound_s(launch["B"], launch["L"], launch["PB"])[0]
