"""K1, the aligned error walk (`nanosim_tpu_torch/csrc/walk.cu`,
`aligned_walk_kernel`): its operations and bytes.

Operations of one step, counted from the kernel source at the least the
step needs (copied from the port's record-keeping script): a threefry-2x32
hash is 20 rounds of add, rotate and xor plus five key injections of two
adds and the two initial adds, 72 integer operations; a step hashes four
times (its folded key and three draws); a uniform from 32 bits is a shift
and an or (integer) and a subtract (float32); a lookup in a sorted row of n
entries is a binary search; the state arithmetic of a step (overshoot,
clamps, the event word, the loop test) is 40 integer operations, counted by
hand.  A launch's steps are the steps its lanes walked (the sum of their
event counts), not the budget.
"""

from __future__ import annotations

from .peaks import bound_s, lookup_ops

THREEFRY_INT_OPS = 72
ALIGNED_STATE_INT_OPS = 40

# where the benchmark finds the kernel's launches and device time
MODULE = "nanosim_tpu_torch.ops.walk_cuda"
FUNCTION = "aligned_steps"
TRACE_NAME = "aligned_walk_kernel"
TRACE_NOT = "unaligned"


def ops_per_step(n_t: int, nb: int, K: int):
    """(integer, float32) operations of one aligned step: four hashes, three
    uniforms, the transition row (3 float compares), the mixture row, the
    match-length bin (integer compares) and the bin's break row."""
    ints = 4 * THREEFRY_INT_OPS + 3 * 2 + lookup_ops(nb) + ALIGNED_STATE_INT_OPS
    f32 = 3 + 3 + lookup_ops(n_t) + lookup_ops(K)
    return ints, f32


def launch_bound_s(B: int, steps: int, n_t: int, nb: int, K: int):
    """(seconds, bound by) of one launch of B lanes that walked `steps`
    steps in all: the tables and per-lane inputs read once, each lane's
    event prefix and four per-lane words written once."""
    ints, f32 = (steps * c for c in ops_per_step(n_t, nb, K))
    in_bytes = B * (8 + 4 + 4) + 4 * (3 * n_t + 2 * nb * K + 2 * nb + 21)
    out_bytes = 4 * steps + 4 * 4 * B
    return bound_s(in_bytes + out_bytes, ints, f32)


def describe(args, result) -> dict:
    """What the bound needs of one launch: its arguments (walk keys, m_ref,
    first match, match table, mixtures, transitions, budget) and its result
    (words, pos, middle_ref, l_new, event counts), whose counts are summed
    after the window."""
    match_markov, mixtures = args[3], args[4]
    nb, K = match_markov.breaks.shape
    return {"B": int(args[1].shape[0]), "n_t": int(mixtures.cdf_t.shape[1]), "nb": int(nb),
            "K": int(K), "steps": result[4]}


def bound_of(launch: dict) -> float:
    steps = int(launch["steps"].long().sum())
    return launch_bound_s(launch["B"], steps, launch["n_t"], launch["nb"], launch["K"])[0]
