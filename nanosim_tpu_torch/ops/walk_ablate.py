"""The fixed-step aligned walk with parts of the step switched off
(csrc/walk_ablate.cu) and its plain PyTorch version: the measuring kernels
that say what one walk step costs.

Two experiments share one templated kernel:

* `walk_ablation(variant, ...)`: which part of a step costs what.  `full` is
  the whole step; `nothreefry` fixes the three uniforms at 0.5; `nodma` stores
  no event words; `onlymatch` replaces the transition and mixture lookups by
  ``etype = u_err < 0.5, elen = 1 + etype``; `onlytables` runs both table
  groups (it is the same program as `full`: the experiment this replaces
  switched it so, and the pair measures the run-to-run spread); `min` has no
  table work at all (``mstep = int(u_match * 20)``).
* `walk_row_select(variant, ...)`: how a lane finds the next match length
  from (bin, u_match).  `scan` counts over all K breakpoints of the row in
  shared memory (what csrc/walk.cu does); `search` is a binary search over
  the row's n_bk sorted breakpoints in shared memory; `global` is the same
  search through the read-only cache with the match tables not staged; `min`
  does no match-table work.  `scan`, `search` and `global` compute the same
  function and must agree bit for bit.

Every lane starts at ``pos = prev_match = first_match`` in state 0 with the
same `m_ref` (10**8 in the experiments, so that every lane takes every step);
step t (from 1) draws three uniforms from ``fold_in(walk_key, t)``; the step
is the aligned walk's (ops/walk_cuda.py::aligned_step_arith).  Results:
the event words STEP-MAJOR ``[E, B]`` (``pos2x | len << 19 | type << 30``,
wrapping as uint32: at 8,192 steps ``2 * pos`` passes 19 bits), None for a
variant that stores none; ``pos + l_new + n_events`` per lane; and the xor of
the lane's words, so that a variant without the store still has to compute
them.

The wrappers run the plain version for CPU tensors and launch the kernel or
raise for CUDA tensors: there is no fallback.  Each counts its launches
(``walk_ablation.launches``, and per variant ``launches_by_variant``).  The
plain version is for the tests and the on-card comparison only.
"""

from __future__ import annotations

import ctypes

import torch

from . import rng, walk_cuda
from .cuda_build import KernelLibrary
from .walk_cuda import MASK32, _as_u32_words, _check_cuda, _ptr

M_REF = 10**8  # far beyond any step count: every lane stays active
FIRST_MATCH = 2
MATCH_MODES = {"none": 0, "scan": 1, "search": 2, "global": 3}

# variant -> (threefry, error tables, match mode, event store)
ABLATION_VARIANTS = {
    "full": (True, True, "scan", True),
    "nothreefry": (False, True, "scan", True),
    "nodma": (True, True, "scan", False),
    "onlymatch": (True, False, "scan", True),
    "onlytables": (True, True, "scan", True),
    "min": (True, False, "none", True),
}
ROW_SELECT_VARIANTS = {
    "scan": (True, True, "scan", True),
    "search": (True, True, "search", True),
    "global": (True, True, "global", True),
    "min": (True, True, "none", True),
}
ROW_SELECT_EXACT = ("scan", "search", "global")


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.launch_fixed_walk.argtypes = [i, i, i, i, p, i, i, p, i, p, p, p, p, i, i, p, i, i,
                                      p, p, p, p]
    lib.launch_fixed_walk.restype = ctypes.c_int


LIBRARY = KernelLibrary("walk_ablate.cu", _bind)


def _as_i32(w: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 with the same bits."""
    w = w & MASK32
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def fixed_walk_plain(switches, walk_keys, match_markov, mixtures, trans, n_steps: int,
                     m_ref: int = M_REF, first_match: int = FIRST_MATCH):
    """Plain PyTorch fixed-step walk under `switches` = (threefry, error
    tables, match mode, event store): the kernel's reference."""
    threefry, err_tables, match, store = switches
    B, E = walk_keys.shape[0], int(n_steps)
    dev = walk_keys.device
    i32 = dict(dtype=torch.int32, device=dev)
    pos = torch.full((B,), first_match, **i32)
    middle_ref = torch.full((B,), m_ref, **i32)
    l_new = middle_ref.clone()
    state = torch.zeros(B, **i32)
    prev_match = pos.clone()
    n_events = torch.zeros(B, **i32)
    words = torch.zeros((E, B), **i32) if store else None
    acc = torch.zeros(B, dtype=torch.int64, device=dev)
    half = torch.full((B,), 0.5, dtype=torch.float32, device=dev)
    for t0 in range(1, E + 1, walk_cuda.UNROLL):
        ts = torch.arange(t0, min(t0 + walk_cuda.UNROLL, E + 1), dtype=torch.int64, device=dev)
        U = walk_cuda.step_uniforms(walk_keys, ts, 3) if threefry else None
        for k in range(ts.shape[0]):
            active = pos < middle_ref
            u_err, u_len, u_match = (U[k, :, 0], U[k, :, 1], U[k, :, 2]) if threefry else (
                half, half, half)
            if err_tables:
                etype = trans.sample(state, u_err)
                elen = mixtures.sample(etype, u_len)
            else:
                etype = (u_err < 0.5).to(torch.int32)
                elen = 1 + etype
            if match == "none":
                mstep = (u_match * 20.0).to(torch.int32)
            else:  # scan, search and global: three ways to the same value
                bins = match_markov.select_bin(prev_match)
                mstep = match_markov.invert(bins, u_match).to(torch.int32)
            e_pos2x, pos_n, middle_ref_n, l_new_n, new_state, mstep = walk_cuda.aligned_step_arith(
                pos, middle_ref, l_new, prev_match, etype, elen, mstep)
            # the word wraps as uint32 (negative pos2x, pos2x beyond 19 bits)
            w = ((e_pos2x.long() & MASK32) | (elen.long() << 19) | (etype.long() << 30)) & MASK32
            acc ^= w
            if store:
                words[int(ts[k]) - 1] = _as_i32(w)
            pos = torch.where(active, pos_n, pos)
            middle_ref = torch.where(active, middle_ref_n, middle_ref)
            l_new = torch.where(active, l_new_n, l_new)
            state = torch.where(active, new_state, state)
            prev_match = torch.where(active, mstep, prev_match)
            n_events = n_events + active.to(torch.int32)
    return words, pos + l_new + n_events, _as_i32(acc)


def _fixed_walk(switches, walk_keys, match_markov, mixtures, trans, n_steps: int,
                m_ref: int, first_match: int):
    """Launch the kernel instance for `switches` on CUDA tensors."""
    threefry, err_tables, match, store = switches
    lib = LIBRARY.load()
    dev = walk_keys.device
    B, E = walk_keys.shape[0], int(n_steps)
    wk = _as_u32_words(walk_keys)
    cdf = mixtures.cdf_t.to(torch.float32).contiguous()
    bin_lo = match_markov.bin_lo.to(torch.int32).contiguous()
    breaks = match_markov.breaks.to(torch.float32).contiguous()
    vals = match_markov.vals.to(torch.int32).contiguous()
    n_bk = match_markov.n_bk.to(torch.int32).contiguous()
    cum = trans.cum.to(torch.float32).contiguous()
    _check_cuda("fixed walk", dev, wk, cdf, bin_lo, breaks, vals, n_bk, cum)
    if cum.shape != (7, 3):
        raise ValueError(f"fixed walk: transition table must be [7, 3], got {tuple(cum.shape)}")
    if B <= 0 or E <= 0:
        raise ValueError(f"fixed walk: needs lanes and steps, got B={B} E={E}")
    nb, K = breaks.shape
    ev = torch.empty((E, B) if store else (1,), dtype=torch.int32, device=dev)
    result = torch.empty(B, dtype=torch.int32, device=dev)
    fold = torch.empty(B, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.launch_fixed_walk(
        int(threefry), int(err_tables), MATCH_MODES[match], int(store), _ptr(wk), int(m_ref),
        int(first_match), _ptr(cdf), cdf.shape[1], _ptr(bin_lo), _ptr(breaks), _ptr(vals),
        _ptr(n_bk), nb, K, _ptr(cum), B, E, _ptr(ev), _ptr(result), _ptr(fold), stream)
    if rc != 0:
        raise RuntimeError(f"fixed walk kernel {switches} launch failed: cudaError {rc}")
    return (ev if store else None), result, fold


def _experiment(wrapper, variants, variant, walk_keys, match_markov, mixtures, trans, n_steps,
                m_ref, first_match):
    """One experiment's wrapper body: the plain version for CPU tensors, the
    kernel (counted on `wrapper`) for CUDA tensors."""
    args = (variants[variant], walk_keys, match_markov, mixtures, trans, n_steps, m_ref,
            first_match)
    if not walk_keys.is_cuda:
        return fixed_walk_plain(*args)
    out = _fixed_walk(*args)
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] = wrapper.launches_by_variant.get(variant, 0) + 1
    return out


def walk_ablation(variant: str, walk_keys, match_markov, mixtures, trans, n_steps: int,
                  m_ref: int = M_REF, first_match: int = FIRST_MATCH):
    """The step-ablation experiment: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (words [E, B] i32 or None,
    pos + l_new + n_events [B] i32, xor of the words [B] i32)."""
    return _experiment(walk_ablation, ABLATION_VARIANTS, variant, walk_keys, match_markov,
                       mixtures, trans, n_steps, m_ref, first_match)


def walk_row_select(variant: str, walk_keys, match_markov, mixtures, trans, n_steps: int,
                    m_ref: int = M_REF, first_match: int = FIRST_MATCH):
    """The row-select experiment: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns what `walk_ablation` returns."""
    return _experiment(walk_row_select, ROW_SELECT_VARIANTS, variant, walk_keys, match_markov,
                       mixtures, trans, n_steps, m_ref, first_match)


for _wrapper in (walk_ablation, walk_row_select):
    _wrapper.launches = 0
    _wrapper.launches_by_variant = {}  # variant -> launches


# --- the experiments -----------------------------------------------------------

ABLATION_STEPS = 8192
ROW_SELECT_STEPS = 2048
N_LANES = 1024
EXPERIMENT_SEED = 7


def experiment_keys(device, n_lanes: int = N_LANES, seed: int = EXPERIMENT_SEED) -> torch.Tensor:
    """The experiments' walk keys: slots 0..n_lanes-1 of the aligned stream."""
    slots = torch.arange(n_lanes, dtype=torch.int64, device=device)
    sk = rng.slot_keys(rng.base_key(seed, rng.STREAM_ALIGNED, device=device), slots)
    return rng.site_keys(sk, rng.SITE_WALK)


def _time_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def measure_step_costs(tables, device="cuda", n_lanes: int = N_LANES,
                       ablation_steps: int = ABLATION_STEPS,
                       row_select_steps: int = ROW_SELECT_STEPS, launches: int = 5) -> dict:
    """Run both experiments on the card: every variant's time per launch
    (CUDA events, `launches` launches after a warm-up) and per lane-step, the
    three differences the ablation was written for, and whether the exact
    row-select variants agree bit for bit.  `tables` is a SimTables on
    `device`.  Raises without a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the walk experiments measure the card")
    wk = experiment_keys(device, n_lanes)
    t = (tables.match_markov, tables.mixtures, tables.trans)
    out = {"n_lanes": n_lanes, "ablation": {}, "row_select": {}}
    for name, fn, variants, steps in (
            ("ablation", walk_ablation, ABLATION_VARIANTS, ablation_steps),
            ("row_select", walk_row_select, ROW_SELECT_VARIANTS, row_select_steps)):
        for v in variants:
            ms = _time_ms(lambda: fn(v, wk, *t, steps), launches)
            out[name][v] = {"steps": steps, "ms": ms,
                            "ns_per_lane_step": ms * 1e6 / (steps * n_lanes)}
    a = out["ablation"]
    out["differences_ms"] = {
        "full - nothreefry": a["full"]["ms"] - a["nothreefry"]["ms"],
        "full - nodma": a["full"]["ms"] - a["nodma"]["ms"],
        "full - min": a["full"]["ms"] - a["min"]["ms"],
    }
    got = {v: walk_row_select(v, wk, *t, row_select_steps) for v in ROW_SELECT_EXACT}
    torch.cuda.synchronize()
    out["exact_variants_agree"] = all(
        torch.equal(x, y) for v in ROW_SELECT_EXACT[1:] for x, y in zip(got[v], got["scan"]))
    return out


def main(argv=None):
    """`python -m nanosim_tpu_torch.ops.walk_ablate -c <model prefix>`: both
    experiments on the card with the model's tables, one line per variant."""
    import argparse
    import json

    from ..profiles import profile
    from ..sim.bundles import build_tables

    ap = argparse.ArgumentParser(prog="walk_ablate", description=main.__doc__)
    ap.add_argument("-c", "--model_prefix", default="training")
    args = ap.parse_args(argv)
    prof = profile.load_profile(args.model_prefix, mode="genome", chimeric=True)
    res = measure_step_costs(build_tables(prof, torch.device("cuda")))
    for exp in ("ablation", "row_select"):
        for v, r in res[exp].items():
            print(f"{exp} {v}: {r['ms']:.3f} ms for {r['steps']} steps x {res['n_lanes']} lanes, "
                  f"{r['ns_per_lane_step']:.4f} ns per lane-step")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
