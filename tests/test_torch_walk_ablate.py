"""The fixed-step walk experiments (ops/walk_ablate.py) at a small size.

The plain `full` variant, and the row-select experiment's exact variants, are
the aligned walk itself: they must equal `walk_cuda.aligned_steps_plain`
(which tests/test_torch_walk.py holds against the JAX package's walk) given
first_match = 2, m_ref = 10**8 and the same number of steps, on the event
words and on pos + l_new + n_events.  Each ablated variant is held against a
direct numpy statement of its switch.  Tolerance: equality.  The CUDA kernel
variants are held against the plain versions on the card in the `gpu`-marked
tests.
"""

import numpy as np
import pytest
import torch

from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.ops import walk_ablate, walk_cuda

from test_torch_common import load_both, make_model, port_tables

B = 48
E = 64
MASK32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The port's tables built from the JAX package's table arrays."""
    prefix = make_model(str(tmp_path_factory.mktemp("ablatemodel")))
    return load_both(prefix)[2]


def _walk_keys(device="cpu", seed=7):
    slots = torch.arange(B, dtype=torch.int64, device=device)
    sk = trng.slot_keys(trng.base_key(seed, trng.STREAM_ALIGNED, device=device), slots)
    return trng.site_keys(sk, trng.SITE_WALK)


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t.cpu().numpy().astype(np.int64) & MASK32)


def _numpy_fixed_walk(switches, U, tt, n_steps, first_match=walk_ablate.FIRST_MATCH):
    """A per-lane numpy statement of the fixed-step walk under `switches`,
    given the step uniforms U [E, B, 3]."""
    threefry, err_tables, match, store = switches
    cum = tt.trans.cum.numpy()
    cdf = tt.mixtures.cdf_t.numpy()
    bin_lo = tt.match_markov.bin_lo.numpy()
    breaks = tt.match_markov.breaks.numpy()
    vals = tt.match_markov.vals.numpy()
    n_bk = tt.match_markov.n_bk.numpy()
    n_lanes = U.shape[1]
    words = np.zeros((n_steps, n_lanes), np.int64)
    result = np.zeros(n_lanes, np.int64)
    fold = np.zeros(n_lanes, np.int64)
    for b in range(n_lanes):
        pos = pm = first_match
        mid = lnew = walk_ablate.M_REF
        state = n = 0
        for t in range(n_steps):
            u_err, u_len, u_match = (U[t, b] if threefry else np.full(3, 0.5, np.float32))
            if err_tables:
                et = min(int((cum[state] <= u_err).sum()), 2)
                elen = 1 + int((cdf[et] < u_len).sum())
            else:
                et = int(u_err < np.float32(0.5))
                elen = 1 + et
            if match == "none":
                mstep = int(np.float32(u_match) * np.float32(20.0))
            else:
                bn = min(max(int((bin_lo <= pm).sum()) - 1, 0), len(bin_lo) - 1)
                idx = min(max(int((breaks[bn] <= u_match).sum()) - 1, 0), int(n_bk[bn]) - 1)
                mstep = int(vals[bn, idx])
            if pm == 0 and mstep == 0:
                mstep = 1
            pos2x = 2 * pos - 1 if et == 1 else 2 * pos
            pos_after = pos if et == 1 else pos + elen
            lnew += (elen if et == 1 else -elen if et == 2 else 0) + max(pos_after - mid, 0)
            mid = max(mid, pos_after)
            lnew += max(pos_after + mstep - mid, 0)
            mid = max(mid, pos_after + mstep)
            w = ((pos2x & MASK32) | (elen << 19) | (et << 30)) & MASK32
            words[t, b] = w
            fold[b] ^= w
            pos, pm, state, n = pos_after + mstep, mstep, et + 1 + (3 if mstep == 0 else 0), n + 1
        result[b] = pos + lnew + n
    return (words if store else None), result, fold


def _uniforms(wk, n_steps):
    ts = torch.arange(1, n_steps + 1, dtype=torch.int64)
    return walk_cuda.step_uniforms(wk, ts, 3).numpy()


def _assert_equals_numpy(got, want):
    words, result, fold = got
    w_words, w_result, w_fold = want
    if w_words is None:
        assert words is None
    else:
        assert words.shape == (E, B) and words.dtype == torch.int32
        np.testing.assert_array_equal(_u32(words), w_words)
    np.testing.assert_array_equal(result.numpy().astype(np.int64), w_result)
    np.testing.assert_array_equal(_u32(fold), w_fold)


@pytest.mark.parametrize("variant", sorted(walk_ablate.ABLATION_VARIANTS))
def test_ablation_variant_matches_numpy_statement(tables, variant):
    wk = _walk_keys()
    got = walk_ablate.walk_ablation(variant, wk, tables.match_markov, tables.mixtures,
                                    tables.trans, E)
    want = _numpy_fixed_walk(walk_ablate.ABLATION_VARIANTS[variant], _uniforms(wk, E), tables, E)
    _assert_equals_numpy(got, want)
    assert (got[0] is None) == (variant == "nodma")


@pytest.mark.parametrize("variant", sorted(walk_ablate.ROW_SELECT_VARIANTS))
def test_row_select_variant_matches_numpy_statement(tables, variant):
    wk = _walk_keys(seed=9)
    got = walk_ablate.walk_row_select(variant, wk, tables.match_markov, tables.mixtures,
                                      tables.trans, E)
    want = _numpy_fixed_walk(walk_ablate.ROW_SELECT_VARIANTS[variant], _uniforms(wk, E), tables,
                             E)
    _assert_equals_numpy(got, want)


@pytest.mark.parametrize("experiment,variant",
                         [("ablation", "full"), ("ablation", "onlytables")]
                         + [("row_select", v) for v in walk_ablate.ROW_SELECT_EXACT])
def test_whole_step_variants_are_the_aligned_walk(tables, experiment, variant):
    """`full` (and `onlytables`, the same program) and the exact row-select
    variants equal the aligned walk's plain version from first_match = 2 with
    m_ref = 10**8: words (step-major here, lane-major there) and
    pos + l_new + n_events."""
    wk = _walk_keys(seed=11)
    fn = walk_ablate.walk_ablation if experiment == "ablation" else walk_ablate.walk_row_select
    words, result, fold = fn(variant, wk, tables.match_markov, tables.mixtures, tables.trans, E)
    m_ref = torch.full((B,), walk_ablate.M_REF, dtype=torch.int32)
    fm = torch.full((B,), walk_ablate.FIRST_MATCH, dtype=torch.int32)
    w, pos, _, l_new, n_ev = walk_cuda.aligned_steps_plain(
        wk, m_ref, fm, tables.match_markov, tables.mixtures, tables.trans, E)
    assert torch.equal(words, w.T)
    assert torch.equal(result, pos + l_new + n_ev)
    assert int(n_ev.min()) == E  # every lane took every step
    acc = np.bitwise_xor.reduce(_u32(w), axis=1)
    np.testing.assert_array_equal(_u32(fold), acc)


def test_ablated_variants_differ_from_the_whole_step(tables):
    """Not vacuous: each switch changes the walk."""
    wk = _walk_keys(seed=13)
    args = (wk, tables.match_markov, tables.mixtures, tables.trans, E)
    full = walk_ablate.walk_ablation("full", *args)
    for v in ("nothreefry", "onlymatch", "min"):
        assert not torch.equal(walk_ablate.walk_ablation(v, *args)[1], full[1]), v
    nodma = walk_ablate.walk_ablation("nodma", *args)
    assert torch.equal(nodma[1], full[1]) and torch.equal(nodma[2], full[2])
    assert not torch.equal(walk_ablate.walk_row_select("min", *args)[1], full[1])


def test_word_wraps_as_uint32_past_19_bits(tables):
    """Far enough into the walk 2 * pos passes 19 bits and runs into the
    length field: the plain word is the kernel's uint32 arithmetic."""
    wk = _walk_keys(seed=15)[:4]
    first, steps = 1 << 19, 8
    switches = walk_ablate.ABLATION_VARIANTS["full"]
    words, result, fold = walk_ablate.fixed_walk_plain(
        switches, wk, tables.match_markov, tables.mixtures, tables.trans, steps,
        first_match=first)
    want = _numpy_fixed_walk(switches, _uniforms(wk, steps), tables, steps, first_match=first)
    np.testing.assert_array_equal(_u32(words), want[0])
    np.testing.assert_array_equal(result.numpy().astype(np.int64), want[1])
    np.testing.assert_array_equal(_u32(fold), want[2])
    # pos2x is 2**20 (2**20 - 1 for an insertion) and more: past the 19-bit field
    assert ((_u32(words) & ~(3 << 30)) >= (1 << 20) - 1).all()


def test_wrappers_use_plain_version_on_cpu(tables):
    before = (walk_ablate.walk_ablation.launches, walk_ablate.walk_row_select.launches)
    wk = _walk_keys()
    walk_ablate.walk_ablation("min", wk, tables.match_markov, tables.mixtures, tables.trans, 8)
    walk_ablate.walk_row_select("min", wk, tables.match_markov, tables.mixtures, tables.trans, 8)
    assert (walk_ablate.walk_ablation.launches, walk_ablate.walk_row_select.launches) == before


def _on_card(tmp_path, fn, variants, n_steps):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fixed-step walk kernels have no CPU mode")
    dev = torch.device("cuda")
    tt = port_tables(str(tmp_path), dev)
    wk = _walk_keys(device=dev)
    out = {}
    for v in variants:
        args = (v, wk, tt.match_markov, tt.mixtures, tt.trans, n_steps)
        got = fn(*args)
        want = walk_ablate.fixed_walk_plain(variants[v], *args[1:])
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), v
        out[v] = got
    return out


@pytest.mark.gpu
def test_ablation_kernels_match_plain_on_card(tmp_path):
    """Every step-ablation kernel variant equals its plain version on the card
    (run there with: python -m pytest --noconftest -m gpu
    tests/test_torch_walk_ablate.py)."""
    _on_card(tmp_path, walk_ablate.walk_ablation, walk_ablate.ABLATION_VARIANTS, 96)


@pytest.mark.gpu
def test_row_select_kernels_match_plain_on_card(tmp_path):
    """Every row-select kernel variant equals its plain version on the card,
    and the exact variants equal each other."""
    out = _on_card(tmp_path, walk_ablate.walk_row_select, walk_ablate.ROW_SELECT_VARIANTS, 96)
    for v in walk_ablate.ROW_SELECT_EXACT[1:]:
        for a, b in zip(out[v], out["scan"]):
            assert torch.equal(a, b), v
