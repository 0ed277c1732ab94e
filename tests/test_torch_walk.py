"""The port's error walks against the JAX package's XLA walks, exactly.

Same slot keys, lengths and tables go through `nanosim_tpu.ops.error_walk`
(JAX on the CPU) and `nanosim_tpu_torch.ops.error_walk` (PyTorch on the
CPU); the event prefixes, spans, lengths, counts and overflow flags must be
equal.  The CUDA kernels are held against the plain PyTorch walks on the card
in the `gpu`-marked test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nanosim_tpu_torch.ops import error_walk as twalk
from nanosim_tpu_torch.ops import rng as trng
from nanosim_tpu_torch.ops import walk_cuda

from test_torch_common import load_both, make_model, port_tables

B = 256


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    prefix = make_model(str(tmp_path_factory.mktemp("walkmodel")))
    return load_both(prefix)


def _slots(n=B):
    return np.arange(1000, 1000 + n, dtype=np.int64)


def _port_keys(seed, n=B, device="cpu"):
    return trng.slot_keys(trng.base_key(seed, device=device),
                          torch.as_tensor(_slots(n), device=device))


def _keys(seed, n=B):
    import jax.numpy as jnp

    from nanosim_tpu.ops import rng as jrng

    jk = jrng.slot_keys(jrng.base_key(seed), jnp.asarray(_slots(n)))
    tk = _port_keys(seed, n)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    return jk, tk


def _mref(seed, hi):
    return np.random.default_rng(seed).integers(0, hi, B).astype(np.int32)


# Aligned walk cases: (e_max, seed, lanes, edge).  The aligned kernel hashes
# and stores 32 steps at a time with one warp per lane, 4 lanes a block, so
# the cases cover budgets below one chunk (20) and one step past it (33),
# and, with `edge`, a batch that is not a multiple of the lanes a block (37)
# holding lanes whose walk ends exactly at step 32 and at step 64 and lanes
# with no step at all (m_ref at or below the first match).
WALK_CASES = [
    pytest.param(256, 3, B, False, id="256-3"),
    pytest.param(24, 5, B, False, id="24-5"),
    pytest.param(20, 15, B, False, id="20-15-below-one-chunk"),
    pytest.param(33, 17, B, False, id="33-17-one-past-a-chunk"),
    pytest.param(96, 19, 37, True, id="96-19-chunk-edges"),
]
EDGE_ENDS = ((slice(0, 3), 32), (slice(3, 6), 64))  # lanes that end at step 32, 64
EDGE_EMPTY = slice(6, 10)  # lanes with no step


def _walk_mref(sk, tt, seed, lanes, edge):
    """m_ref of a walk case: random lengths; with `edge`, the lanes of
    EDGE_ENDS get the reference span the walk has covered after 32 or 64
    steps (so that it stops there), and those of EDGE_EMPTY a span at or
    below their first match."""
    m = torch.as_tensor(_mref(seed, 900)[:lanes], device=sk.device)
    if not edge:
        return m
    wk = trng.site_keys(sk, trng.SITE_WALK)
    fm = twalk.first_match(wk, tt.first_match)
    far = torch.full_like(m, 1 << 30)
    for sel, steps in EDGE_ENDS:
        pos = walk_cuda.aligned_steps_plain(wk, far, fm, tt.match_markov, tt.mixtures, tt.trans,
                                            steps)[1]
        m[sel] = pos[sel]
    m[EDGE_EMPTY] = torch.stack([fm[6], fm[7], torch.zeros_like(fm[8]),
                                 (fm[9] - 1).clamp_min(0)]).to(m.dtype)
    return m


def _compare(jr, tr, fields, width=None):
    """The port's walk against the JAX walk's.  With `width`, the JAX walk
    ran with a larger budget (it takes multiples of its unroll factor only):
    its events are cut to the first `width` steps, and the per-lane finals
    are compared on the lanes that ended within them; the others must be
    the port's overflow lanes."""
    n = np.asarray(jr.n_events)
    done = np.ones(n.shape, bool) if width is None else n <= width
    if width is not None:
        n = np.minimum(n, width)
    np.testing.assert_array_equal(n, tr.n_events.numpy())
    width = width or np.asarray(jr.events_type).shape[1]
    valid = np.arange(width)[None, :] < n[:, None]
    for f in ("events_pos2x", "events_type", "events_len"):
        a = np.asarray(getattr(jr, f))[:, :width]
        b = getattr(tr, f).numpy()
        np.testing.assert_array_equal(np.where(valid, a, 0), b, err_msg=f)
    for f in fields:
        a = np.asarray(getattr(jr, f)).astype(np.int64)
        b = getattr(tr, f).numpy().astype(np.int64)
        if a.ndim == 2:
            np.testing.assert_array_equal(a[:, :width], b, err_msg=f)
        else:
            np.testing.assert_array_equal(a[done], b[done], err_msg=f)
    assert tr.overflow.numpy()[~done].all()


@pytest.mark.parametrize("e_max,seed,lanes,edge", WALK_CASES)
def test_error_walk_matches_jax(tables, e_max, seed, lanes, edge):
    import jax.numpy as jnp

    from nanosim_tpu.ops import error_walk as jwalk

    _, jt, tt = tables
    jk, tk = _keys(seed, lanes)
    m = _walk_mref(tk, tt, seed, lanes, edge).numpy()
    # the JAX walk takes budgets in multiples of its unroll factor
    e_jax = -(-e_max // jwalk.UNROLL) * jwalk.UNROLL
    jr = jwalk.error_walk(jk, jnp.asarray(m), jt.first_match, jt.match_markov,
                          jt.mixtures, jt.trans, e_jax)
    tr = twalk.error_walk(tk, torch.from_numpy(m), tt.first_match, tt.match_markov,
                          tt.mixtures, tt.trans, e_max)
    _compare(jr, tr, ("middle_ref", "l_new", "overflow", "events_valid",
                      "ecnt_mis", "ecnt_ins", "ecnt_match"),
             width=None if e_jax == e_max else e_max)
    if e_max in (24, 20, 33):
        assert tr.overflow.any() and not tr.overflow.all()
    if edge:  # not vacuous: the walks do end at the chunk edges, or take no step
        n = tr.n_events
        for sel, steps in EDGE_ENDS:
            assert (n[sel] == steps).any(), (steps, n[sel])
        assert (n[EDGE_EMPTY] == 0).all() and (n[EDGE_EMPTY.stop:] > 0).all()


@pytest.mark.parametrize("e_max,seed", [(512, 7), (32, 9)])
def test_unaligned_walk_matches_jax(tables, e_max, seed):
    import jax.numpy as jnp

    from nanosim_tpu.ops import error_walk as jwalk

    _, jt, tt = tables
    jk, tk = _keys(seed)
    m = _mref(seed, 300)
    jr = jwalk.unaligned_walk(jk, jnp.asarray(m), jt.mixtures, e_max)
    tr = twalk.unaligned_walk(tk, torch.from_numpy(m), tt.mixtures, e_max)
    _compare(jr, tr, ("middle_ref", "l_new", "overflow", "events_valid"))
    if e_max == 32:
        assert tr.overflow.any() and not tr.overflow.all()


def _padded_tables(tt, n_t=320, K=300, nb=40):
    """The same tables with longer rows and more bins, padded so that every
    count of the walk is unchanged (error-length entries 1.0, break entries
    2.0, bins that start past every match length): the walk is the same, but
    on the card it takes the aligned kernel's general instance (rows of more
    than 256 entries, more than 32 bins)."""
    import torch.nn.functional as F

    mix, mm = tt.mixtures, tt.match_markov
    nb0, K0 = mm.breaks.shape
    mixtures = dataclasses.replace(
        mix, cdf_t=F.pad(mix.cdf_t, (0, n_t - mix.cdf_t.shape[1]), value=1.0))
    match_markov = dataclasses.replace(
        mm, breaks=F.pad(mm.breaks, (0, K - K0, 0, nb - nb0), value=2.0),
        vals=F.pad(mm.vals, (0, K - K0, 0, nb - nb0)),
        n_bk=F.pad(mm.n_bk, (0, nb - nb0), value=1),
        bin_lo=F.pad(mm.bin_lo, (0, nb - nb0), value=1 << 30))
    return match_markov, mixtures


def test_padded_tables_walk_the_same(tables):
    """The padded tables of the card test's general-instance case give the
    plain walk exactly the tables' own walk."""
    _, _, tt = tables
    tk = _port_keys(21)
    wk = trng.site_keys(tk, trng.SITE_WALK)
    fm = twalk.first_match(wk, tt.first_match)
    m = torch.from_numpy(_mref(21, 900))
    mm, mix = _padded_tables(tt)
    want = walk_cuda.aligned_steps_plain(wk, m, fm, tt.match_markov, tt.mixtures, tt.trans, 96)
    got = walk_cuda.aligned_steps_plain(wk, m, fm, mm, mix, tt.trans, 96)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mix.cdf_t.shape[1] > 256 and mm.breaks.shape == (40, 300)


def test_walks_use_plain_version_on_cpu(tables):
    """On CPU tensors the walks' step wrappers run the plain versions and
    launch nothing."""
    _, _, tt = tables
    _, tk = _keys(11)
    m = torch.from_numpy(_mref(11, 500))
    before = (walk_cuda.aligned_steps.launches, walk_cuda.unaligned_steps.launches)
    wk = trng.site_keys(tk, trng.SITE_WALK)
    fm = twalk.first_match(wk, tt.first_match)
    a = twalk.error_walk(tk, m, tt.first_match, tt.match_markov, tt.mixtures, tt.trans, 64)
    b = walk_cuda.aligned_steps_plain(wk, m, fm, tt.match_markov, tt.mixtures, tt.trans, 64)
    assert torch.equal(a.n_events, b[4]) and torch.equal(a.l_new, b[3])
    assert torch.equal(a.middle_ref, b[2]) and torch.equal(a.overflow, b[1] < b[2])
    uk = trng.site_keys(tk, trng.SITE_UNALIGNED_WALK)
    c = twalk.unaligned_walk(tk, m, tt.mixtures, 128)
    d = walk_cuda.unaligned_steps_plain(uk, m, tt.mixtures, 128)
    assert torch.equal(c.n_events, d[4]) and torch.equal(c.l_new, d[3])
    assert torch.equal(c.middle_ref, d[2]) and torch.equal(c.overflow, d[1] < d[2])
    assert (walk_cuda.aligned_steps.launches, walk_cuda.unaligned_steps.launches) == before


# --- the unaligned kernel's scan identity ---------------------------------
#
# The unaligned kernel (csrc/walk.cu) does not walk: each thread takes a step
# of its own, and the positions are one prefix sum of the steps' advances.
# These cases hold that identity, written in plain torch, against the
# step-by-step walks: budgets that are not multiples of the kernel's 128-step
# rounds (40, 200), the chimeric gap budget (7,056) on a few lanes, with
# lanes of no step (m_ref = 0), lanes cut off by the budget and lanes that
# end inside it.  (E, lanes, seed); the card test runs the kernel on them.
UNALIGNED_CASES = [
    pytest.param(40, B, 23, id="40-truncated"),
    pytest.param(200, B, 29, id="200-partial-round"),
    pytest.param(7056, 6, 31, id="7056-gap-budget"),
]
UNALIGNED_EMPTY = slice(0, 3)  # lanes with m_ref = 0


def _unaligned_mref(E, lanes, seed):
    """m_ref of an unaligned case: the first lanes 0, the last one far past
    the budget, the others random up to 1.5 steps a budget step (about half of
    them end inside it)."""
    m = np.random.default_rng(seed).integers(1, max(2, int(1.5 * E)), lanes).astype(np.int32)
    m[UNALIGNED_EMPTY] = 0
    m[-1] = 1 << 20
    return m


def _unaligned_by_scan(walk_keys, m_ref, mixtures, max_steps: int):
    """The unaligned walk as the kernel computes it, with unaligned_steps'
    results: every step's kind and length from its own uniforms, its advance
    d_t (0 for an insertion), P_t the exclusive prefix sum of d, step t taken
    exactly when P_t < m_ref; pos = P_n, middle_ref = max(m_ref, pos), l_new
    = m_ref + the taken steps' (ins: +len, del: -len) + max(pos - m_ref, 0)."""
    E, B = max_steps, m_ref.shape[0]
    U = walk_cuda.step_uniforms(walk_keys, torch.arange(E, dtype=torch.int64), 2)  # [E, B, 2]
    u_type, u_len = U[..., 0], U[..., 1]
    kind = sum((u_type >= torch.tensor(c, dtype=torch.float32)).long() for c in (0.4, 0.7, 0.85))
    etype = (kind - 1).clamp(0, 2)
    sampled = mixtures.sample(etype.reshape(-1), u_len.reshape(-1)).reshape(E, B).long()
    elen = torch.where(kind > 0, sampled, 1)
    is_ins, is_del = kind == 2, kind == 3
    d = torch.where(is_ins, 0, elen)
    signed = torch.where(is_ins, elen, torch.where(is_del, -elen, 0))
    p = torch.cumsum(d, 0) - d
    m = m_ref.long()
    taken = p < m[None, :]
    assert bool((taken[1:] <= taken[:-1]).all())  # the taken steps are a prefix
    pos = (d * taken).sum(0)
    words = torch.where(taken, walk_cuda._word(2 * p + is_ins.long(),
                                               torch.where(kind > 0, elen, 0), etype), 0)
    l_new = m + (signed * taken).sum(0) + (pos - m).clamp_min(0)
    i32 = lambda t: t.to(torch.int32)
    return (words.T.contiguous(), i32(pos), i32(torch.maximum(m, pos)), i32(l_new),
            i32(taken.sum(0)))


@pytest.mark.parametrize("E,lanes,seed", UNALIGNED_CASES)
def test_unaligned_scan_identity(tables, monkeypatch, E, lanes, seed):
    """The prefix-sum form of the unaligned walk equals the port's plain walk
    and the JAX package's XLA walk, on every output."""
    import jax.numpy as jnp

    from nanosim_tpu.ops import error_walk as jwalk

    _, jt, tt = tables
    jk, tk = _keys(seed, lanes)
    m = _unaligned_mref(E, lanes, seed)
    uk = trng.site_keys(tk, trng.SITE_UNALIGNED_WALK)
    got = _unaligned_by_scan(uk, torch.from_numpy(m), tt.mixtures, E)
    want = walk_cuda.unaligned_steps_plain(uk, torch.from_numpy(m), tt.mixtures, E)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jr = jwalk.unaligned_walk(jk, jnp.asarray(m), jt.mixtures, E)
    monkeypatch.setattr(walk_cuda, "unaligned_steps", _unaligned_by_scan)
    tr = twalk.unaligned_walk(tk, torch.from_numpy(m), tt.mixtures, E)
    _compare(jr, tr, ("middle_ref", "l_new", "overflow", "events_valid"))
    # not vacuous: lanes with no step, lanes cut off by the budget, lanes done
    n, over = got[4], got[1] < got[2]
    assert (n[UNALIGNED_EMPTY] == 0).all() and over[-1] and n[-1] == E
    assert (~over[UNALIGNED_EMPTY.stop:]).any()


def _count_less_sorted(row: np.ndarray, u: np.float32) -> int:
    """csrc/walk_common.cuh::count_less_sorted, step for step."""
    base, n = 0, len(row)
    while n > 1:
        half = n >> 1
        base = base + half if row[base + half] < u else base
        n -= half
    return base + int(row[base] < u)


def _mixture_rows_spread():
    """Mixture tables of MixtureDevice.from_params over a spread of
    parameters (Poisson / Weibull scale, Weibull shape, geometric p, weight)."""
    from nanosim_tpu_torch.ops.tables import MixtureDevice
    from nanosim_tpu_torch.profiles.error_model import MixtureParams

    for lam, k, p, w in [(0.3, 0.4, 0.9, 0.0), (1.0, 1.0, 0.5, 0.5), (2.5, 0.8, 0.2, 0.9),
                         (8.0, 2.0, 0.05, 1.0), (30.0, 4.0, 0.7, 0.3), (120.0, 0.6, 0.01, 0.6)]:
        params = MixtureParams(mis=np.array([lam, 0.0, p, w]), ins=np.array([lam, k, p, w]),
                               dele=np.array([lam / 2, k * 1.5, min(p * 2, 0.95), 1 - w]))
        yield f"{lam}-{k}-{p}-{w}", MixtureDevice.from_params(params, "cpu")


def test_mixture_rows_are_sorted_and_searchable(tables):
    """The fixture profile's mixture rows and those of from_params over a
    spread of parameters are non-decreasing, as the unaligned kernel's binary
    search needs; on such rows the first index whose entry is >= u
    (torch.searchsorted, and the kernel's branchless search) is count(row <
    u), for uniforms and for u equal to an entry or next to one."""
    _, _, tt = tables
    rng = np.random.default_rng(37)
    for name, mix in [("fixture", tt.mixtures), *_mixture_rows_spread()]:
        cdf = mix.cdf_t
        assert bool((cdf[:, 1:] >= cdf[:, :-1]).all()), name
        for row in cdf:
            r = row.numpy()
            us = np.concatenate([
                rng.random(300, dtype=np.float32), r, np.nextafter(r, np.float32(0)),
                np.nextafter(r, np.float32(1)), np.float32([0.0, 1.0 - 2**-24])]).astype(np.float32)
            u = torch.from_numpy(us)
            want = (row[None, :] < u[:, None]).sum(1)
            assert torch.equal(torch.searchsorted(row, u, side="left"), want), name
            picks = rng.choice(len(us), 64, replace=False)
            assert [_count_less_sorted(r, us[j]) for j in picks] == want[picks].tolist(), name


def test_mixture_rows_must_be_non_decreasing(tables):
    """A mixture table whose rows are not all non-decreasing is refused where
    it is made, whichever way: rows out of order, a NaN, or parameters (a
    mixture weight outside [0, 1]) whose CDF decreases.  So every table the
    unaligned kernel is given can be searched."""
    from nanosim_tpu_torch.ops.tables import MixtureDevice
    from nanosim_tpu_torch.profiles.error_model import MixtureParams

    _, _, tt = tables
    cdf = tt.mixtures.cdf_t
    shuffled = cdf[:, torch.randperm(cdf.shape[1], generator=torch.Generator().manual_seed(3))]
    nan = cdf.clone()
    nan[1, 5] = float("nan")
    for bad in (shuffled.contiguous(), nan):
        with pytest.raises(ValueError, match="non-decreasing"):
            dataclasses.replace(tt.mixtures, cdf_t=bad)
    ok = np.array([2.0, 1.0, 0.3, 0.5])
    with pytest.raises(ValueError, match="non-decreasing"):
        MixtureDevice.from_params(
            MixtureParams(mis=np.array([2.0, 0.0, 0.3, -2.0]), ins=ok, dele=ok), "cpu")
    assert torch.equal(dataclasses.replace(tt.mixtures, cdf_t=cdf.clone()).cdf_t, cdf)


@pytest.mark.gpu
def test_walk_kernels_match_plain_on_card(tmp_path):
    """Each CUDA kernel equals its plain PyTorch version on the card, on every
    output (run there with: python -m pytest --noconftest -m gpu
    tests/test_torch_walk.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    dev = torch.device("cuda")
    tt = port_tables(str(tmp_path), dev)
    sk = _port_keys(13, device=dev)
    m = torch.as_tensor(_mref(13, 900), device=dev)
    wk = trng.site_keys(sk, trng.SITE_WALK)
    fm = twalk.first_match(wk, tt.first_match)
    uk = trng.site_keys(sk, trng.SITE_UNALIGNED_WALK)
    # the aligned walk on the inputs of every case of test_error_walk_matches_jax
    for case in WALK_CASES:
        e_max, seed, lanes, edge = case.values
        csk = _port_keys(seed, lanes, dev)
        cwk = trng.site_keys(csk, trng.SITE_WALK)
        args = (cwk, _walk_mref(csk, tt, seed, lanes, edge),
                twalk.first_match(cwk, tt.first_match), tt.match_markov, tt.mixtures, tt.trans,
                e_max)
        got = walk_cuda.aligned_steps(*args)
        want = walk_cuda.aligned_steps_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), case.id
    # the aligned kernel's general instance: tables past its specialised sizes
    args = (wk, m, fm, *_padded_tables(tt), tt.trans, 96)
    got = walk_cuda.aligned_steps(*args)
    want = walk_cuda.aligned_steps_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for e_max in (24, 256):
        args = (wk, m, fm, tt.match_markov, tt.mixtures, tt.trans, e_max)
        got = walk_cuda.aligned_steps(*args)
        want = walk_cuda.aligned_steps_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        got = walk_cuda.unaligned_steps(uk, m, tt.mixtures, 2 * e_max)
        want = walk_cuda.unaligned_steps_plain(uk, m, tt.mixtures, 2 * e_max)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the unaligned kernel on the scan-identity cases (budgets that are not
    # multiples of its 128-step rounds, lanes of no step beside long ones,
    # lanes cut off by the budget)
    for case in UNALIGNED_CASES:
        E, lanes, seed = case.values
        cuk = trng.site_keys(_port_keys(seed, lanes, dev), trng.SITE_UNALIGNED_WALK)
        cm = torch.as_tensor(_unaligned_mref(E, lanes, seed), device=dev)
        want = walk_cuda.unaligned_steps_plain(cuk, cm, tt.mixtures, E)
        got = walk_cuda.unaligned_steps(cuk, cm, tt.mixtures, E)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), case.id
