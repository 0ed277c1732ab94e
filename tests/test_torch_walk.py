"""The port's error walks against the JAX package's XLA walks, exactly.

Same slot keys, lengths and tables go through `nanosim_tpu.ops.error_walk`
(JAX on the CPU) and `nanosim_tpu_torch.ops.error_walk` (PyTorch on the
CPU); the event prefixes, spans, lengths, counts and overflow flags must be
equal.  The CUDA kernels are held against the plain PyTorch walks on the card
in the `gpu`-marked test.
"""

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
    import dataclasses

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
