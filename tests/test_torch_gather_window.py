"""The windowed byte gather (K8, ops/gather_window.py): `window_starts`
against the JAX package's, the plain version against the JAX package's
windowed gather in interpret mode and against a numpy statement of the
kernel body for every instance (ragged shapes, windows past the row's end, a
W4 tile whose span overflows), and, on the card only, the kernel against the
plain version."""

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)
from nanosim_tpu_torch.ops import gather_window as gw


def _numpy_kernel(packed, idx, ws, w8v):
    """The kernel body of bench/gather_variants.py's make_gather, per lane
    and position, in numpy: the window row wb + (lb >> 7) of the padded
    [P, 128] row, zero past its P rows."""
    B, PB = packed.shape
    P = -(-PB // 128)
    rows = np.zeros((B, P * 128), np.int64)
    rows[:, :PB] = packed
    rows = rows.reshape(B, P, 128)
    L = idx.shape[1]
    out = np.zeros((B, L), np.int32)
    for b in range(B):
        for j in range(L):
            wb = int(ws[b, j // 1024]) >> 9
            lb = min(max((int(idx[b, j]) - (wb << 9)) >> 2, 0), w8v * 128 - 1)
            r = wb + (lb >> 7)
            out[b, j] = rows[b, r, lb & 127] if r < P else 0
    return out


def _inputs(B, L, PB, seed):
    rs = np.random.RandomState(seed)
    packed = rs.randint(0, 256, (B, PB)).astype(np.uint8)
    idx = gw.realistic_idx(B, L, PB * 4, rs)
    return packed, idx


def test_window_starts_match_jax():
    import jax.numpy as jnp

    from nanosim_tpu.ops import window_gather as wg

    packed, idx = _inputs(8, 3072, 900, 1)
    rs = np.random.RandomState(2)
    mask = rs.random_sample(idx.shape) < 0.9
    mask[3, :1024] = False  # a tile with nothing to read
    idx[5, 1500:1600] += 4000  # a lane whose drift overflows the window
    want_ws, want_ov = wg.window_starts(jnp.asarray(idx), jnp.asarray(mask), 3)
    ws, ov = gw.window_starts(torch.as_tensor(idx), torch.as_tensor(mask), 3)
    assert np.array_equal(np.asarray(want_ws), ws.numpy())
    assert np.array_equal(np.asarray(want_ov), ov.numpy())
    assert ov[5] and ws[3, 0] == 0


def test_plain_matches_the_jax_windowed_gather_in_interpret_mode():
    """W8 (the JAX package's window) at ROWS=8 and L a multiple of 1,024, as
    tests/test_fused_v2.py runs it."""
    import jax.numpy as jnp

    from nanosim_tpu.ops import window_gather as wg

    packed, idx = _inputs(8, 2048, 700, 3)
    idx[2, -200:] = 4 * 700 - 1  # the last codes of the row
    ws, _ = wg.window_starts(jnp.asarray(idx), jnp.ones(idx.shape, bool), 2)
    want = np.asarray(wg.gather_bytes_windowed(jnp.asarray(packed), jnp.asarray(idx), ws,
                                               interpret=True))
    got = gw.gather_windowed(torch.as_tensor(packed), torch.as_tensor(idx),
                             torch.as_tensor(np.asarray(ws)), 4, 8)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, packed[np.arange(8)[:, None], idx >> 2])


@pytest.mark.parametrize("kt,w8v", gw.INSTANCES, ids=[f"KT{k}-W{w}" for k, w in gw.INSTANCES])
def test_plain_matches_the_kernel_body_ragged(kt, w8v):
    """B=37 (not a multiple of 8), L=3,000 (not of 1,024): lane 0's last
    window starts past its row (zeros), lane 1 has a tile whose span
    overflows a 2,048-code window (W4 then differs from packed[idx >> 2])."""
    B, L, PB = 37, 3000, 770
    packed, idx = _inputs(B, L, PB, 4)
    idx[1, 1024:1324] = np.minimum(idx[1, 1024:1324] + 2500, 4 * PB - 1)
    idx_t = torch.as_tensor(idx)
    ws, _ = gw.window_starts(idx_t, torch.ones_like(idx_t, dtype=torch.bool), 3)
    ws[0, 2] = (PB // 128 + 1) * 128 * 4
    got = gw.gather_windowed(torch.as_tensor(packed), idx_t, ws, kt, w8v)
    want = _numpy_kernel(packed, idx, ws.numpy(), w8v)
    assert np.array_equal(got.numpy(), want)
    assert (want[0, 2048:] == 0).all()
    direct = packed[np.arange(B)[:, None], idx >> 2]
    assert np.array_equal(want[2:], direct[2:])
    assert np.array_equal(want[1] == direct[1], np.full(L, True)) == (w8v == 8)
    assert gw.window_covers(idx_t, ws, w8v) == (w8v == 8)


def test_experiment_inputs_are_the_scripts():
    """The experiment's inputs at a small shape: realistic_idx from
    RandomState(0) after the packed rows, as bench/gather_variants.py draws
    them, and window starts over every position."""
    import jax.numpy as jnp

    from bench.bench_gather import realistic_idx
    from nanosim_tpu.ops import window_gather as wg

    packed, idx, ws, want = gw.experiment_inputs("cpu", B=8, L=2048, PB=600)
    rs = np.random.RandomState(0)
    assert np.array_equal(packed.numpy(), rs.randint(0, 256, (8, 600)).astype(np.uint8))
    ridx = realistic_idx(8, 2048, 2400, rs)
    assert np.array_equal(idx.numpy(), ridx)
    jws, _ = wg.window_starts(jnp.asarray(ridx), jnp.ones(ridx.shape, bool), 2)
    assert np.array_equal(ws.numpy(), np.asarray(jws))
    assert np.array_equal(want.numpy(), packed.numpy()[np.arange(8)[:, None], ridx >> 2])


def test_wrapper_refuses_an_instance_it_does_not_have():
    packed, idx = _inputs(8, 1024, 300, 5)
    idx_t = torch.as_tensor(idx)
    ws, _ = gw.window_starts(idx_t, torch.ones_like(idx_t, dtype=torch.bool), 1)
    with pytest.raises(ValueError, match="no instance"):
        gw.gather_windowed(torch.as_tensor(packed), idx_t, ws, 8, 8)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the windowed gather is a CUDA kernel")
    packed, idx, ws, want = gw.experiment_inputs("cuda", B=64, L=5000, PB=1300)
    for kt, w8v in gw.INSTANCES:
        got = gw.gather_windowed(packed, idx, ws, kt, w8v)
        torch.cuda.synchronize()
        assert torch.equal(got, gw.gather_windowed_plain(packed, idx, ws, w8v))
    assert torch.equal(gw.gather_windowed(packed, idx, ws, 4, 8), want)
