"""The windowed byte gather (K8, ops/gather_window.py): `window_starts`
against the JAX package's, the plain version against the JAX package's
windowed gather in interpret mode and against a numpy statement of the
kernel body for every instance (ragged shapes, windows past the row's end, a
W4 tile whose span overflows), and, on the card only, the kernel against the
plain version."""

import os
import re

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


def test_bulk_copy_needs_16_byte_rows():
    """The launcher alone chooses the copy route: TMA bulk copies only where
    the packed rows' base and length are multiples of 16 bytes (the
    experiment's 4,608-byte rows, not the ragged check's 770-byte ones), and
    it reports the route it took; the wrapper passes none in and reads the
    report."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "nanosim_tpu_torch", "csrc", "gather_window.cu")) as f:
        cu = f.read()
    launcher = cu[cu.index('extern "C" int launch_gather_window('):]
    rule = re.search(r"const bool b = (.*);", launcher).group(1)
    assert rule == "PB % 16 == 0 && (reinterpret_cast<uintptr_t>(packed) & 15) == 0"
    assert "*bulk = b;" in launcher
    assert launcher.count("launch_copy<") == len(gw.INSTANCES)
    assert all("(b, p, PB" in line for line in launcher.splitlines() if "launch_copy<" in line)
    assert 4608 % 16 == 0 and 770 % 16 != 0
    with open(gw.__file__) as f:
        wrapper = f.read()
    assert "% 16" not in wrapper and "bulk.value" in wrapper


@pytest.mark.gpu
@pytest.mark.parametrize("L,PB,route", [(3000, 770, "threads"), (3001, 770, "threads"),
                                        (5000, 1280, "bulk")],
                         ids=["L3000-PB770", "L3001-PB770", "L5000-PB1280"])
@pytest.mark.parametrize("kt,w8v", gw.INSTANCES, ids=[f"KT{k}-W{w}" for k, w in gw.INSTANCES])
def test_kernel_copy_routes_match_plain_on_the_card(kt, w8v, L, PB, route):
    """B = 37 and L not a multiple of 1,024 (3,001: nor of 4, so the rows are
    not 16-byte aligned and every position takes the scalar path): the
    770-byte rows take the threads' copies, the 1,280-byte rows the TMA bulk
    copies; lane 0's last window starts past its row (zeros), lane 1 has a
    tile whose span overflows a W4 window.  Each equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the windowed gather is a CUDA kernel")
    B = 37
    n_tiles = -(-L // gw.TILE)
    packed, idx = _inputs(B, L, PB, 4)
    idx[1, 1024:1324] = np.minimum(idx[1, 1024:1324] + 2500, 4 * PB - 1)
    idx_t = torch.as_tensor(idx, device="cuda")
    ws, _ = gw.window_starts(idx_t, torch.ones_like(idx_t, dtype=torch.bool), n_tiles)
    ws[0, -1] = (PB // 128 + 1) * 128 * 4
    packed_t = torch.as_tensor(packed, device="cuda")
    before = gw.gather_windowed.launches_by_copy.get(route, 0)
    got = gw.gather_windowed(packed_t, idx_t, ws, kt, w8v)
    torch.cuda.synchronize()
    assert torch.equal(got, gw.gather_windowed_plain(packed_t, idx_t, ws, w8v))
    assert gw.gather_windowed.launches_by_copy[route] == before + 1
