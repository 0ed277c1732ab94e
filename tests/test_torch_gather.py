"""The read path's gathers (packed codes; 1-byte and 2-byte elements): their
plain versions on the CPU, and the CUDA kernels against the plain versions on
the card.

The card-only test imports no JAX; run it on the machine with the card with:
python -m pytest --noconftest -m gpu tests/test_torch_gather.py
"""

import numpy as np
import pytest
import torch

from nanosim_tpu_torch.ops import gather_cuda

from test_torch_common import on_card


def _inputs(B, PB, L, seed):
    """Packed rows and near-contiguous source indices (each lane's output
    position plus a random walk of indel drift), some of them out of the
    row at both ends, made from a seed with numpy."""
    rs = np.random.default_rng(seed)
    packed = rs.integers(0, 256, (B, PB), dtype=np.uint8)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    src = rs.integers(-8, 64, (B, 1)) + np.arange(L)[None, :] + drift
    src[:, :3] = np.array([-5, 4 * PB + 7, 4 * PB - 1])[:L]
    return torch.from_numpy(packed), torch.from_numpy(src.astype(np.int32))


def test_plain_gather_on_cpu_matches_numpy():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the plain version is the JAX package's take_along_axis of the
    packed row at clip(src >> 2), then the code's two bits."""
    packed, src = _inputs(5, 40, 150, seed=1)
    before = gather_cuda.gather_codes.launches
    got = gather_cuda.gather_codes(packed, src).numpy()
    p, s = packed.numpy(), src.numpy()
    byte = np.take_along_axis(p.astype(np.int32), np.clip(s >> 2, 0, p.shape[1] - 1), axis=1)
    want = ((byte >> ((s & 3) * 2)) & 3).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert gather_cuda.gather_codes.launches == before


def _refused_code_inputs():
    """(packed, src) pairs the code gather's card path must refuse, by name."""
    packed, src = _inputs(4, 50, 60, seed=13)
    return {
        "int8 packed": (packed.to(torch.int8), src),
        "int16 packed": (packed.to(torch.int16), src),
        "int64 src": (packed, src.long()),
        "batch mismatch": (packed[:3], src),
        "rank 1": (packed[0], src[0]),
        "empty row": (packed[:, :0], src),
    }


@pytest.mark.parametrize("case", sorted(_refused_code_inputs()))
def test_code_gather_card_path_refuses_before_building(case):
    """On the card path the wrapper checks types, ranks and the batch before
    it loads the library: each refused input raises ValueError and nothing
    is counted as launched."""
    packed, src = _refused_code_inputs()[case]
    before = gather_cuda.gather_codes.launches
    with pytest.raises(ValueError, match="gather_codes"):
        gather_cuda.gather_codes(on_card(packed), on_card(src))
    assert gather_cuda.gather_codes.launches == before


# (B, PB, L, seed): a ragged shape; a small one; rows whose length is not a
# multiple of 16, so that a thread's 16 flat positions straddle two rows
# (and, with L < 16, several); one lane; more lanes than a grid's y extent
CODE_SHAPES = ((37, 770, 3000, 2), (3, 5, 17, 3), (37, 400, 1531, 4), (9, 3, 7, 5),
               (5, 2, 1, 6), (1, 800, 3000, 7), (1, 4, 13, 8), (70000, 6, 20, 9))


@pytest.mark.gpu
def test_gather_kernel_matches_plain_on_card():
    """The CUDA kernel equals its plain PyTorch version on the card, exactly,
    at every shape of CODE_SHAPES (indices out of the row at both ends), also
    with the index and the packed rows one element past an aligned address
    (contiguous slices of larger tensors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    dev = torch.device("cuda")
    for B, PB, L, seed in CODE_SHAPES:
        packed, src = (t.to(dev) for t in _inputs(B, PB, L, seed))
        s1 = torch.empty(B * L + 1, dtype=torch.int32, device=dev)[1:].view(B, L)
        s1.copy_(src)
        p1 = torch.empty(B * PB + 1, dtype=torch.uint8, device=dev)[1:].view(B, PB)
        p1.copy_(packed)
        for pk, sx in ((packed, src), (packed, s1), (p1, src)):
            before = gather_cuda.gather_codes.launches
            got = gather_cuda.gather_codes(pk, sx)
            want = gather_cuda.gather_codes_plain(pk, sx)
            torch.cuda.synchronize()
            assert gather_cuda.gather_codes.launches == before + 1
            assert got.dtype == torch.uint8 and got.shape == (B, L)
            assert torch.equal(got, want), (B, PB, L)


@pytest.mark.gpu
def test_code_gather_wrapper_refuses_what_the_kernel_does_not_take():
    """On the card the light launch path keeps every check: a wrong type, a
    batch mismatch, a wrong rank, an empty row and tensors on two devices
    raise, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrapper runs the plain version")
    dev = torch.device("cuda")
    bad = [tuple(t.to(dev) for t in pair) for pair in _refused_code_inputs().values()]
    packed, src = _inputs(4, 50, 60, seed=13)
    bad.append((packed, src.to(dev)))
    before = gather_cuda.gather_codes.launches
    for p_, s_ in bad:
        with pytest.raises(ValueError):
            gather_cuda.gather_codes(p_, s_)
    assert gather_cuda.gather_codes.launches == before


def _row_inputs(B, W, L, seed, dtype):
    """Rows of 1-byte or 2-byte elements and in-range indices that follow the
    output position with a drift, as an edit script's gather map does."""
    rs = np.random.default_rng(seed)
    parts = rs.integers(0, 256 if dtype == np.uint8 else 1 << 15, (B, W)).astype(dtype)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    idx = np.clip(rs.integers(0, 64, (B, 1)) + np.arange(L)[None, :] + drift, 0, W - 1)
    idx[:, :2] = [0, W - 1][:L]
    return torch.from_numpy(parts), torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_plain_row_gather_on_cpu_matches_numpy(dtype):
    """gather_u8 on CPU tensors is take_along_axis and launches nothing."""
    parts, idx = _row_inputs(5, 300, 450, seed=4, dtype=dtype)
    before = gather_cuda.gather_u8.launches
    got = gather_cuda.gather_u8(parts, idx)
    assert got.dtype == parts.dtype
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(parts.numpy(), idx.numpy(), axis=1))
    assert gather_cuda.gather_u8.launches == before


def test_gather_codes_unpacked_on_cpu_matches_numpy():
    rs = np.random.default_rng(5)
    codes = rs.integers(0, 4, (4, 203)).astype(np.int32)
    idx = rs.integers(0, 203, (4, 90)).astype(np.int32)
    got = gather_cuda.gather_codes_unpacked(torch.from_numpy(codes), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(codes, idx, axis=1))


# (B, W, L, seed): a ragged shape; a small one; the transcriptome paths'
# shapes (the direct-RNA unaligned pass, the aligned read-emitting batches);
# rows whose length is not a multiple of 4, so that four flat positions
# straddle two rows (and, with L < 4, several)
ROW_SHAPES = ((37, 2900, 3000, 6), (3, 9, 17, 7), (512, 1536, 1536, 8), (512, 4096, 4096, 9),
              (37, 1500, 1531, 10), (5, 4, 3, 11), (7, 2, 1, 12))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_row_gather_kernel_matches_plain_on_card(dtype):
    """The CUDA element gather equals its plain PyTorch version on the card,
    exactly, for 1-byte and 2-byte elements, at every shape of ROW_SHAPES,
    and where the index and output are not aligned for its vector
    accesses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU mode")
    dev = torch.device("cuda")
    for B, W, L, seed in ROW_SHAPES:
        parts, idx = (t.to(dev) for t in _row_inputs(B, W, L, seed, dtype))
        # the same indices one element past an aligned address (contiguous)
        shifted = torch.empty(B * L + 1, dtype=torch.int32, device=dev)[1:].view(B, L)
        shifted.copy_(idx)
        for ix in (idx, shifted):
            before = gather_cuda.gather_u8.launches
            got = gather_cuda.gather_u8(parts, ix)
            want = gather_cuda.gather_u8_plain(parts, ix)
            torch.cuda.synchronize()
            assert gather_cuda.gather_u8.launches == before + 1
            assert got.dtype == parts.dtype and got.shape == (B, L)
            assert torch.equal(got, want), (B, W, L)


@pytest.mark.gpu
def test_row_gather_wrapper_refuses_what_the_kernel_does_not_take():
    """On the card the lighter launch path keeps every check: a float or a
    4-byte element, a non-int32 index, a batch mismatch, a wrong rank, an
    empty row and tensors on two devices raise, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrapper runs the plain version")
    dev = torch.device("cuda")
    parts, idx = (t.to(dev) for t in _row_inputs(4, 50, 60, 13, np.uint8))
    bad = [(parts.float(), idx), (parts.half(), idx), (parts.int(), idx),
           (parts, idx.long()), (parts[:3], idx), (parts[0], idx[0]),
           (parts[:, :0], idx), (parts.cpu(), idx)]
    before = gather_cuda.gather_u8.launches
    for p_, i_ in bad:
        with pytest.raises(ValueError):
            gather_cuda.gather_u8(p_, i_)
    assert gather_cuda.gather_u8.launches == before
