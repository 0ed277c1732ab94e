"""The read assembly: its plain version on the CPU against a numpy
reference, and the CUDA kernel against the plain version on the card.

The card-only test imports no JAX; run it on the machine with the card with:
python -m pytest --noconftest -m gpu tests/test_torch_assemble.py
"""

import numpy as np
import pytest
import torch

from nanosim_tpu_torch.ops import assemble_cuda

from test_torch_common import on_card

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = {ord("A"): ord("T"), ord("T"): ord("A"), ord("C"): ord("G"), ord("G"): ord("C")}


def assemble_numpy(mid, ht, head, l_new, total, is_rev, l_out):
    """Per-lane numpy reference: head | middle | tail, reversed lanes
    flipped with the low byte complemented, zero beyond total."""
    B = mid.shape[0]
    out = np.zeros((B, l_out), np.uint16)
    for b in range(B):
        pre = np.zeros(l_out, np.uint16)
        h, ln, t = head[b], l_new[b], total[b]
        pre[:h] = ht[b, :h]
        pre[h : h + ln] = mid[b, :ln]
        pre[h + ln : t] = ht[b, h : h + (t - h - ln)]
        if is_rev[b]:
            rev = pre[:t][::-1].copy()
            cb = np.array([COMP.get(x, x) for x in rev & 0xFF], np.uint16)
            out[b, :t] = cb | (rev & 0xFF00)
        else:
            out[b, :t] = pre[:t]
    return out


def assemble_inputs(B, l_cap, ht_cap, l_out, seed):
    """Packed uint16 middles and head/tail pools from a seed with numpy: both
    strands, lanes without head, without tail, with neither, and one whose
    total fills l_out exactly."""
    rs = np.random.default_rng(seed)
    mid = (BASES[rs.integers(0, 4, (B, l_cap))].astype(np.uint16)
           | (rs.integers(0, 3, (B, l_cap)).astype(np.uint16) << 8))
    mid[0, :5] = ord("N")  # a byte the complement leaves alone
    ht = BASES[rs.integers(0, 4, (B, ht_cap))].astype(np.uint16) | (3 << 8)
    l_new = rs.integers(10, l_cap, B).astype(np.int32)
    head = rs.integers(0, ht_cap // 2, B).astype(np.int32)
    tail = rs.integers(0, ht_cap // 2, B).astype(np.int32)
    head[:4] = [0, 0, 5, 0]
    tail[:4] = [0, 7, 0, 0]
    l_new[3] = l_cap
    head[4] = (l_out - l_cap) // 2
    tail[4] = l_out - l_cap - head[4]
    l_new[4] = l_cap  # total == l_out
    total = (head + l_new + tail).astype(np.int32)
    is_rev = rs.random(B) < 0.5
    is_rev[:5] = [True, False, True, False, True]
    return mid, ht, head, l_new, total, is_rev


def as_tensors(mid, ht, head, l_new, total, is_rev, device="cpu"):
    """The numpy inputs as the wrapper's tensors (16-bit values as int16)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (mid.view(np.int16), ht.view(np.int16), head, l_new, total, is_rev))


@pytest.mark.parametrize("B", [13, 16])
def test_plain_assembly_on_cpu_matches_numpy(B):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; any batch size goes (13 is not a multiple of 8)."""
    l_cap, ht_cap, l_out = 256, 128, 384
    inputs = assemble_inputs(B, l_cap, ht_cap, l_out, seed=B)
    before = assemble_cuda.assemble_rolls.launches
    got = assemble_cuda.assemble_rolls(*as_tensors(*inputs), l_out)
    assert got.dtype == torch.int16 and got.shape == (B, l_out)
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  assemble_numpy(*inputs, l_out))
    assert assemble_cuda.assemble_rolls.launches == before


def test_plain_assembly_clips_like_one_gather():
    """A lane whose l_new exceeds the middle buffer (a capacity overflow the
    program discards) reads the concatenation [mid | ht] clipped to its end,
    as the one-gather formulation does."""
    l_cap, ht_cap, l_out = 64, 32, 128
    mid, ht, head, l_new, total, is_rev = assemble_inputs(6, l_cap, ht_cap, l_out, seed=1)
    head[:] = 3
    l_new[:] = [70, 70, 64, 10, 90, 64]
    total = (head + l_new + 2).astype(np.int32)  # tail = 2
    got = assemble_cuda.assemble_rolls_plain(
        *as_tensors(mid, ht, head, l_new, total, is_rev), l_out).numpy().view(np.uint16)
    parts = np.concatenate([mid, ht], axis=1)
    for b in range(6):
        for j in range(int(total[b])):
            jj = total[b] - 1 - j if is_rev[b] else j
            if head[b] <= jj < head[b] + l_new[b]:
                idx = jj - head[b]
            else:
                idx = l_cap + (jj if jj < head[b] else jj - l_new[b])
            v = int(parts[b, min(max(idx, 0), l_cap + ht_cap - 1)])
            if is_rev[b]:
                v = (v & 0xFF00) | COMP.get(v & 0xFF, v & 0xFF)
            assert got[b, j] == v, (b, j)
        assert not got[b, total[b]:].any()


def _refused_assembly_inputs():
    """(args, l_out) the assembly's card path must refuse, by name."""
    args = as_tensors(*assemble_inputs(8, 64, 32, 128, seed=3))
    mid, ht, head, l_new, total, is_rev = args

    def with_(i, t):
        return tuple(t if k == i else a for k, a in enumerate(args))

    return {
        "uint8 middle": (with_(0, mid.to(torch.uint8)), 128),
        "int32 head/tail pool": (with_(1, ht.int()), 128),
        "int64 head": (with_(2, head.long()), 128),
        "int16 total": (with_(4, total.short()), 128),
        "uint8 is_rev": (with_(5, is_rev.to(torch.uint8)), 128),
        "rank 1 middle": (with_(0, mid[0]), 128),
        "batch mismatch": (with_(1, ht[:7]), 128),
        "short l_new": (with_(3, l_new[:7]), 128),
        "empty middle": (with_(0, mid[:, :0]), 128),
        "negative l_out": (args, -1),
    }


@pytest.mark.parametrize("case", sorted(_refused_assembly_inputs()))
def test_assembly_card_path_refuses_before_building(case):
    """On the card path the wrapper checks types, ranks, the batch and l_out
    before it loads the library: each refused input raises ValueError and
    nothing is counted as launched."""
    args, l_out = _refused_assembly_inputs()[case]
    before = assemble_cuda.assemble_rolls.launches
    with pytest.raises(ValueError, match="assemble_rolls"):
        assemble_cuda.assemble_rolls(*(on_card(a) for a in args), l_out)
    assert assemble_cuda.assemble_rolls.launches == before


def _card_cases():
    """(name, numpy inputs, l_out) for the card test: a batch that is not a
    multiple of 8 with both strands, lanes without head, without tail, with
    neither, one whose total is l_out, one beyond the middle buffer and one
    with total 0; rows whose length is not a multiple of 8, so that a 16-byte
    group straddles two rows (and, with l_out < 8, several); rows of a
    long-read profile's width (25,600 positions together); one lane; more
    lanes than a grid's y extent."""
    cases = []
    for B, l_cap, ht_cap, l_out, seed in ((37, 3000, 700, 4096, 2), (5, 40, 16, 60, 3),
                                          (13, 300, 64, 333, 4), (11, 24, 16, 30, 5),
                                          (9, 16, 8, 5, 6), (70000, 16, 8, 40, 7),
                                          (20, 24576, 1024, 26000, 9)):
        mid, ht, head, l_new, total, is_rev = assemble_inputs(B, l_cap, ht_cap, l_out, seed)
        tail = total - head - l_new
        if B > 6:
            l_new[5] = l_cap + 50  # a capacity overflow: reads the clipped [mid | ht]
            head[6] = l_new[6] = tail[6] = 0  # total 0
        total = (head + l_new + tail).astype(np.int32)
        cases.append((f"B={B} l_out={l_out}", (mid, ht, head, l_new, total, is_rev), l_out))
    mid, ht, head, l_new, total, is_rev = assemble_inputs(8, 3000, 704, 4096, 8)
    cases.append(("one lane", tuple(a[4:5] for a in (mid, ht, head, l_new, total, is_rev)),
                  4096))
    return cases


def _offset(t):
    """The same values one element past an aligned address (a contiguous
    slice of a larger tensor)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.gpu
def test_assemble_kernel_matches_plain_on_card():
    """The CUDA kernel equals its plain PyTorch version on the card, exactly,
    at every shape of _card_cases, also with every input one element past
    an aligned address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the assembly kernel has no CPU mode")
    for name, inputs, l_out in _card_cases():
        args = as_tensors(*inputs, device="cuda")
        for a in (args, tuple(_offset(t) for t in args)):
            before = assemble_cuda.assemble_rolls.launches
            got = assemble_cuda.assemble_rolls(*a, l_out)
            want = assemble_cuda.assemble_rolls_plain(*a, l_out)
            torch.cuda.synchronize()
            assert assemble_cuda.assemble_rolls.launches == before + 1
            assert got.dtype == torch.int16 and got.shape == (a[0].shape[0], l_out)
            assert torch.equal(got, want), name


@pytest.mark.gpu
def test_assembly_wrapper_refuses_what_the_kernel_does_not_take():
    """On the card the light launch path keeps every check: wrong types,
    ranks and batches, an empty middle, a negative l_out and inputs on two
    devices raise, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the wrapper runs the plain version")
    bad = [(tuple(a.cuda() for a in args), l_out)
           for args, l_out in _refused_assembly_inputs().values()]
    good = as_tensors(*assemble_inputs(8, 64, 32, 128, seed=3), device="cuda")
    bad.append((good[:5] + (good[5].cpu(),), 128))
    before = assemble_cuda.assemble_rolls.launches
    for args, l_out in bad:
        with pytest.raises(ValueError):
            assemble_cuda.assemble_rolls(*args, l_out)
    assert assemble_cuda.assemble_rolls.launches == before
