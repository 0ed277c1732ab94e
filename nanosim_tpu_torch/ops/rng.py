"""Counter-based RNG streams: the fixed seed mapping, in PyTorch.

The seed mapping is the one the JAX package defines, reproduced bit for bit:

    slot_key  = fold_in(fold_in(threefry_seed(seed), STREAM), slot_id)
    draw_key  = fold_in(slot_key, site_id)          # one site per draw kind

A key is a pair of 32-bit words.  torch's ``uint32`` lacks most arithmetic,
so every word is carried in an int64 tensor and masked to 32 bits after each
operation; keys are ``[..., 2]`` int64 tensors.  The CUDA kernels use native
``uint32_t`` for the same arithmetic.

Two details of ``jax.random`` that the mapping depends on:

* ``fold_in(k, s)`` hashes the counter pair ``(0, s mod 2**32)``: a slot id
  is truncated to its low 32 bits, it is not split into two words;
* draw ``j`` (flat, row-major over the draw shape) of ``uniform(k, shape)``
  is ``threefry(k, (0, j))`` with bits ``y0 ^ y1`` (the partitionable
  threefry layout); a 64-bit draw is ``(y0 << 32) | y1``.

No torch.Generator and no global state: a draw is a pure function of
(seed, stream, slot, site, position).

Every public draw takes its keys' device as the only switch: on the card it
is one launch of csrc/draw.cu (ops/draw_cuda.py), with the dtype and bits of
the int64 version here, which runs for CPU tensors and is the kernels' spec.
Under a profiler, ``rng.plain_hashes_on_card`` counts the int64 hashes that
run on CUDA tensors all the same (none should) and ``rng.draw_launches`` the
kernel's launches.

Site ids are part of the on-disk reproducibility contract — append, never
renumber.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from . import draw_cuda, xla_math

# --- Site enumeration (append-only) ---------------------------------------
SITE_REF_LENGTH = 0  # aligned-region / total length KDE draw
SITE_REMAINDER = 1  # head+tail length KDE draw
SITE_HT_RATIO = 2  # head/(head+tail) ratio KDE draw
SITE_STRAND = 3  # reverse-complement decision
SITE_WALK = 4  # error-state Markov walk (fold in step index)
SITE_POSITION = 5  # reference start position (fold in retry round)
SITE_IUPAC = 6  # ambiguity-code base resolution
SITE_MIS_BASE = 7  # substituted base choice
SITE_INS_BASE = 8  # inserted base choice
SITE_QUAL = 9  # per-base quality draw
SITE_HEAD_TAIL = 10  # head/tail random bases
SITE_HOMOPOLYMER = 11  # homopolymer resize + in-run mismatches
SITE_SEGMENTS = 12  # chimeric segment count (geometric)
SITE_GAP = 13  # chimeric gap length + gap error walk
SITE_SPECIES = 14  # metagenome species/chromosome choice
SITE_POLYA = 15  # polyA tail length
SITE_IR = 16  # intron-retention Markov walk
SITE_TRANSCRIPT = 17  # weighted transcript choice
SITE_LOGNORMAL_LEN = 18  # median/sd lognormal length mode
SITE_UNALIGNED_WALK = 19  # unaligned-read error walk
SITE_ALIGNED_2D = 20  # conditional 2D-KDE aligned-length draw
SITE_HP_QUAL = 21  # homopolymer in-run mismatch decision (p draw)
SITE_HP_MIS_BASE = 22  # homopolymer in-run substituted-base choice

# Distinct top-level streams so aligned/unaligned/gap slot counters never
# collide.
STREAM_ALIGNED = 0
STREAM_UNALIGNED = 1
STREAM_GAP = 2

# Chimeric reads consume several independent draw streams per slot (one per
# segment and one per gap); parts get pseudo-slot keys offset into a
# reserved range so their site draws never collide with the read-level ones.
PART_SEGMENT_BASE = 0x50000
PART_GAP_BASE = 0x60000

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _on_card(t: torch.Tensor) -> bool:
    """Whether a draw on `t` runs as the CUDA kernel: by its device alone."""
    return t.is_cuda


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds), elementwise over broadcastable int64
    tensors holding uint32 values; returns (y0, y1) int64 in [0, 2**32)."""
    if k0.is_cuda:
        tracing.count("rng.plain_hashes_on_card")
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    ks = (k0, k1, k2)
    for i in range(5):
        for r in _ROT0 if i % 2 == 0 else _ROT1:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> float32 in [0, 1), exactly as jax.random.uniform."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """[..., 2] keys, int or broadcastable int64 tensor -> [..., 2] keys."""
    if _on_card(keys):
        return draw_cuda.fold_in(keys, data)
    if torch.is_tensor(data):
        data = data & MASK32
        zero = torch.zeros_like(data)
    else:  # a Python int stays a scalar operand (no host-to-device copy)
        data = int(data) & MASK32
        zero = 0
    y0, y1 = _threefry2x32(keys[..., 0], keys[..., 1], zero, data)
    return torch.stack([y0, y1], dim=-1)


def base_key(seed: int, stream: int = STREAM_ALIGNED, device="cuda") -> torch.Tensor:
    """fold_in(PRNGKey(seed), stream) -> [2] int64 key (64-bit seeds split
    into (hi, lo) words, as jax does with x64 enabled)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k = torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64, device=device)
    return fold_in(k, stream)


def slot_keys(base: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """[B] int64 slot ids -> [B, 2] per-slot keys."""
    return fold_in(base.expand(slot_ids.shape[0], 2), slot_ids)


def part_slot_keys(slot_keys_arr: torch.Tensor, part_base: int, part_idx) -> torch.Tensor:
    """Per-(slot, part) keys for chimeric segments/gaps; part_idx is an int
    or a per-lane int64 tensor."""
    if _on_card(slot_keys_arr) and torch.is_tensor(part_idx):  # the sum inside the launch
        return draw_cuda.fold_in(slot_keys_arr, part_idx, add=part_base)
    return fold_in(slot_keys_arr, part_base + part_idx)


def site_keys(slot_keys_arr: torch.Tensor, site: int) -> torch.Tensor:
    return fold_in(slot_keys_arr, site)


def bits_at(keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bits of draw `pos` for each key: keys [B, 2], pos [B, ...] int64."""
    if _on_card(keys):
        return draw_cuda.bits_at(keys, pos)
    extra = (1,) * (pos.dim() - 1)
    B = keys.shape[0]
    k0 = keys[:, 0].reshape(B, *extra)
    k1 = keys[:, 1].reshape(B, *extra)
    y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(pos), pos & MASK32)
    return y0 ^ y1


def _flat_positions(keys: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return idx.reshape(1, *shape).expand(keys.shape[0], *shape)


def bits_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """Per-slot uint32 draws (in int64) of `shape` per lane -> [B, *shape]."""
    if _on_card(slot_keys_arr):
        return draw_cuda.bits_per_slot(slot_keys_arr, site, shape)
    ks = site_keys(slot_keys_arr, site)
    return bits_at(ks, _flat_positions(ks, tuple(shape)))


def uniform_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """Per-slot uniform(0,1) f32 draws of `shape` per lane -> [B, *shape]."""
    if _on_card(slot_keys_arr):
        return draw_cuda.uniform_per_slot(slot_keys_arr, site, shape)
    return _bits_to_uniform(bits_per_slot(slot_keys_arr, site, shape))


_NORMAL_LO = -0.99999994  # nextafter(-1, 0) in float32


def erfinv_normal_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """erfinv(u) of jax.random.normal's draw: the normal before its factor
    sqrt(2), u uniform on (nextafter(-1, 0), 1)."""
    f = uniform_per_slot(slot_keys_arr, site, shape)
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=f.device)
    u = torch.maximum(f * 2.0 + lo, lo)
    return xla_math.erfinv_f32(u)


def normal_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """jax.random.normal: sqrt(2) * erfinv(u), u uniform on (nextafter(-1, 0), 1)."""
    e = erfinv_normal_per_slot(slot_keys_arr, site, shape)
    sqrt2 = torch.tensor(2.0, dtype=torch.float32, device=e.device).sqrt()
    return sqrt2 * e


def uniform_at(slot_keys_arr: torch.Tensor, site: int, pos: torch.Tensor, n: int) -> torch.Tensor:
    """uniform_per_slot(sk, site, (n,))[b, pos[b, ...]] without materializing
    the pool; out-of-range pos are clamped."""
    if _on_card(slot_keys_arr):
        return draw_cuda.uniform_at(slot_keys_arr, site, pos, n)
    ks = site_keys(slot_keys_arr, site)
    return _bits_to_uniform(bits_at(ks, pos.clamp(0, n - 1).to(torch.int64)))


def uniform2_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()):
    """Two independent uniform(0,1) fields from ONE u32 draw per position
    (16-bit resolution each)."""
    if _on_card(slot_keys_arr):
        return draw_cuda.uniform2_per_slot(slot_keys_arr, site, shape)
    bits = bits_per_slot(slot_keys_arr, site, shape)
    scale = 1.0 / 65536.0
    lo = (bits & 0xFFFF).to(torch.float32) * scale
    hi = (bits >> 16).to(torch.float32) * scale
    return lo, hi


def uniform_f64(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """jax.random.uniform(k, shape, dtype=float64) per key: [B, 2] ->
    [B, *shape] f64.

    The 64 random bits of draw j are (y0 << 32) | y1 of counter (0, j);
    their top 52 bits become the mantissa.  (y0 << 20) | (y1 >> 12) is that
    shift done without leaving int64's positive range."""
    if _on_card(keys):
        return draw_cuda.uniform_f64(keys, shape)
    if shape:
        pos = _flat_positions(keys, tuple(shape))
        extra = (1,) * len(shape)
        k0 = keys[:, 0].reshape(-1, *extra)
        k1 = keys[:, 1].reshape(-1, *extra)
    else:
        pos, k0, k1 = torch.zeros_like(keys[:, 0]), keys[:, 0], keys[:, 1]
    y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(pos), pos)
    mant = (y0 << 20) | (y1 >> 12)
    return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0


def uniform(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """jax.random.uniform(k, shape) (float32) for each key: keys [..., 2] ->
    [..., *shape]; draw j is threefry(k, (0, j)) with bits y0 ^ y1."""
    if _on_card(keys):
        return draw_cuda.uniform(keys, shape)
    shape = tuple(shape)
    lanes = (*keys.shape[:-1], *(1,) * len(shape))
    pos = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device).reshape(shape)
    y0, y1 = _threefry2x32(keys[..., 0].reshape(lanes), keys[..., 1].reshape(lanes),
                           torch.zeros_like(pos), pos)
    return _bits_to_uniform(y0 ^ y1)
