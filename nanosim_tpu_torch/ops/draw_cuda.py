"""The counter-based draws of ops/rng.py as CUDA launches (csrc/draw.cu).

Each function here has the name, arguments and result of the public draw of
ops/rng.py that it serves, for keys on the card, and launches one kernel:
`fold_in` (and through it `base_key`, `slot_keys`, `part_slot_keys`,
`site_keys`), `bits_at`, `bits_per_slot`, `uniform_per_slot`,
`uniform2_per_slot`, `uniform_at`, `uniform_f64` and `uniform`.  The result
has exactly the dtype and bits of ops/rng.py's plain int64 version, which
stays the version for CPU tensors and the spec the card tests hold these
to.  ops/rng.py routes by the keys' device alone.

The library is built by ops/cuda_build.py at first use (nvcc, no PyTorch
headers) and never when a module is imported.  `launches` counts the
kernel's launches; under a profiler each launch is also counted as
``rng.draw_launches`` (nanosim_tpu_torch/tracing.py).  A launch's host work
is a few attribute reads, one allocation and the ctypes call: the meta-only
batch programs make about fifty of these calls a batch, on [512]- or
[2,048]-lane keys, where the call's host time is its whole cost.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import tracing
from .cuda_build import KernelLibrary, current_raw_stream

MASK32 = 0xFFFFFFFF
# csrc/draw.cu's Kind: the construction of a draw from its hash words
BITS, UNIFORM, UNIFORM2, UNIFORM_F64 = 0, 1, 2, 3
_OUT_DTYPE = {BITS: torch.int64, UNIFORM: torch.float32, UNIFORM2: torch.float32,
              UNIFORM_F64: torch.float64}
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}

launches = 0


def _bind(lib):
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.launch_fold_in.argtypes = [p, q, q, q, p, i, q, q, q, q, q, p, p]
    lib.launch_fold_in.restype = ctypes.c_int
    lib.launch_draw.argtypes = [i, p, q, q, i, q, p, i, i, q, q, q, p, p, p]
    lib.launch_draw.restype = ctypes.c_int


LIBRARY = KernelLibrary("draw.cu", _bind)


def _launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: draw kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    tracing.count("rng.draw_launches")


def _check_keys(keys: torch.Tensor, what: str) -> None:
    if keys.dtype is not torch.int64 or keys.dim() == 0 or keys.shape[-1] != 2:
        raise ValueError(f"{what}: needs [..., 2] int64 keys, got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def _index(t: torch.Tensor, dev: int, what: str) -> torch.Tensor:
    """An integer tensor the kernels read (int32 or int64), on the keys' card."""
    if t.get_device() != dev:
        raise ValueError(f"{what}: the keys are on cuda:{dev}, an index on {t.device}")
    if t.dtype not in _INDEX_BYTES:
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype is torch.bool:
            raise ValueError(f"{what}: needs an integer index, got {t.dtype}")
        t = t.long()
    return t


def _broadcast(a, b) -> tuple:
    """The broadcast of two shapes (torch.broadcast_shapes imports torch's
    symbolic-shape machinery, seconds at a process's first call)."""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        raise ValueError(f"fold_in: keys of shape {a} and data of shape {b} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def fold_in(keys: torch.Tensor, data, add: int = 0) -> torch.Tensor:
    """[..., 2] keys, int or broadcastable integer tensor -> [..., 2] keys:
    threefry(key, (0, (data + add) mod 2**32)) over the broadcast shape, as
    rng.fold_in(keys, data + add)."""
    _check_keys(keys, "fold_in")
    dev = keys.get_device()
    if torch.is_tensor(data):
        data = _index(data, dev, "fold_in")
        shape = _broadcast(keys.shape[:-1], data.shape)
        d = data.expand(shape)
        k = keys.expand(*shape, 2)
        if len(shape) > 2:
            k, d = k.reshape(-1, 2), d.reshape(-1)
        d_bytes, d_ptr = _INDEX_BYTES[d.dtype], d.data_ptr()
        d_strides = d.stride()
        add = int(add)
    else:
        shape = keys.shape[:-1]
        k = keys if len(shape) <= 2 else keys.reshape(-1, 2)
        d_bytes, d_ptr, d_strides = 0, None, ()
        add = int(data) + int(add)
    out = keys.new_empty((*shape, 2))
    ks = k.stride()
    # the broadcast grid as [R, C]: a 0-d or 1-d shape is one row
    if k.dim() == 3:
        R, C = k.shape[0], k.shape[1]
        k_r, k_c, d_r, d_c = ks[0], ks[1], *(d_strides or (0, 0))
    else:
        R, C = 1, (k.shape[0] if k.dim() == 2 else 1)
        k_r, d_r = 0, 0
        k_c = ks[0] if k.dim() == 2 else 0
        d_c = d_strides[0] if d_strides else 0
    if R * C == 0:
        return out
    rc = LIBRARY.load().launch_fold_in(k.data_ptr(), k_r, k_c, ks[-1], d_ptr, d_bytes, d_r, d_c,
                                       add & MASK32, R, C, out.data_ptr(),
                                       current_raw_stream(dev))
    _launched(rc, "fold_in")
    return out


def _rows(keys: torch.Tensor):
    """keys [..., 2] -> (keys, rows, row stride, word stride) in elements."""
    if keys.dim() == 2:
        s = keys.stride()
        return keys, keys.shape[0], s[0], s[1]
    if keys.dim() == 1:
        return keys, 1, 0, keys.stride(0)
    if not keys.is_contiguous():
        keys = keys.contiguous()
    return keys, keys.numel() // 2, 2, 1


def _draw(kind: int, keys: torch.Tensor, site, out_shape, n: int, pos=None, clamp_n=None,
          what: str = "draw"):
    """One launch: for each key row b (folded with `site` unless it is None)
    and each j < n, draw j or draw pos[b, j] -> out [*out_shape] (two for
    UNIFORM2)."""
    _check_keys(keys, what)
    dev = keys.get_device()
    keys, B, k_row, k_word = _rows(keys)
    dtype = _OUT_DTYPE[kind]
    out0 = keys.new_empty(out_shape, dtype=dtype)
    out1 = keys.new_empty(out_shape, dtype=dtype) if kind == UNIFORM2 else None
    if B * n == 0:
        return out0 if out1 is None else (out0, out1)
    p_ptr, p_bytes = None, 8
    if pos is not None:
        pos = _index(pos, dev, what)
        if not pos.is_contiguous():
            pos = pos.contiguous()
        p_ptr, p_bytes = pos.data_ptr(), _INDEX_BYTES[pos.dtype]
    clamp = clamp_n is not None
    rc = LIBRARY.load().launch_draw(
        kind, keys.data_ptr(), k_row, k_word, site is not None,
        0 if site is None else int(site) & MASK32, p_ptr, p_bytes, clamp,
        int(clamp_n) - 1 if clamp else 0, B, n, out0.data_ptr(),
        None if out1 is None else out1.data_ptr(), current_raw_stream(dev))
    _launched(rc, what)
    return out0 if out1 is None else (out0, out1)


def _per_lane(keys: torch.Tensor, shape):
    """The [B, *shape] result shape of a per-lane draw and its width n."""
    shape = tuple(shape)
    return (keys.shape[0], *shape), math.prod(shape)


def _positions(keys: torch.Tensor, pos: torch.Tensor, what: str) -> int:
    if pos.dim() == 0 or pos.shape[0] != keys.shape[0] or keys.dim() != 2:
        raise ValueError(f"{what}: needs [B, 2] keys and [B, ...] positions, got "
                         f"{tuple(keys.shape)} and {tuple(pos.shape)}")
    return pos.numel() // pos.shape[0] if pos.shape[0] else 0


def bits_at(keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """rng.bits_at: keys [B, 2], pos [B, ...] -> [B, ...] int64."""
    n = _positions(keys, pos, "bits_at")
    return _draw(BITS, keys, None, pos.shape, n, pos=pos, what="bits_at")


def bits_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """rng.bits_per_slot: the site fold and the draws in one launch."""
    out_shape, n = _per_lane(slot_keys_arr, shape)
    return _draw(BITS, slot_keys_arr, site, out_shape, n, what="bits_per_slot")


def uniform_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()) -> torch.Tensor:
    """rng.uniform_per_slot: the site fold and the draws in one launch."""
    out_shape, n = _per_lane(slot_keys_arr, shape)
    return _draw(UNIFORM, slot_keys_arr, site, out_shape, n, what="uniform_per_slot")


def uniform2_per_slot(slot_keys_arr: torch.Tensor, site: int, shape=()):
    """rng.uniform2_per_slot: (lo, hi), the site fold and the draws in one launch."""
    out_shape, n = _per_lane(slot_keys_arr, shape)
    return _draw(UNIFORM2, slot_keys_arr, site, out_shape, n, what="uniform2_per_slot")


def uniform_at(slot_keys_arr: torch.Tensor, site: int, pos: torch.Tensor, n: int) -> torch.Tensor:
    """rng.uniform_at: the site fold, the clamp to [0, n) and the draws in
    one launch."""
    m = _positions(slot_keys_arr, pos, "uniform_at")
    return _draw(UNIFORM, slot_keys_arr, site, pos.shape, m, pos=pos, clamp_n=n,
                 what="uniform_at")


def uniform_f64(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """rng.uniform_f64: keys [B, 2] -> [B, *shape] float64."""
    if keys.dim() != 2:
        raise ValueError(f"uniform_f64: needs [B, 2] keys, got {tuple(keys.shape)}")
    out_shape, n = _per_lane(keys, shape)
    return _draw(UNIFORM_F64, keys, None, out_shape, n, what="uniform_f64")


def uniform(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """rng.uniform: keys [..., 2] -> [..., *shape] float32."""
    shape = tuple(shape)
    return _draw(UNIFORM, keys, None, (*keys.shape[:-1], *shape), math.prod(shape),
                 what="uniform")
