"""The windowed byte gather (csrc/gather_window.cu) and its plain PyTorch
version: the measuring kernel that asks, on this card, the question of the
JAX package's TPU experiment bench/gather_variants.py (`make_gather(KT, W8v,
dt)`, its pallas_call at :75) — does staging a window of the packed row in
shared memory beat the direct global gather of K3 (ops/gather_cuda.py)?

`gather_windowed(packed, idx, ws, kt, w8v)`: packed [B, PB] uint8 (4 codes
per byte), idx [B, L] int32 code indices, ws [B, ceil(L / 1024)] int32
window starts (512-aligned codes, `window_starts`) -> [B, L] int32, the byte
holding code idx as read from the tile's window of w8v * 128 bytes:

    wb = ws[b, j // 1024] >> 9
    lb = clamp((idx[b, j] - (wb << 9)) >> 2, 0, w8v * 128 - 1)
    out[b, j] = packed[b, wb * 128 + lb]  (0 past the row's end)

Where the window covers the tile, that is packed[b, idx >> 2].  The
experiment's instances are (KT, W8v) = (4, 8), (4, 4) and (8, 4); its `dt`
(f32 or bf16 one-hot products) is exact for bytes, so its bf16 names map to
the same instances (`VARIANTS`) and each instance is timed once.  For a
tensor on the CPU the wrapper runs the plain version
(`gather_windowed_plain`); for a CUDA tensor it launches the kernel or
raises — there is no fallback.  The kernel's launcher stages each window by
a TMA bulk copy where the packed rows' base and length are multiples of 16
bytes, by the threads' own copies otherwise, and reports the route it took.
``gather_windowed.launches`` counts the launches (``launches_by_variant``
per (kt, w8v), ``launches_by_copy`` per copy route, "bulk" or "threads").

`window_starts` and `realistic_idx` are the JAX package's
(ops/window_gather.py:97-112, bench/bench_gather.py:18-33);
`measure_gather_variants` is the experiment's sweep on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import KernelLibrary, current_raw_stream, time_ms

TILE = 1024  # output positions per window
INSTANCES = ((4, 8), (4, 4), (8, 4))  # (KT, W8v) compiled into csrc/gather_window.cu
# the experiment's variant names (bench/gather_variants.py:118-123) -> instance;
# "KT4 W4 f32" and "KT4 W4 bf16" are one instance
VARIANTS = {"KT4 W8 f32": (4, 8), "KT4 W4 f32": (4, 4), "KT4 W4 bf16": (4, 4),
            "KT8 W4 bf16": (8, 4)}
# the experiment's shape (bench/gather_variants.py:94-96)
SHAPE = {"B": 1024, "L": 19456, "PB": 4608}


def _bind(lib):
    p = ctypes.c_void_p
    lib.launch_gather_window.argtypes = [ctypes.c_int, ctypes.c_int, p, ctypes.c_int64, p, p,
                                         ctypes.c_int, ctypes.c_int64, ctypes.c_int, p, p,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.launch_gather_window.restype = ctypes.c_int


LIBRARY = KernelLibrary("gather_window.cu", _bind)


def window_starts(idx: torch.Tensor, mask: torch.Tensor, n_tiles: int):
    """Per-(lane, tile) window starts + per-lane drift-overflow flag.

    idx:  [B, L] code indices (only meaningful where mask)
    mask: [B, L] positions that will actually be read
    Returns (ws [B, n_tiles] i32 512-aligned, overflow [B] bool) against the
    full 4,096-code (W8) window.  L may be ragged: the positions past it up
    to n_tiles * 1024 are not read.
    """
    B, L = idx.shape
    pad = n_tiles * TILE - L
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    big = 2**30
    m = torch.where(mask, idx, big).reshape(B, n_tiles, TILE)
    tmin = m.min(dim=2).values
    mx = torch.where(mask, idx, -1).reshape(B, n_tiles, TILE)
    tmax = mx.max(dim=2).values
    ws = torch.where(tmin == big, 0, tmin & ~511).to(torch.int32)
    overflow = (tmax - ws >= 8 * 128 * 4).any(dim=1)
    return ws, overflow


def realistic_idx(B, L, n_codes, rs):
    """Piecewise slope-1 index maps with event-like drift."""
    idx = np.zeros((B, L), np.int32)
    for b in range(B):
        row = np.arange(L, dtype=np.int64)
        # drift changes every ~170 positions by -8..8
        n_ev = L // 170
        pts = np.sort(rs.randint(0, L, n_ev))
        deltas = rs.randint(-8, 9, n_ev)
        d = np.zeros(L, np.int64)
        d[pts] += deltas
        idx[b] = np.clip(row + np.cumsum(d), 0, n_codes - 1).astype(np.int32)
    return idx


def gather_windowed_plain(packed: torch.Tensor, idx: torch.Tensor, ws: torch.Tensor,
                          w8v: int) -> torch.Tensor:
    """The formula of the module docstring in torch: the kernel's reference."""
    B, PB = packed.shape
    L = idx.shape[1]
    tile = (torch.arange(L, device=idx.device) // TILE)[None, :].expand(B, L)
    wb = ws.gather(1, tile) >> 9
    lb = ((idx - (wb << 9)) >> 2).clamp(0, w8v * 128 - 1)
    a = wb.long() * 128 + lb
    byte = torch.gather(packed, 1, a.clamp_max(PB - 1))
    return torch.where(a < PB, byte.to(torch.int32), 0)


def gather_windowed(packed: torch.Tensor, idx: torch.Tensor, ws: torch.Tensor, kt: int,
                    w8v: int) -> torch.Tensor:
    """The CUDA kernel's (kt, w8v) instance for CUDA tensors, the plain
    version for CPU tensors (kt sets how many tiles a work item stages)."""
    if (kt, w8v) not in INSTANCES:
        raise ValueError(f"gather_windowed: no instance for KT={kt} W8v={w8v}; "
                         f"the instances are {INSTANCES}")
    if not idx.is_cuda:
        if idx.device.type != "cpu":
            raise ValueError(f"gather_windowed: runs on CPU or CUDA tensors, got {idx.device}")
        return gather_windowed_plain(packed, idx, ws, w8v)
    dev = idx.get_device()
    if packed.get_device() != dev or ws.get_device() != dev:
        raise ValueError(f"gather_windowed: packed on {packed.device}, idx on {idx.device}, "
                         f"ws on {ws.device}")
    if (packed.dtype is not torch.uint8 or idx.dtype is not torch.int32
            or ws.dtype is not torch.int32):
        raise ValueError(f"gather_windowed: needs uint8 packed, int32 idx and ws, got "
                         f"{packed.dtype}, {idx.dtype}, {ws.dtype}")
    B, L = idx.shape
    n_tiles = -(-L // TILE)
    if (packed.dim() != 2 or packed.shape[0] != B or tuple(ws.shape) != (B, n_tiles)
            or packed.shape[1] == 0):
        raise ValueError(f"gather_windowed: shapes {tuple(packed.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(ws.shape)} are not [B, PB], [B, L], [B, ceil(L/1024)]")
    launch = LIBRARY.load().launch_gather_window  # typed when the library loads
    if not packed.is_contiguous():
        packed = packed.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if not ws.is_contiguous():
        ws = ws.contiguous()
    out = idx.new_empty((B, L))
    bulk = ctypes.c_int(0)
    rc = launch(kt, w8v, packed.data_ptr(), packed.shape[1], idx.data_ptr(), ws.data_ptr(), B, L,
                n_tiles, out.data_ptr(), current_raw_stream(dev), ctypes.byref(bulk))
    if rc != 0:
        raise RuntimeError(f"gather_window kernel launch failed: code {rc}")
    gather_windowed.launches += 1
    by = gather_windowed.launches_by_variant
    by[kt, w8v] = by.get((kt, w8v), 0) + 1
    route = "bulk" if bulk.value else "threads"
    gather_windowed.launches_by_copy[route] = gather_windowed.launches_by_copy.get(route, 0) + 1
    return out


gather_windowed.launches = 0
gather_windowed.launches_by_variant = {}  # (kt, w8v) -> launches
gather_windowed.launches_by_copy = {}  # "bulk" or "threads" -> launches


def experiment_inputs(device, B=SHAPE["B"], L=SHAPE["L"], PB=SHAPE["PB"]):
    """The experiment's inputs (bench/gather_variants.py:94-111): random
    packed rows and `realistic_idx` from RandomState(0), the window starts of
    all positions.  Returns (packed, idx, ws, want) with want = packed[b,
    idx >> 2]."""
    rs = np.random.RandomState(0)
    packed = rs.randint(0, 256, (B, PB)).astype(np.uint8)
    idx = realistic_idx(B, L, PB * 4, rs)
    want = packed[np.arange(B)[:, None], idx >> 2].astype(np.int32)
    idx_t = torch.as_tensor(idx, device=device)
    ws, _ = window_starts(idx_t, torch.ones_like(idx_t, dtype=torch.bool), -(-L // TILE))
    return (torch.as_tensor(packed, device=device), idx_t, ws,
            torch.as_tensor(want, device=device))


def window_covers(idx: torch.Tensor, ws: torch.Tensor, w8v: int) -> bool:
    """Whether every tile's indices lie inside its w8v * 128-byte window
    (the experiment's coverage check, bench/gather_variants.py:130-134)."""
    B, L = idx.shape
    n_tiles = ws.shape[1]
    pad = n_tiles * TILE - L
    mx = torch.nn.functional.pad(idx, (0, pad), value=-1) if pad else idx
    mx = mx.reshape(B, n_tiles, TILE).max(dim=2).values
    return bool((mx - ws < w8v * 128 * 4).all())


def measure_gather_variants(device="cuda", launches: int = 10, inputs=None) -> dict:
    """Run the experiment on the card: every instance's time per launch
    (CUDA events, `launches` launches after a warm-up), the experiment's
    names for it, and whether it is correct (equal to packed[b, idx >> 2]
    with its window covering every tile), at the experiment's shape or on
    `inputs` = (packed, idx, ws, want).  Raises without a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the gather experiment measures the card")
    packed, idx, ws, want = inputs if inputs is not None else experiment_inputs(device)
    out = {"B": idx.shape[0], "L": idx.shape[1], "PB": packed.shape[1], "instances": {}}
    for kt, w8v in INSTANCES:
        got = gather_windowed(packed, idx, ws, kt, w8v)
        covers = window_covers(idx, ws, w8v)
        ms = time_ms(lambda: gather_windowed(packed, idx, ws, kt, w8v), launches)
        out["instances"][f"KT{kt} W{w8v}"] = {
            "kt": kt, "w8v": w8v, "ms": ms, "window_covers": covers,
            "correct": bool(torch.equal(got, want)) and covers,
            "names": [n for n, x in VARIANTS.items() if x == (kt, w8v)]}
    return out
