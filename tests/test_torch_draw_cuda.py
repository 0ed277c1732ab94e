"""The counter-based draws as CUDA launches (csrc/draw.cu, ops/draw_cuda.py).

On the CPU: CPU tensors take ops/rng.py's int64 version and never build the
draw library; the card path refuses what the kernels do not take before it
builds anything; the wrapper's layouts (broadcast strides, 4-D keys, strided
keys, int32 data and positions) give rng's plain bits, with the two C
launchers modelled in numpy through the pointers the wrapper passes; and no
module of the package but ops/rng.py calls the int64 hash itself.

On the card (marked `gpu`): every draw is bit-equal to the int64 version run
on the same CUDA tensors (rng's routing switched to the plain version inside
the test), at the batch programs' shapes, and whole batch programs give the
same fields either way.  The card-only tests import no JAX; run them on the
machine with the card with:
python -m pytest --noconftest -m gpu tests/test_torch_draw_cuda.py
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from nanosim_tpu_torch import tracing
from nanosim_tpu_torch.ops import draw_cuda, rng

from test_torch_common import on_card

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "nanosim_tpu_torch")
SEEDS = (0, 3, 2**40 + 5, 2**64 - 7)
# slot ids past 2**32: the fold truncates them to their low 32 bits
WIDE_SLOTS = (2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 3 * 2**32 + 17, 2**40 + 3)


def _slots(B, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, 2**45, (B,), generator=g)
    wide = torch.tensor(WIDE_SLOTS)[:B]
    s[:wide.shape[0]] = wide
    return s.to(device)


def _bits_of(t):
    """A tensor's bits, for exact comparison of floats (NaN-free or not)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def _assert_same(got, want, what):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_same(g, w, what)
        return
    if not torch.is_tensor(want):
        assert got == want, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, want.dtype, tuple(got.shape), tuple(want.shape))
    assert got.device == want.device, what
    assert torch.equal(_bits_of(got), _bits_of(want)), what


def _every_draw(base, B, device, seed):
    """(name, thunk) for every public draw of ops/rng.py at small shapes,
    with the layouts the batch programs use."""
    slots = _slots(B, seed, device)
    sk = rng.slot_keys(base, slots)
    g = torch.Generator().manual_seed(seed + 1)
    part = torch.randint(0, 8, (B,), generator=g).to(device)
    pos32 = torch.randint(-40, 700, (B, 61), generator=g).to(torch.int32).to(device)
    pos64 = torch.randint(0, 2**36, (B, 3, 5), generator=g).to(device)
    T, F = 3, 7
    steps = (torch.arange(T) * 11).to(device)
    f_ids = torch.arange(F, device=device)
    walk = rng.fold_in(sk[None].expand(T, B, 2), steps[:, None].expand(T, B))
    return [
        ("slot_keys", lambda: rng.slot_keys(base, slots)),
        ("slot_keys int32", lambda: rng.fold_in(base.expand(B, 2), slots.to(torch.int32))),
        ("site_keys", lambda: rng.site_keys(sk, rng.SITE_WALK)),
        ("fold_in negative", lambda: rng.fold_in(sk, -3)),
        ("part_slot_keys int", lambda: rng.part_slot_keys(sk, rng.PART_GAP_BASE, 2)),
        ("part_slot_keys tensor", lambda: rng.part_slot_keys(sk, rng.PART_SEGMENT_BASE, part)),
        ("fold_in [B, F] (ir)", lambda: rng.fold_in(sk[:, None, :], f_ids[None, :])),
        ("fold_in [T, B] (walk)", lambda: walk),
        ("fold_in 4-d", lambda: rng.fold_in(sk[:, None, None, :].expand(B, 2, 3, 2), f_ids[:3])),
        ("bits_per_slot", lambda: rng.bits_per_slot(sk, rng.SITE_QUAL, (37,))),
        ("uniform_per_slot ()", lambda: rng.uniform_per_slot(sk, rng.SITE_STRAND)),
        ("uniform_per_slot (5, 2)", lambda: rng.uniform_per_slot(sk, rng.SITE_REF_LENGTH, (5, 2))),
        ("uniform_per_slot strided keys", lambda: rng.uniform_per_slot(sk[::2], 3, (9,))),
        ("uniform2_per_slot", lambda: rng.uniform2_per_slot(sk, rng.SITE_IUPAC, (101,))),
        ("uniform_at int32", lambda: rng.uniform_at(sk, rng.SITE_HEAD_TAIL, pos32, 600)),
        ("uniform_at int64", lambda: rng.uniform_at(sk, rng.SITE_HEAD_TAIL, pos32.long(), 600)),
        ("bits_at", lambda: rng.bits_at(sk, pos64)),
        ("uniform_f64 ()", lambda: rng.uniform_f64(rng.fold_in(sk, 3))),
        ("uniform_f64 (3,)", lambda: rng.uniform_f64(sk, (3,))),
        ("uniform [T, B, 2]", lambda: rng.uniform(walk, (3,))),
        ("uniform [B, F, 2]", lambda: rng.uniform(rng.fold_in(sk[:, None, :], f_ids[None, :]))),
        ("normal_per_slot", lambda: rng.normal_per_slot(sk, rng.SITE_LOGNORMAL_LEN)),
    ]


def _plain(mp):
    """Route every draw to the int64 version, whatever the device."""
    mp.setattr(rng, "_on_card", lambda t: False)


def _no_library(*args, **kwargs):
    raise AssertionError("the draw library was loaded")


# --- on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_cpu_tensors_take_the_int64_path(seed, monkeypatch):
    """Every public draw on CPU tensors runs the plain version: the library
    is never loaded, nothing is launched, and no profiler count is made of a
    launch or of a hash on the card."""
    monkeypatch.setattr(draw_cuda.LIBRARY, "load", _no_library)
    before = draw_cuda.launches
    tracing.RECORDER.reset()  # the session's counts alone
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        base = rng.base_key(seed, rng.STREAM_ALIGNED, device="cpu")
        for name, draw in _every_draw(base, 23, "cpu", seed):
            out = draw()
            for t in out if isinstance(out, tuple) else (out,):
                assert t.device.type == "cpu", name
    assert draw_cuda.launches == before
    counts = tracing.RECORDER.counts
    assert counts.get("rng.draw_launches", 0) == 0
    assert counts.get("rng.plain_hashes_on_card", 0) == 0


def _refused():
    """(name, thunk) of card-path calls the wrapper must refuse."""
    sk = rng.slot_keys(rng.base_key(5, device="cpu"), torch.arange(6))
    pos = torch.zeros(6, 4, dtype=torch.int64)
    return {
        "int32 keys": lambda: rng.uniform_per_slot(on_card(sk.to(torch.int32)), 1, (3,)),
        "keys not pairs": lambda: rng.fold_in(on_card(sk[:, :1]), 3),
        "float data": lambda: rng.fold_in(on_card(sk), on_card(torch.zeros(6))),
        "float positions": lambda: rng.uniform_at(on_card(sk), 1, on_card(pos.double()), 4),
        "positions of another batch": lambda: rng.bits_at(on_card(sk), on_card(pos[:5])),
        "0-d positions": lambda: rng.bits_at(on_card(sk), on_card(torch.tensor(1))),
        "f64 of 3-d keys": lambda: rng.uniform_f64(on_card(sk[None])),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_card_path_refuses_before_building(case, monkeypatch):
    """A type, layout or batch the kernels do not take raises ValueError on
    the card path before the library is loaded, and nothing is launched."""
    monkeypatch.setattr(draw_cuda.LIBRARY, "load", _no_library)
    before = draw_cuda.launches
    with pytest.raises(ValueError):
        _refused()[case]()
    assert draw_cuda.launches == before


# a numpy model of csrc/draw.cu's two launchers, reading and writing through
# the pointers the wrapper passes (CPU tensors' memory), so that the CPU holds
# the wrapper's layouts to rng's plain version


def _tf(k0, k1, x1):
    k0, k1, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = np.zeros_like(x1) + k0, x1 + k1
    for i in range(5):
        for r in (13, 15, 26, 6) if i % 2 == 0 else (17, 29, 16, 24):
            x0 = x0 + x1
            x1 = x0 ^ ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r)))
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _mem(ptr, ctype, n):
    return np.ctypeslib.as_array((ctype * max(int(n), 1)).from_address(ptr))


class _ModelLibrary:
    def launch_fold_in(self, keys, k_r, k_c, k_w, data, d_bytes, d_r, d_c, add, R, C, out, st):
        r, c = np.arange(R)[:, None], np.arange(C)[None, :]
        at = 2 * (r * k_r + c * k_c)
        words = _mem(keys, ctypes.c_uint32, at.max() + 2 * k_w + 1)
        x1 = np.full((R, C), add, np.uint64)
        if data:
            di = r * d_r + c * d_c
            dv = _mem(data, ctypes.c_int32 if d_bytes == 4 else ctypes.c_int64, di.max() + 1)[di]
            x1 = x1 + (dv.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF))
        y0, y1 = _tf(words[at], words[at + 2 * k_w], (x1 & np.uint64(0xFFFFFFFF)))
        o = _mem(out, ctypes.c_int64, 2 * R * C).reshape(R * C, 2)
        o[:, 0], o[:, 1] = y0.reshape(-1), y1.reshape(-1)
        return 0

    def launch_draw(self, kind, keys, k_row, k_word, fold, site, pos, p_bytes, clamp, hi, B, n,
                    out0, out1, st):
        b = np.arange(B)[:, None]
        words = _mem(keys, ctypes.c_uint32, 2 * ((B - 1) * k_row + k_word) + 1)
        k0, k1 = words[2 * b * k_row], words[2 * (b * k_row + k_word)]
        if fold:
            k0, k1 = _tf(k0, k1, np.full(k0.shape, site, np.uint32))
        if pos:
            p = _mem(pos, ctypes.c_int32 if p_bytes == 4 else ctypes.c_int64, B * n)
            p = p.reshape(B, n).astype(np.int64)
            if clamp:
                p = np.minimum(np.maximum(p, 0), hi)
            ctr = (p.astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        else:
            ctr = np.broadcast_to(np.arange(n, dtype=np.uint32), (B, n))
        y0, y1 = _tf(np.broadcast_to(k0, (B, n)), np.broadcast_to(k1, (B, n)), ctr)
        bits = (y0 ^ y1).reshape(-1)
        if kind == draw_cuda.BITS:
            _mem(out0, ctypes.c_int64, B * n)[:] = bits
        elif kind == draw_cuda.UNIFORM:
            u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
            _mem(out0, ctypes.c_float, B * n)[:] = u
        elif kind == draw_cuda.UNIFORM2:
            scale = np.float32(1 / 65536)
            _mem(out0, ctypes.c_float, B * n)[:] = (bits & np.uint32(0xFFFF)).astype(np.float32) * scale
            _mem(out1, ctypes.c_float, B * n)[:] = (bits >> np.uint32(16)).astype(np.float32) * scale
        else:
            mant = ((y0.astype(np.uint64) << np.uint64(20)) | (y1.astype(np.uint64) >> np.uint64(12)))
            u = (mant.reshape(-1) | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
            _mem(out0, ctypes.c_double, B * n)[:] = u
        return 0


@pytest.mark.parametrize("B", [1, 37, 512])
def test_wrapper_layouts_give_the_plain_bits(B, monkeypatch):
    """Every public draw through the card path's wrapper, with the launchers
    modelled in numpy, equals rng's plain version on the same CPU tensors:
    the broadcast fold_in grids ([B], [B, F], [T, B], 4-d), strided and
    expanded keys, int32 data and positions, empty batches; one modelled
    launch a draw (two where a draw folds its keys first)."""
    with monkeypatch.context() as mp:
        mp.setattr(draw_cuda.LIBRARY, "load", _ModelLibrary)
        mp.setattr(draw_cuda, "current_raw_stream", lambda dev: 0)
        mp.setattr(rng, "_on_card", lambda t: True)
        before = draw_cuda.launches
        got = {}
        for seed in SEEDS[1:3]:
            base = rng.base_key(seed, device="cpu")
            for name, draw in _every_draw(base, B, "cpu", seed):
                got[seed, name] = draw()
        empty = rng.uniform_per_slot(rng.slot_keys(base, torch.arange(0)), 3, (9,))
        assert draw_cuda.launches > before + len(got)
    assert empty.shape == (0, 9) and empty.dtype == torch.float32
    for seed in SEEDS[1:3]:
        base = rng.base_key(seed, device="cpu")
        for name, draw in _every_draw(base, B, "cpu", seed):
            _assert_same(got[seed, name], draw(), (seed, name))


def test_only_rng_runs_the_int64_hash():
    """No module of the package but ops/rng.py calls rng's int64 hash or its
    bits-to-float step: every caller goes through a public draw, which runs
    as the kernel on the card."""
    bad = []
    for root, _, files in os.walk(PKG):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith(".py") or path == os.path.join(PKG, "ops", "rng.py"):
                continue
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if re.search(r"\brng\.(_threefry2x32|_bits_to_uniform|_flat_positions)\b",
                                 line):
                        bad.append(f"{os.path.relpath(path, PKG)}:{i}")
    assert bad == []


# --- on the card ------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the draw kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [512, 2048])
def test_every_draw_matches_the_int64_path_on_card(B, monkeypatch):
    """At the meta-only programs' lane counts, with 64-bit seeds and slot
    ids past 2**32: each public draw on CUDA tensors equals the int64
    version on the same tensors, bit for bit, in dtype, shape and device;
    the kernel path runs no int64 hash."""
    dev = _card()
    for seed in SEEDS:
        base = rng.base_key(seed, device=dev)
        before = draw_cuda.launches
        tracing.RECORDER.reset()  # the session's counts alone
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = [(name, draw()) for name, draw in _every_draw(base, B, dev, seed)]
            torch.cuda.synchronize()
        counts = dict(tracing.RECORDER.counts)
        assert counts.get("rng.plain_hashes_on_card", 0) == 0
        assert counts.get("rng.draw_launches", 0) == draw_cuda.launches - before > 0
        with monkeypatch.context() as mp:
            _plain(mp)
            base_p = rng.base_key(seed, device=dev)
            _assert_same(base, base_p, "base_key")
            want = [(name, draw()) for name, draw in _every_draw(base_p, B, dev, seed)]
        for (name, g), (_, w) in zip(got, want):
            _assert_same(g, w, (seed, B, name))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 19456), (37, 3001)])
def test_wide_draws_match_the_int64_path_on_card(shape, monkeypatch):
    """The read-emitting program's [2,048 x 19,456] quality draw and a
    ragged [37 x 3,001] (rows of no multiple of 4, so that a thread's 4
    draws meet the row's end and the stores go scalar): per-slot bits,
    uniforms, the two 16-bit uniforms, the float64 uniform and the clamped
    uniform at positions, each bit-equal to the int64 version."""
    dev = _card()
    B, n = shape
    sk = rng.slot_keys(rng.base_key(2**63 + 9, device=dev), _slots(B, 4, dev))
    g = torch.Generator().manual_seed(7)
    pos = torch.randint(-5, n + 5, (B, n), generator=g).to(torch.int32).to(dev)
    draws = {
        "bits_per_slot": lambda: rng.bits_per_slot(sk, rng.SITE_HOMOPOLYMER, (n,)),
        "uniform_per_slot": lambda: rng.uniform_per_slot(sk, rng.SITE_QUAL, (n,)),
        "uniform2_per_slot": lambda: rng.uniform2_per_slot(sk, rng.SITE_MIS_BASE, (n,)),
        "uniform_f64": lambda: rng.uniform_f64(sk, (n // 8,)),
        "uniform_at": lambda: rng.uniform_at(sk, rng.SITE_HEAD_TAIL, pos, n - 3),
    }
    for name, draw in draws.items():
        got = draw()
        with monkeypatch.context() as mp:
            _plain(mp)
            want = draw()
        torch.cuda.synchronize()
        _assert_same(got, want, (shape, name))
        del got, want
        torch.cuda.empty_cache()


def _batch_programs(d, dev):
    """name -> a function running one batch program on the card, built on a
    300 kb linear reference (meta-only genome and chimeric batches, 512
    lanes) and a 100 kb circular one (read-emitting batches, with and
    without -hp -k 6)."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import error_model, fixtures, profile
    from nanosim_tpu_torch.sim.chimeric_mode import ChimericGenomeSimulator
    from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator

    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=8000, sd_read_len=2200, n_kde_points=400)
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.3, 0.2)
    lin, circ = os.path.join(d, "lin.fa"), os.path.join(d, "circ.fa")
    fixtures.make_reference_fasta(lin, [200000, 100000], seed=5)
    fixtures.make_reference_fasta(circ, [100000], seed=6, hp_bias=0.5)
    linear = PackedGenome.from_fasta(lin)
    circular = PackedGenome.from_fasta(circ, dna_type="circular")
    plain = profile.load_profile(prefix, mode="genome", fastq=True)
    hp = profile.load_profile(prefix, mode="genome", fastq=True, homopolymer=True)
    chi = profile.load_profile(prefix, mode="genome", fastq=True, chimeric=True)
    B = 512
    sims = {
        "genome meta-only": (GenomeSimulator(linear, plain, fastq=True, batch=B, device=dev),
                             {"emit_reads": False}),
        "chimeric meta-only": (ChimericGenomeSimulator(linear, chi, fastq=True, batch=B,
                                                       device=dev), {"emit_reads": False}),
        "circular read-emitting": (GenomeSimulator(circular, plain, fastq=True,
                                                   circular_dna=True, batch=B, device=dev), {}),
        "circular -hp read-emitting": (GenomeSimulator(circular, hp, fastq=True,
                                                       circular_dna=True, batch=B, kmer_bias=6,
                                                       device=dev), {}),
    }

    def runner(sim, kw):
        def run(seed, slot_start):
            base = rng.base_key(seed, rng.STREAM_ALIGNED, device=dev)
            slots = torch.arange(slot_start, slot_start + B, dtype=torch.int64, device=dev)
            return sim.batch_fn(**kw)(base, slots)
        return run

    return {name: runner(*v) for name, v in sims.items()}


@pytest.fixture(scope="module")
def batch_programs(tmp_path_factory):
    dev = _card()
    return _batch_programs(str(tmp_path_factory.mktemp("draw_batches")), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("program", ["genome meta-only", "chimeric meta-only",
                                     "circular read-emitting", "circular -hp read-emitting"])
def test_batch_programs_match_the_int64_path_on_card(program, batch_programs, monkeypatch):
    """A whole batch program on the card gives every field of its output
    equal, bit for bit, to the same program with every draw on the int64
    version (64-bit seed, slots past 2**32); with the kernels it runs no
    int64 hash and launches the draw kernel, without them it hashes in int64."""
    run = batch_programs[program]
    for seed, start in ((11, 0), (2**63 + 1, 2**32 - 100)):
        tracing.RECORDER.reset()  # each session's counts alone
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = run(seed, start)
            torch.cuda.synchronize()
        counts = dict(tracing.RECORDER.counts)
        assert counts.get("rng.plain_hashes_on_card", 0) == 0 and counts["rng.draw_launches"] > 0
        with monkeypatch.context() as mp:
            _plain(mp)
            tracing.RECORDER.reset()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                want = run(seed, start)
                torch.cuda.synchronize()
            counts = dict(tracing.RECORDER.counts)
        assert counts["rng.plain_hashes_on_card"] > 0 and "rng.draw_launches" not in counts
        assert type(got) is type(want)
        for field, g, w in zip(type(want)._fields, got, want):
            if w is None:
                assert g is None, field
            else:
                _assert_same(g, w, (program, seed, field))
