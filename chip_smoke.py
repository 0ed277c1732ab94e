#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Phases (any failure exits non-zero, and no result line is printed):

1. the card: `nvidia-smi` name and power limit, torch's device name and count;
2. builds: csrc/walk.cu, csrc/gather.cu and csrc/assemble.cu with nvcc
   (sm_90a, one nvcc per source; the ptxas reports are printed) and
   native/fastwriter.cpp with g++, all started together;
3. kernels from the bench configuration's tables (mean read 8,000, sd
   2,200, 2,000 KDE points).  The walks on the main path's first batch: the
   aligned walk at B=2,048 with the lean event budget (1,120) and at the
   overflow rescue's B=64 with the full budget, the unaligned walk at
   B=2,048 with its own budget; and both again at B=8,192.  The packed-code
   gather (K3) on the inputs the circular path's first read-emitting batch
   gives it (B=2,048, L=19,456, 4,480 packed bytes per lane) and at a ragged
   shape (B=37, L=3,000).  The element gather (K4, 1-byte and 2-byte
   elements) and the read assembly (K5) on the inputs the `-hp` path's first
   read-emitting batch gives them (B=2,048, W=L=17,920; l_out=19,456), and
   at ragged shapes (B=37, not a multiple of 8, both strands, lanes without
   head or tail and one filling l_out); that batch's peak device memory is
   printed.  Each kernel must equal its plain PyTorch version on the card on
   every output; then each is timed with CUDA events beside the plain
   version, its bound and (K3, K4, K5) one torch.gather of the same bytes;
4. the CUDA path against the CPU path of the same program at a small size:
   byte-identical FASTQ and error-profile files (the CPU path is held
   byte-identical to the JAX package by the test suite), for linear DNA on
   the host-reconstruction route, circular DNA, and linear DNA with
   NANOSIM_TPU_RECON=0; then the same three with `-hp -k 6` on references
   written with hp_bias, so that suppression and resizing fire;
5. the main path: `simulate_genome(device="cuda")` at the bench's size (48 Mb
   genome in 4 chromosomes, 20,000 reads, batch 2,048, FASTQ).  The kernels'
   launch counters are zeroed just before and read just after; both walks
   must have launched, no lane may have needed the checksum fallback, the
   read counts must match, the first 200 error-profile records' ref_base
   must match the genome at pos + Seq_pos, and a second run with the same
   seed must give byte-identical files;
6. the circular path at full width: one circular chromosome of 4,641,652 bp
   (the size of E. coli K-12 MG1655; random bases with ambiguity codes from
   the fixture writer), 10,000 reads, batch 2,048, FASTQ.  The counters are
   zeroed just before and read just after; K1, K2 and K3 must have launched,
   with 0 checksum-fallback lanes, matching record counts, ref_base checked
   on 200 records and on every record that wraps the origin, and a traced
   same-seed rerun that is byte-identical;
7. NANOSIM_TPU_RECON=0 at full width: 4,000 reads on the 48 Mb genome; the
   files must equal a host-reconstruction run of the same seed and size (the
   on-card oracle for K3 and the fused read);
8. the `-hp` path at full width (`-hp -k 6`, FASTQ, batch 2,048): the
   device-materialized route on the circular chromosome of phase 6, 10,000
   reads, with the counters zeroed just before and read just after; K1, K2,
   K4 and K5 must have launched, with 0 checksum-fallback lanes, matching
   record counts, the wrap-aware ref_base check, a traced byte-identical
   rerun, and the seconds the host spends composing the error log;
9. `-hp` on the host-reconstruction route: 20,000 reads on the 48 Mb genome
   (reads/s, fallback and rescue lanes, ref_base), then 2,000 reads with
   NANOSIM_TPU_RECON=0 against the default route: the files must be equal.

The line before the last is the kernels' JSON record (the walks at the main
path's lean shapes with the main path's launches, K3 at the circular path's
shape with the circular path's launches, K4 and K5 at the `-hp` path's shape
with the `-hp` path's launches); the line before it holds the other shapes.  The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 7
N_READS = 20000
BATCH = 2048
GENOME_MB = 48
KERNEL_B = 8192
CIRC_LEN = 4641652  # E. coli K-12 MG1655 (NCBI NC_000913.3)
N_CIRC = 10000
N_RECON0 = 4000
HP_K = 6  # `-hp -k 6`
N_HP = 10000  # the -hp path (device-materialized route, circular chromosome)
N_HP_RECON = 20000  # -hp on the host-reconstruction route (48 Mb genome)
N_HP_RECON0 = 2000  # -hp, NANOSIM_TPU_RECON=0 against the default route
TIMED_LAUNCHES = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Instruction rates: the 67 TFLOP/s float32 peak counts a fused multiply-add
# as two operations over 128 float32 lanes per SM, so the float32 pipe issues
# 33.5e12 instructions (a compare, a subtract) per second; Hopper has 64
# int32 lanes per SM, half that
F32_OPS_PER_S = 33.5e12
INT32_OPS_PER_S = 16.75e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fail(msg: str):
    log(f"chip_smoke: FAILED: {msg}")
    sys.exit(1)


def sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card, flush=True)
    print(f"torch device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    return card, kind, count


def phase_build():
    from nanosim_tpu_torch.io import native
    from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda, walk_cuda

    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (walk_cuda.LIBRARY.load, gather_cuda.LIBRARY.load,
                          assemble_cuda.LIBRARY.load, native.get_lib)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors[0]}")
    if native.get_lib() is None:
        fail("native/fastwriter.cpp did not build")
    print(f"builds done in {time.time() - t0:.1f}s", flush=True)
    for lib in (walk_cuda.LIBRARY, gather_cuda.LIBRARY, assemble_cuda.LIBRARY):
        print(f"nvcc -Xptxas -v ({os.path.basename(lib.src)}):\n"
              + (lib.build_log.strip() or "(library was already built)"), flush=True)


def make_fixture(d: str, genome_mb: float, mean_len: float, sd_len: float, n_kde: int):
    from nanosim_tpu_torch.profiles import fixtures

    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=mean_len, sd_read_len=sd_len,
                            n_kde_points=n_kde)
    ref = os.path.join(d, "ref.fa")
    per = int(genome_mb * 1e6 / 4)
    fixtures.make_reference_fasta(ref, [per] * 4, seed=11)
    return prefix, ref


def _time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# Operations of one walk step, counted from csrc/walk.cu at the least the
# step needs.  A threefry-2x32 hash is 20 rounds of add, rotate and xor plus
# five key injections of two adds and the two initial adds: 72 integer
# operations.  A uniform from 32 bits is a shift and an or (integer) and a
# subtract (float32).  A lookup in a sorted row of n entries needs
# ceil(log2(n)) + 1 compares (binary search).  The state arithmetic of a step
# (overshoot, clamps, the event word, the loop test) is counted by hand from
# the kernel source.
THREEFRY_INT_OPS = 72
ALIGNED_STATE_INT_OPS = 40
UNALIGNED_STATE_INT_OPS = 25


def _lookup(n: int) -> int:
    return (n - 1).bit_length() + 1


def _aligned_ops_per_step(n_t: int, nb: int, K: int):
    """(integer, float32) operations of one aligned step: four hashes (the
    step's folded key and three draws), three uniforms, the transition row
    (3 float compares), the mixture row, the match-length bin (integer
    compares) and the bin's break row."""
    ints = 4 * THREEFRY_INT_OPS + 3 * 2 + _lookup(nb) + ALIGNED_STATE_INT_OPS
    f32 = 3 + 3 + _lookup(n_t) + _lookup(K)
    return ints, f32


def _unaligned_ops(n_t: int, steps: int, err_steps: int):
    """(integer, float32) operations of the unaligned steps: three hashes and
    two uniforms per step, the three type thresholds, and the mixture row only
    on the steps that drew an error."""
    ints = steps * (3 * THREEFRY_INT_OPS + 2 * 2 + UNALIGNED_STATE_INT_OPS)
    f32 = steps * (2 + 3) + err_steps * _lookup(n_t)
    return ints, f32


def _bound_ms(n_bytes: int, int_ops: int, f32_ops: int):
    """The least time on the card: bytes over the memory rate, or the
    integer and float32 pipes' operations over their instruction rates,
    whichever is larger (the two pipes may overlap, so each is its own
    bound)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernels(prefix: str, ref: str):
    """Each kernel against its plain version, timed beside its bound, at the
    main path's shapes (B = the batch; the rescue's B=64 at the full budget)
    and at B=8,192.  Returns the rows: those at the main path's lean shapes
    are the kernels' record."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import error_walk, rng, walk_cuda
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.bundles import FULL_EVENT_SLACK, plan_event_budget
    from nanosim_tpu_torch.sim.genome_mode import (GenomeSimulator, OverflowRescueWriter,
                                                   _kde_draw)
    from nanosim_tpu_torch.sim.unaligned_mode import UnalignedSimulator

    dev = torch.device("cuda")
    genome = PackedGenome.from_fasta(ref)
    prof = profile.load_profile(prefix, mode="genome", fastq=True)
    sim = GenomeSimulator(genome, prof, fastq=True, batch=BATCH, device=dev)
    usim = UnalignedSimulator(genome, prof, fastq=True, batch=BATCH, device=dev)
    t = sim.tables
    e_full = plan_event_budget(prof, sim.l_cap, slack=FULL_EVENT_SLACK)
    print(f"plan: l_cap={sim.l_cap} ht_cap={sim.ht_cap} e_max={sim.e_max} "
          f"e_full={e_full} unaligned l_cap={usim.l_cap} e_max={usim.e_max}", flush=True)

    # slots 0.. are the main path's first batch (same seed), so the first
    # BATCH lanes are exactly the inputs its first launch gets
    slots = torch.arange(KERNEL_B, dtype=torch.int64, device=dev)
    sk = rng.slot_keys(rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev), slots)
    m_ref = _kde_draw(sk, rng.SITE_REF_LENGTH, t.kde_aligned)[:, 0].to(torch.int32).clamp(0, sim.l_cap)
    wk = rng.site_keys(sk, rng.SITE_WALK)
    fm = error_walk.first_match(wk, t.first_match)
    usk = rng.slot_keys(rng.base_key(SEED, rng.STREAM_UNALIGNED, device=dev), slots)
    um = _kde_draw(usk, rng.SITE_REF_LENGTH, t.kde_unaligned)[:, 0].to(torch.int32).clamp(0, usim.l_cap)
    uwk = rng.site_keys(usk, rng.SITE_UNALIGNED_WALK)

    n_t = t.mixtures.cdf_t.shape[1]
    nb, K = t.match_markov.breaks.shape
    table_bytes = 4 * (3 * n_t + 2 * nb * K + 2 * nb + 21)
    rescue_b = OverflowRescueWriter.RESCUE_BATCH
    # role: "record" = the main path's lean shapes (the kernels' record),
    # "rescue" = the overflow rescue's shape, "" = B=8,192 (no main-path launch)
    cases = [  # (name, kind, B, E, role)
        ("aligned_walk", "aligned", BATCH, sim.e_max, "record"),
        ("unaligned_walk", "unaligned", BATCH, usim.e_max, "record"),
        ("aligned_walk", "aligned", rescue_b, e_full, "rescue"),
        ("aligned_walk", "aligned", KERNEL_B, sim.e_max, ""),
        ("aligned_walk", "aligned", KERNEL_B, e_full, ""),
        ("unaligned_walk", "unaligned", KERNEL_B, usim.e_max, ""),
    ]
    results = []
    for name, kind, B, E, role in cases:
        if kind == "aligned":
            args = (wk[:B], m_ref[:B], fm[:B], t.match_markov, t.mixtures, t.trans, E)
            kern, plain = walk_cuda.aligned_steps, walk_cuda.aligned_steps_plain
            in_bytes = B * (8 + 4 + 4) + table_bytes
            source_line = "nanosim_tpu/ops/walk_pallas.py:464"
        else:
            args = (uwk[:B], um[:B], t.mixtures, E)
            kern, plain = walk_cuda.unaligned_steps, walk_cuda.unaligned_steps_plain
            in_bytes = B * (8 + 4) + 4 * 3 * n_t
            source_line = "nanosim_tpu/ops/walk_pallas.py:554"
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        max_err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{name} B={B} E={E}: kernel output shape {tuple(g.shape)} "
                     f"!= plain {tuple(w.shape)}")
            max_err = max(max_err, int((g.long() - w.long()).abs().max()))
        if max_err != 0:
            fail(f"{name} B={B} E={E}: kernel differs from its plain version "
                 f"(max abs err {max_err})")
        steps = int(got[4].long().sum())
        if kind == "aligned":
            ints, f32 = (steps * c for c in _aligned_ops_per_step(n_t, nb, K))
        else:
            err_steps = int((((got[0].long() >> 19) & 0x7FF) > 0).sum())
            ints, f32 = _unaligned_ops(n_t, steps, err_steps)
        # the kernel writes each lane's event prefix and four per-lane words
        out_bytes = 4 * steps + 4 * 4 * B
        bound, bound_by = _bound_ms(in_bytes + out_bytes, ints, f32)
        ms = _time_ms(lambda: kern(*args), TIMED_LAUNCHES)
        plain_ms = _time_ms(lambda: plain(*args), 1)
        blocks = -(-B // walk_cuda.THREADS_PER_BLOCK)
        results.append({
            "name": name, "route": "cuda", "source": "nanosim_tpu_torch/csrc/walk.cu",
            "replaces": source_line, "B": B, "E": E, "blocks": blocks, "steps": steps,
            "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "role": role,
        })
        print(f"kernel {name}: B={B} E={E} ({blocks} blocks of "
              f"{walk_cuda.THREADS_PER_BLOCK}) steps={steps} exact; {ms:.3f} ms "
              f"(plain {plain_ms:.1f} ms, bound {bound:.4f} ms by {bound_by}, "
              f"{ms / bound:.1f}x the bound)", flush=True)
    return results


def _ragged_gather_inputs(B: int, PB: int, L: int, seed: int):
    """Packed rows and near-contiguous source indices (output position plus
    a random walk of indel drift, a few out of the row), from numpy."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    packed = rs.integers(0, 256, (B, PB), dtype=np.uint8)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    src = rs.integers(-8, 64, (B, 1)) + np.arange(L)[None, :] + drift
    src[:, :3] = [-5, 4 * PB + 7, 4 * PB - 1]
    return (torch.from_numpy(packed).cuda(), torch.from_numpy(src.astype(np.int32)).cuda())


def phase_gather(prefix: str, circ_ref: str):
    """K3 against its plain version, timed beside its bound and one
    torch.gather of the same bytes: on the inputs the circular path's first
    read-emitting batch gives it (the record), and at a ragged shape."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import apply_errors, gather_cuda, rng
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator

    dev = torch.device("cuda")
    genome = PackedGenome.from_fasta(circ_ref, dna_type="circular")
    prof = profile.load_profile(prefix, mode="genome", fastq=True)
    sim = GenomeSimulator(genome, prof, fastq=True, circular_dna=True, batch=BATCH, device=dev)
    captured = []

    def capture(packed, src):
        captured.append((packed, src))
        return gather_cuda.gather_codes(packed, src)

    # slots 0.. with the run's seed are the circular path's first batch; the
    # fused read reaches the kernel through apply_errors.gather_cuda
    apply_errors.gather_cuda = types.SimpleNamespace(gather_codes=capture)
    try:
        sim.batch_fn()(rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev),
                       torch.arange(BATCH, dtype=torch.int64, device=dev))
    finally:
        apply_errors.gather_cuda = gather_cuda
    if len(captured) != 1:
        fail(f"the read-emitting batch called the gather {len(captured)} times, not once")
    cases = [("record", *captured[0]), ("", *_ragged_gather_inputs(37, 770, 3000, 2))]
    results = []
    for role, packed, src in cases:
        B, L = src.shape
        PB = packed.shape[1]
        got = gather_cuda.gather_codes(packed, src)
        want = gather_cuda.gather_codes_plain(packed, src)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"gather_codes B={B} L={L}: kernel output {tuple(got.shape)} {got.dtype} "
                 f"!= plain {tuple(want.shape)} {want.dtype}")
        max_err = int((got.int() - want.int()).abs().max())
        if max_err != 0:
            fail(f"gather_codes B={B} L={L}: kernel differs from its plain version "
                 f"(max abs err {max_err})")
        # each index read once (4 B), each packed row once, each code written once
        bound, bound_by = _bound_ms(4 * B * L + B * PB + B * L, 0, 0)
        ms = _time_ms(lambda: gather_cuda.gather_codes(packed, src), TIMED_LAUNCHES)
        plain_ms = _time_ms(lambda: gather_cuda.gather_codes_plain(packed, src), TIMED_LAUNCHES)
        # the library yardstick: one torch.gather of the packed bytes (its
        # int64 index is made outside the timed call)
        idx = (src >> 2).clamp(0, PB - 1).long()
        library_ms = _time_ms(lambda: torch.gather(packed, 1, idx), TIMED_LAUNCHES)
        results.append({
            "name": "gather_codes", "route": "cuda", "source": "nanosim_tpu_torch/csrc/gather.cu",
            "replaces": "nanosim_tpu/ops/window_gather.py:115", "B": B, "L": L, "PB": PB,
            "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms, "role": role,
        })
        print(f"kernel gather_codes: B={B} L={L} PB={PB} exact; {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, torch.gather {library_ms:.4f} ms, bound {bound:.4f} ms by "
              f"{bound_by}, {ms / bound:.1f}x the bound)", flush=True)
    return results


def _ragged_rows(B: int, W: int, L: int, seed: int, two_bytes: bool):
    """Rows of 1-byte or 2-byte elements and in-range indices that follow the
    output position with a drift, from numpy."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    parts = rs.integers(0, 1 << 15 if two_bytes else 256, (B, W)).astype(
        np.int16 if two_bytes else np.uint8)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    idx = np.clip(rs.integers(0, 64, (B, 1)) + np.arange(L)[None, :] + drift, 0, W - 1)
    return torch.from_numpy(parts).cuda(), torch.from_numpy(idx.astype(np.int32)).cuda()


def _ragged_assembly(B: int, l_cap: int, ht_cap: int, l_out: int, seed: int):
    """Packed middles and head/tail pools from numpy: both strands, lanes
    without head, without tail, with neither, and one whose total is l_out."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    mid = (bases[rs.integers(0, 4, (B, l_cap))].astype(np.int16)
           | (rs.integers(0, 3, (B, l_cap)).astype(np.int16) << 8))
    ht = bases[rs.integers(0, 4, (B, ht_cap))].astype(np.int16) | np.int16(3 << 8)
    l_new = rs.integers(10, l_cap, B).astype(np.int32)
    head = rs.integers(0, ht_cap // 2, B).astype(np.int32)
    tail = rs.integers(0, ht_cap // 2, B).astype(np.int32)
    head[:4] = [0, 0, 5, 0]
    tail[:4] = [0, 7, 0, 0]
    head[4] = (l_out - l_cap) // 2
    tail[4] = l_out - l_cap - head[4]
    l_new[3:5] = l_cap
    is_rev = rs.random(B) < 0.5
    is_rev[:5] = [True, False, True, False, True]
    total = (head + l_new + tail).astype(np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (mid, ht, head, l_new, total, is_rev)) + (l_out,)


def phase_hp_kernels(prefix: str, circ_ref: str):
    """K4 (1-byte and 2-byte elements) and K5 against their plain versions,
    timed beside their bounds and one torch.gather of the same bytes: on the
    inputs the `-hp` path's first read-emitting batch gives them (the
    record), and at ragged shapes.  Prints that batch's peak device memory."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import apply_errors, assemble_cuda, gather_cuda, homopolymer, rng
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim import genome_mode

    dev = torch.device("cuda")
    genome = PackedGenome.from_fasta(circ_ref, dna_type="circular")
    prof = profile.load_profile(prefix, mode="genome", fastq=True, homopolymer=True)
    sim = genome_mode.GenomeSimulator(genome, prof, fastq=True, circular_dna=True, batch=BATCH,
                                      kmer_bias=HP_K, device=dev)
    rows, asm = [], []

    def cap_gather(parts, idx):
        rows.append((parts, idx))
        return gather_cuda.gather_u8(parts, idx)

    def cap_assemble(*args):
        asm.append(args)
        return assemble_cuda.assemble_rolls(*args)

    # slots 0.. with the run's seed are the -hp path's first batch; the
    # unfused read reaches the kernels through these module attributes
    apply_errors.gather_cuda = types.SimpleNamespace(gather_u8=cap_gather)
    homopolymer.gather_cuda = types.SimpleNamespace(gather_u8=cap_gather)
    genome_mode.assemble_cuda = types.SimpleNamespace(assemble_rolls=cap_assemble)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = sim.batch_fn()(rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev),
                             torch.arange(BATCH, dtype=torch.int64, device=dev))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        apply_errors.gather_cuda = homopolymer.gather_cuda = gather_cuda
        genome_mode.assemble_cuda = assemble_cuda
    if [p.element_size() for p, _ in rows] != [1, 2] or len(asm) != 1:
        fail(f"the -hp batch called the element gather at widths "
             f"{[p.element_size() for p, _ in rows]} and the assembly {len(asm)} times, "
             "not once per width and once")
    print(f"-hp batch (B={BATCH}, l_cap={sim.l_cap}, l_out={sim.l_out}, hp_r_max={sim.hp_r_max}, "
          f"hp table {tuple(sim.tables.hp_breaks.shape)}): peak device memory "
          f"{peak / 1e9:.3f} GB; {int(out.valid.sum())} valid lanes, "
          f"{int(out.capacity_overflow.sum())} capacity overflows", flush=True)
    del out
    results = []
    gather_cases = [("record", *rows[0]), ("record", *rows[1]),
                    ("", *_ragged_rows(37, 2900, 3000, 4, False)),
                    ("", *_ragged_rows(37, 2900, 3000, 5, True))]
    for role, parts, idx in gather_cases:
        B, L = idx.shape
        W, es = parts.shape[1], parts.element_size()
        name = "gather_u8" if es == 1 else "gather_u8[int16]"
        got = gather_cuda.gather_u8(parts, idx)
        want = gather_cuda.gather_u8_plain(parts, idx)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} B={B} L={L}: kernel output {tuple(got.shape)} {got.dtype} "
                 f"!= plain {tuple(want.shape)} {want.dtype}")
        max_err = int((got.int() - want.int()).abs().max())
        if max_err != 0:
            fail(f"{name} B={B} L={L}: kernel differs from its plain version "
                 f"(max abs err {max_err})")
        # each index read once (4 B), one element read and one written per position
        bound, bound_by = _bound_ms(B * L * (4 + 2 * es), 0, 0)
        ms = _time_ms(lambda: gather_cuda.gather_u8(parts, idx), TIMED_LAUNCHES)
        plain_ms = _time_ms(lambda: gather_cuda.gather_u8_plain(parts, idx), TIMED_LAUNCHES)
        # the library yardstick: torch.gather with its int64 index made outside
        idx64 = idx.long()
        library_ms = _time_ms(lambda: torch.gather(parts, 1, idx64), TIMED_LAUNCHES)
        del idx64
        results.append({
            "name": name, "route": "cuda", "source": "nanosim_tpu_torch/csrc/gather.cu",
            "replaces": "nanosim_tpu/ops/pallas_gather.py:79", "B": B, "L": L, "W": W,
            "elem_bytes": es, "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms, "role": role,
        })
        print(f"kernel {name}: B={B} L={L} W={W} exact; {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"torch.gather {library_ms:.4f} ms, bound {bound:.4f} ms by {bound_by}, "
              f"{ms / bound:.1f}x the bound)", flush=True)
    for role, args in (("record", asm[0]), ("", _ragged_assembly(37, 3000, 700, 4096, 6))):
        mid, ht, head, l_new, total, is_rev, l_out = args
        B, l_cap, ht_cap = mid.shape[0], mid.shape[1], ht.shape[1]
        got = assemble_cuda.assemble_rolls(*args)
        want = assemble_cuda.assemble_rolls_plain(*args)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"assemble_rolls B={B}: kernel output {tuple(got.shape)} {got.dtype} "
                 f"!= plain {tuple(want.shape)} {want.dtype}")
        max_err = int((got.int() - want.int()).abs().max())
        if max_err != 0:
            fail(f"assemble_rolls B={B} l_out={l_out}: kernel differs from its plain version "
                 f"(max abs err {max_err})")
        # what this run's data needs: one 16-bit element read per position
        # below the lane's total, every output position written once, 13
        # bytes of per-lane scalars
        n_read = int(total.clamp(0, l_out).long().sum())
        bound, bound_by = _bound_ms(2 * n_read + 2 * B * l_out + 13 * B, 0, 0)
        ms = _time_ms(lambda: assemble_cuda.assemble_rolls(*args), TIMED_LAUNCHES)
        plain_ms = _time_ms(lambda: assemble_cuda.assemble_rolls_plain(*args), TIMED_LAUNCHES)
        # the library yardstick: the one torch.gather of the one-gather
        # formulation, its concatenated input and int64 index made outside
        parts = torch.cat([mid, ht], dim=1)
        idx64 = torch.arange(l_out, device=dev)[None, :].expand(B, l_out).clamp_max(
            parts.shape[1] - 1).contiguous()
        library_ms = _time_ms(lambda: torch.gather(parts, 1, idx64), TIMED_LAUNCHES)
        del parts, idx64
        results.append({
            "name": "assemble_rolls", "route": "cuda",
            "source": "nanosim_tpu_torch/csrc/assemble.cu",
            "replaces": "nanosim_tpu/ops/pallas_assemble.py:93", "B": B, "l_cap": l_cap,
            "ht_cap": ht_cap, "l_out": l_out, "positions_read": n_read,
            "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms, "role": role,
        })
        print(f"kernel assemble_rolls: B={B} l_cap={l_cap} ht_cap={ht_cap} l_out={l_out} "
              f"({n_read} positions below total, {int(is_rev.sum())} reversed lanes) exact; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, torch.gather {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms by {bound_by}, {ms / bound:.1f}x the bound)", flush=True)
    return results


def _run_sim(ref, prefix, out, n, batch, fastq, device, seed=SEED, dna_type="linear",
             kmer_bias=None):
    from nanosim_tpu_torch.sim.run import simulate_genome

    return simulate_genome(ref, prefix, out, n, fastq=fastq, seed=seed, batch=batch,
                           device=device, dna_type=dna_type, kmer_bias=kmer_bias)


FILES = ("_aligned_reads.fastq", "_aligned_error_profile", "_unaligned_reads.fastq")


@contextlib.contextmanager
def recon_env(value):
    """NANOSIM_TPU_RECON set to `value` (None: unset) inside the block."""
    old = os.environ.get("NANOSIM_TPU_RECON")
    if value is None:
        os.environ.pop("NANOSIM_TPU_RECON", None)
    else:
        os.environ["NANOSIM_TPU_RECON"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NANOSIM_TPU_RECON", None)
        else:
            os.environ["NANOSIM_TPU_RECON"] = old


def phase_cuda_vs_cpu(d: str):
    from nanosim_tpu_torch.profiles import fixtures

    prefix, ref = make_fixture(os.path.join(d, "small"), 0.4, 700, 250, 300)
    circ = os.path.join(d, "small", "circ.fa")
    fixtures.make_reference_fasta(circ, [200000], seed=12, with_iupac=True)
    # -hp: references with long runs, so that suppression and resizing fire
    hp_ref = os.path.join(d, "small", "hp_ref.fa")
    fixtures.make_reference_fasta(hp_ref, [100000] * 4, seed=14, hp_bias=0.6)
    hp_circ = os.path.join(d, "small", "hp_circ.fa")
    fixtures.make_reference_fasta(hp_circ, [200000], seed=15, hp_bias=0.6)
    for label, r, dna, recon, k in (
            ("linear", ref, "linear", None, None),
            ("circular", circ, "circular", None, None),
            ("linear NANOSIM_TPU_RECON=0", ref, "linear", "0", None),
            ("-hp linear", hp_ref, "linear", None, HP_K),
            ("-hp circular", hp_circ, "circular", None, HP_K),
            ("-hp linear NANOSIM_TPU_RECON=0", hp_ref, "linear", "0", HP_K)):
        outs = {}
        with recon_env(recon):
            for dev in ("cpu", "cuda"):
                out = os.path.join(d, "small", f"{dna}{recon or ''}{'_hp' if k else ''}_{dev}")
                _run_sim(r, prefix, out, 400, 64, True, dev, dna_type=dna, kmer_bias=k)
                outs[dev] = [sha(out + s) for s in FILES]
        if outs["cpu"] != outs["cuda"]:
            fail(f"small {label} run: CUDA output differs from the CPU output: {outs}")
        print(f"small {label} run: CUDA files byte-identical to the CPU path", flush=True)


def read_names(path: str) -> list:
    """The record names of a FASTQ file (its format checked on the way)."""
    names = []
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 0:
                if not line.startswith(b"@"):
                    fail(f"{path}: malformed FASTQ at line {i + 1}")
                names.append(line[1:].rstrip(b"\n").decode())
    return names


def crossing_reads(names, genome_len: int) -> list:
    """Aligned reads whose reference span passes the origin of a circular
    chromosome (`<chrom>_<pos>_aligned_<idx>_<F|R>_<head>_<middle>_<tail>`)."""
    out = []
    for nm in names:
        pos = int(nm.split("_aligned_")[0].rsplit("_", 1)[1])
        if pos + int(nm.split("_")[-2]) > genome_len:
            out.append(nm)
    return out


def check_error_profile(path: str, g, n_records: int = 200, crossing=()):
    """ref_base must equal the genome at pos + Seq_pos (wrapping at the
    origin of a circular chromosome) on the first n_records records and on
    every record of the reads in `crossing`.  Returns the number of checked
    records that wrap the origin."""
    import mmap

    idx = g.name_index()
    wraps = 0

    def check(line: str):
        nonlocal wraps
        name, seq_pos, etype, elen, ref_base, _ = line.rstrip("\n").split("\t")
        if etype == "ins":
            if ref_base != "-" * int(elen):
                fail(f"insertion with ref bases: {line!r}")
            return
        chrom, pos = name.split("_aligned_")[0].rsplit("_", 1)
        c = idx[chrom]
        ln = int(g.lengths[c])
        start = int(pos) + int(seq_pos)
        if g.slice(c, start % ln, int(elen)).tobytes().decode() != ref_base:
            fail(f"ref_base does not match the genome: {line!r}")
        wraps += start + int(elen) > ln

    checked = 0
    with open(path) as f:
        header = f.readline()
        if not header.startswith("Seq_name"):
            fail("error profile has no header")
        for line in f:
            check(line)
            checked += 1
            if checked >= n_records:
                break
    if checked < n_records:
        fail(f"only {checked} error-profile records")
    # the crossing reads' records, found in one forward pass (records are
    # written per read in read order)
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        at = 0
        for nm in crossing:
            key = b"\n" + nm.encode() + b"\t"
            found = mm.find(key, at)
            if found < 0:  # a read without logged errors
                continue
            at = found + 1
            while mm[at : at + len(key) - 1] == key[1:]:
                end = mm.find(b"\n", at)
                check(mm[at:end].decode())
                at = end + 1
    return wraps


def zero_counters():
    from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda, walk_cuda
    from nanosim_tpu_torch.sim import output

    output.RUN_STATS.reset()
    walk_cuda.aligned_steps.launches = 0
    walk_cuda.aligned_steps.launches_by_budget = {}
    walk_cuda.unaligned_steps.launches = 0
    gather_cuda.gather_codes.launches = 0
    gather_cuda.gather_u8.launches = 0
    gather_cuda.gather_u8.launches_by_width = {}
    assemble_cuda.assemble_rolls.launches = 0


def read_counters() -> dict:
    from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda, walk_cuda
    from nanosim_tpu_torch.sim import output

    return {"aligned": walk_cuda.aligned_steps.launches,
            "aligned_by_budget": dict(walk_cuda.aligned_steps.launches_by_budget),
            "unaligned": walk_cuda.unaligned_steps.launches,
            "gather": gather_cuda.gather_codes.launches,
            "gather_u8": gather_cuda.gather_u8.launches,
            "gather_u8_by_width": dict(gather_cuda.gather_u8.launches_by_width),
            "assemble": assemble_cuda.assemble_rolls.launches,
            "overflow_rescue_lanes": output.RUN_STATS.overflow_rescue_lanes,
            "checksum_fallback_lanes": output.RUN_STATS.checksum_fallback_lanes}


@contextlib.contextmanager
def timed_hp_log(seconds: list):
    """Adds the host seconds spent composing the device-materialized -hp
    route's error log (GenomeBatchWriter._hp_log_bytes) to seconds[0]."""
    from nanosim_tpu_torch.sim.output import GenomeBatchWriter

    inner = GenomeBatchWriter._hp_log_bytes

    def timed(self, *a, **kw):
        t0 = time.time()
        try:
            return inner(self, *a, **kw)
        finally:
            seconds[0] += time.time() - t0

    GenomeBatchWriter._hp_log_bytes = timed
    try:
        yield
    finally:
        GenomeBatchWriter._hp_log_bytes = inner


def phase_path(label: str, d: str, prefix: str, ref: str, n: int, card: str,
               dna_type: str, kernels, kmer_bias=None, traced_rerun: bool = True):
    """Drive one path through `simulate_genome(device="cuda")` with the
    counters zeroed just before and read just after; every kernel in
    `kernels` must have launched, no lane may have needed the checksum
    fallback, the record counts must match, ref_base must match the genome,
    and a traced same-seed rerun must give the same bytes."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome

    out1 = os.path.join(d, label, "run1", "sim")
    os.makedirs(os.path.dirname(out1))
    log_s = [0.0]
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with timed_hp_log(log_s):
        counts = _run_sim(ref, prefix, out1, n, BATCH, True, "cuda", dna_type=dna_type,
                          kmer_bias=kmer_bias)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_counters()
    print(f"{label} path: {counts} in {dt:.2f}s -> {n / dt:.1f} reads/s on {card}; "
          f"launches {launches}", flush=True)
    if log_s[0]:
        print(f"{label} path: composing the error log from the pre-resize middles took "
              f"{log_s[0]:.2f}s of the host's time ({log_s[0] / dt:.3f} of the run)", flush=True)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"{missing} kernels were not launched on the {label} path: {launches}")
    if launches["checksum_fallback_lanes"] != 0:
        fail(f"{launches['checksum_fallback_lanes']} lanes failed the host replay's checksum")
    names = read_names(out1 + "_aligned_reads.fastq")
    nu = len(read_names(out1 + "_unaligned_reads.fastq"))
    if (len(names), nu) != (counts["aligned"], counts["unaligned"]):
        fail(f"read counts {(len(names), nu)} != requested {counts}")
    g = PackedGenome.from_fasta(ref, dna_type=dna_type)
    crossing = crossing_reads(names, g.total_len) if dna_type == "circular" else []
    wraps = check_error_profile(out1 + "_aligned_error_profile", g, crossing=crossing)
    print(f"{label} path: ref_base checked; {len(crossing)} reads cross the origin, "
          f"{wraps} checked records wrap it", flush=True)
    if dna_type == "circular" and wraps == 0:
        fail("no error-profile record wrapping the origin was checked")
    if not traced_rerun:
        return launches, n / dt, None

    # the second run is traced (CUDA activity only) for the device's busy
    # share; its rate includes the tracer's cost
    out2 = os.path.join(d, label, "run2", "sim")
    os.makedirs(os.path.dirname(out2))
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run_sim(ref, prefix, out2, n, BATCH, True, "cuda", dna_type=dna_type,
                 kmer_bias=kmer_bias)
        torch.cuda.synchronize()
    dt2 = time.time() - t0
    for s in FILES:
        if sha(out1 + s) != sha(out2 + s):
            fail(f"{label} path: second run with the same seed differs in {s}")
    print(f"{label} path: second run byte-identical ({n / dt2:.1f} reads/s, traced)",
          flush=True)
    report_trace(prof, dt2)
    return launches, n / dt, n / dt2


def phase_recon0(d: str, prefix: str, ref: str, card: str, n: int = N_RECON0,
                 kmer_bias=None):
    """NANOSIM_TPU_RECON=0 at full width: the read-emitting program's files
    (with kmer_bias: the unfused -hp program's) must equal the host
    reconstruction's for the same seed and size."""
    import torch

    tag = "-hp " if kmer_bias else ""
    kernels = (("gather_u8", "assemble") if kmer_bias else ("gather",)) + ("aligned", "unaligned")
    outs, launches = {}, None
    for recon in ("0", None):
        out = os.path.join(d, f"recon{recon or ''}{'_hp' if kmer_bias else ''}", "sim")
        os.makedirs(os.path.dirname(out))
        zero_counters()
        with recon_env(recon):
            t0 = time.time()
            _run_sim(ref, prefix, out, n, BATCH, True, "cuda", kmer_bias=kmer_bias)
            torch.cuda.synchronize()
            dt = time.time() - t0
        got = read_counters()
        if got["checksum_fallback_lanes"] != 0:
            fail(f"{got['checksum_fallback_lanes']} lanes failed the host replay's checksum")
        if recon == "0":
            launches = got
            if any(got[k] == 0 for k in kernels):
                fail(f"a kernel was not launched with {tag}NANOSIM_TPU_RECON=0: {got}")
        print(f"{tag}NANOSIM_TPU_RECON={recon or 'unset'}: {n} reads in {dt:.2f}s -> "
              f"{n / dt:.1f} reads/s on {card}; launches {got}", flush=True)
        outs[recon] = [sha(out + s) for s in FILES]
    if outs["0"] != outs[None]:
        fail(f"{tag}NANOSIM_TPU_RECON=0 files differ from the host reconstruction's: {outs}")
    print(f"{tag}NANOSIM_TPU_RECON=0: files byte-identical to the host-reconstruction route",
          flush=True)
    return launches


def report_trace(prof, wall_s: float):
    """Device busy time (sum of kernel and copy self times on the one stream
    in use) against the run's wall time, and the top device consumers."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"trace: wall {wall_s:.3f} s, device busy {busy_s:.3f} s "
          f"(idle share {1 - busy_s / wall_s:.3f}), {sum(r[1] for r in rows)} device ops",
          flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / 1e3:10.2f} ms  x{count:<7d} {key[:90]}", flush=True)


def main():
    if not os.path.isdir(os.path.join(REPO, "nanosim_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository "
             "(nanosim_tpu_torch/ is missing)")
    sys.path.insert(0, REPO)
    card, kind, count = phase_card()
    phase_build()
    from nanosim_tpu_torch.profiles import fixtures

    tmp_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        t0 = time.time()
        prefix, ref = make_fixture(os.path.join(d, "bench"), GENOME_MB, 8000, 2200, 2000)
        circ_ref = os.path.join(d, "bench", "circ.fa")
        fixtures.make_reference_fasta(circ_ref, [CIRC_LEN], seed=13, with_iupac=True)
        print(f"fixture ({GENOME_MB} Mb genome, {CIRC_LEN} bp circular chromosome) in "
              f"{time.time() - t0:.1f}s", flush=True)
        cases = (phase_kernels(prefix, ref) + phase_gather(prefix, circ_ref)
                 + phase_hp_kernels(prefix, circ_ref))
        phase_cuda_vs_cpu(d)
        main_l, rate1, rate2 = phase_path("main", d, prefix, ref, N_READS, card, "linear",
                                          ("aligned", "unaligned"))
        circ_l, crate1, crate2 = phase_path("circular", d, prefix, circ_ref, N_CIRC, card,
                                            "circular", ("aligned", "unaligned", "gather"))
        recon0_l = phase_recon0(d, prefix, ref, card)
        hp_l, hrate1, hrate2 = phase_path(
            "-hp", d, prefix, circ_ref, N_HP, card, "circular",
            ("aligned", "unaligned", "gather_u8", "assemble"), kmer_bias=HP_K)
        hpa_l, harate, _ = phase_path(
            "-hp host-reconstruction", d, prefix, ref, N_HP_RECON, card, "linear",
            ("aligned", "unaligned"), kmer_bias=HP_K, traced_rerun=False)
        hp_recon0_l = phase_recon0(d, prefix, ref, card, n=N_HP_RECON0, kmer_bias=HP_K)
    for k in cases:
        if not k["role"]:
            continue
        if k["name"] == "unaligned_walk":
            k["launches"] = main_l["unaligned"]
        elif k["name"] == "aligned_walk":
            k["launches"] = main_l["aligned_by_budget"].get(k["E"], 0)
        elif k["name"] == "gather_codes":  # K3: the circular path, and RECON=0 beside it
            k["launches"] = circ_l["gather"]
            k["launches_recon0"] = recon0_l["gather"]
        elif k["name"].startswith("gather_u8"):  # K4: the -hp path, per element width
            k["launches"] = hp_l["gather_u8_by_width"].get(k["elem_bytes"], 0)
            k["launches_recon0"] = hp_recon0_l["gather_u8_by_width"].get(k["elem_bytes"], 0)
        else:  # K5: the -hp path
            k["launches"] = hp_l["assemble"]
            k["launches_recon0"] = hp_recon0_l["assemble"]
    print(f"main path reads/s: {rate1:.1f}, {rate2:.1f} traced; circular path reads/s: "
          f"{crate1:.1f}, {crate2:.1f} traced; -hp path reads/s: {hrate1:.1f}, {hrate2:.1f} "
          f"traced; -hp on the host-reconstruction route: {harate:.1f} reads/s, "
          f"{hpa_l['overflow_rescue_lanes']} rescue and {hpa_l['checksum_fallback_lanes']} "
          f"checksum-fallback lanes ({card})", flush=True)
    print(json.dumps({"kernel_cases": [k for k in cases if k["role"] != "record"]}))
    print(json.dumps({"kernels": [{key: v for key, v in k.items() if key != "role"}
                                  for k in cases if k["role"] == "record"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
