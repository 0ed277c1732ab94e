#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Phases (any failure exits non-zero, and no result line is printed):

1. the card: `nvidia-smi` name and power limit, torch's device name and count;
2. builds: csrc/walk.cu, csrc/walk_ablate.cu, csrc/gather.cu,
   csrc/assemble.cu, csrc/gather_window.cu and csrc/draw.cu with nvcc (sm_90a, one nvcc per source; the ptxas reports
   are printed, a reported register spill fails the run) and
   the native writer (csrc/recon_emit.cpp, which includes
   native/fastwriter.cpp) with g++, all started together;
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
   version, its bound and (K3, K4, K5) one torch.gather of the same bytes.
   A walk row also gives the kernel's self device time per launch
   (torch.profiler) and the wrapper's host us per call (100 calls, the clock
   read before the synchronisation after them); an aligned row its ns per
   serial step (that time over the longest lane's steps), an unaligned row
   the longest lane's rounds (128 steps: four warps a lane) and ns per
   round; a K3, K4 or K5 row its self device time per launch and
   torch.gather's from torch.profiler, and the host's us per call of each
   (K4 1,000 calls; K3 and K5 100, since at the path's shapes their launches
   outlast the host's calls), all three timed over 100 calls with events; the
   trace of K3's and of K5's calls must show no device op but the kernel's
   (each call one launch).
   The draw kernels (csrc/draw.cu, ops/draw_cuda.py) against ops/rng.py's
   int64 version on the same CUDA tensors, bit for bit: the read-emitting
   program's per-slot quality draws at B=2,048, n=19,456 (uniforms, the two
   16-bit uniforms, the clamped uniform at int32 positions), a ragged
   [37 x 3,001], and the meta-only programs' per-lane draws at B=512 (a
   site fold, a uniform, a float64 uniform); each timed with events beside
   the int64 version and its bound (60 integer operations a hash, or the
   bytes read and written), with its self device time (a trace that shows
   one launch a call and no other op), the host us per call, and the int64
   version's device ops per call.
   The same for the chimeric path's shapes (bench configuration: batch 512,
   segment mean 1.3, s_max 8): the walks on the inputs the first meta-only
   batch's packed lanes give them (K1 at B = k_cap = 1,024, K2 at
   B = kg_cap = 512) and K4 on the segment and gap rows of the first
   read-emitting batch on the circular chromosome ([S*B, l_cap] and
   [(S-1)*B, gap_cap] bytes; 16-bit from the `-hp` batch), with both
   batches' peak device memory.  Then the fixed-step walk experiments (K6
   and K7, both on the warp-per-lane kernel) with the chimeric simulator's
   tables at 1,024 lanes: every variant against its plain version at 256
   steps on 1,024 and on 37 lanes, the exact row-select variants (scan,
   search, global) against each other on both, the whole step at 2,048
   steps (K6's at 8,192 steps cost 12-24 s a run), K6's `full` against K7's
   `search` at 8,192 steps bit for bit,
   the exact row-select variants against each other at 2,048 steps, and
   walk_ablate.measure_step_costs (counters zeroed just before): ms per
   launch, ns per lane-step and per serial step for every variant, and the
   differences that split a step (full - nothreefry, full - nodma,
   full - onlymatch, onlymatch - min, full - min) and set the row selects
   apart (search - scan, global - scan, min - scan), each on a line of
   their own;
4. the CUDA path against the CPU path of the same program at a small size:
   byte-identical FASTQ and error-profile files (the CPU path is held
   byte-identical to the JAX package by the test suite), for linear DNA on
   the host-reconstruction route, circular DNA, and linear DNA with
   NANOSIM_TPU_RECON=0; then the same three with `-hp -k 6` on references
   written with hp_bias, so that suppression and resizing fire; then
   `--chimeric` (segment mean 1.9) linear, circular, NANOSIM_TPU_RECON=0 and
   `-hp -k 6` circular; then `-med/-sd` (lognormal lengths) linear, circular,
   NANOSIM_TPU_RECON=0 and `--perfect`;
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
9. `-hp` on the host-reconstruction route: 10,000 reads on the 48 Mb genome
   (reads/s, fallback and rescue lanes, ref_base), then 2,000 reads with
   NANOSIM_TPU_RECON=0 against the default route: the files must be equal;
10. the chimeric path at full width (`--chimeric`, FASTQ, batch 512): the
   host-reconstruction route on the 48 Mb genome, 6,000 reads, untraced and
   traced, counters zeroed just before and read just after; K1 and K2 must
   have launched, with 0 packed spills (a failed replay checksum ends the
   run), matching record counts, reads of more than one segment present,
   ref_base checked on the one-segment reads' records;
11. the chimeric path's device-materialized route: 2,000 reads on the circular
   chromosome (K1, K2, K4 must have launched); NANOSIM_TPU_RECON=0 at 2,000
   reads on the 48 Mb genome against the default route, files equal;
   `--chimeric -hp -k 6` at 1,000 reads on the circular chromosome with the
   seconds of the Python log;
12. the transcriptome at a small size, CUDA against CPU, byte-identical
   files: cDNA with polyA, direct RNA, intron retention, `-hp -k 6`,
   `--perfect`, and cDNA and intron retention with NANOSIM_TPU_RECON=0;
   intron retention with three structures on the '-' strand, on both
   routes (each route's CUDA files against its own CPU files; a read must
   retain an intron of a '-' strand structure); then
   genome `--perfect` linear, circular, NANOSIM_TPU_RECON=0 and `-hp -k 6`
   circular;
13. the transcriptome kernels' shapes (a synthetic transcriptome of 100,000
   transcripts, mean 1,800 bp, the JAX package's transcriptome bench model,
   batch 512): K1 and K2 on the cDNA path's first batches, K4 on the direct
   RNA unaligned pass's first batch, each against its plain version and
   timed; each batch's peak device memory; the intron-retention batch (2,000
   structured transcripts on one 6 Mb chromosome) and its IR walk's device
   kernels, traced;
14. the transcriptome paths at full width, counters zeroed just before and
   read just after: cDNA (10,000 reads, FASTQ, polyA; untraced and a traced
   byte-identical rerun), direct RNA (10,000 reads; K4 on the raw-byte
   unaligned pass), intron retention (10,000 reads), `-hp -k 6` (1,000
   reads), each with 0 checksum-fallback lanes and ref_base checked on 200
   records; NANOSIM_TPU_RECON=0 at 2,000 reads for cDNA and intron retention,
   files equal to Route A's;
15. the windowed byte gather (K8, bench/gather_variants.py): every instance
   against its plain version at the experiment's shape (B=1,024, L=19,456,
   4,608 packed bytes: TMA bulk copies) and at a ragged one (B=37, L=3,000,
   770 bytes: the threads' copies), then every instance timed beside its
   bound, the plain version and one torch.gather (events, device time,
   host us per call; device times only from a trace of 100 calls showing
   one kernel a call), with the W4 coverage check;
16. the metagenome at a small size, CUDA against CPU, byte-identical files of
   both samples (three species, two samples, batch 64, so that the species
   quota crosses batches): plain reads, `--chimeric` on the
   host-reconstruction route and with NANOSIM_TPU_RECON=0, `--perfect` and
   `-hp -k 6`; and `-med/-sd` on two species;
17. the metagenome path at full width, the JAX package's metagenome
   configuration (bench.py:339-391: three species of two linear 8 Mb
   chromosomes, the bench model with segment mean 1.3, abundances 50/30/20,
   `--chimeric`, batch 512), 10,000 reads, FASTQ, counters zeroed just
   before and read just after: K1 and K2 must have launched, with 0 packed
   spills and 0 checksum-fallback lanes, matching record counts, reads of
   more than one segment, ref_base checked on 200 one-segment records (by
   `<species>-<chrom>`), each species' share of reference bases within 5
   points of the abundance file; a traced same-seed rerun byte-identical
   (idle share, device ops per batch, the host seconds of the species
   assignment); NANOSIM_TPU_RECON=0 at 2,000 reads equal to Route A's files,
   with K4 launched;
18. the -med/-sd path at full width: phase 5's configuration with lognormal
   lengths (`-med 8000 -sd 0.27`, the bench model's spread), counters zeroed
   just before and read just after: K1 and K2 must have launched, with 0
   checksum-fallback lanes, matching record counts, ref_base checked, and a
   traced same-seed rerun byte-identical (idle share);
19. multi-host runs: two ranks as two processes on the one card, through the
   port's CLI (`--num_hosts 2 --host_id h --coordinator 127.0.0.1:<port>`,
   gloo): genome at the main path's model (4,000 reads, batch 2,048) and the
   chimeric metagenome of phase 17 (2,000 reads, batch 512). Every rank must
   exit 0 within its time limit and launch K1 and K2 with 0
   checksum-fallback lanes; the ranks' shards together must equal a
   one-rank run of the same seed and batch (records by read index,
   error-profile rows grouped by read); rank 0 emulated in this process
   must write the distributed rank 0's shards, and every walk shape it
   launches (K1 and K2 on a rank's 1,024 or 256 slots, packed for the
   chimeric metagenome, and K2 in host 0's unaligned pass) is held against
   its plain version, carrying the ranks' launches at that shape; at a small
   size the emulated ranks' shards on the card must equal the CPU's. The
   two-rank and one-rank reads/s are printed (two ranks share one card: no
   scaling number).
20. (run after phase 14, on its fixture) the transcriptome's exact 2D-KDE
   conditional: its small cDNA run's CUDA files equal the CPU's (phase 12);
   then the cDNA aligned pass at phase 13's configuration, 4,000 reads,
   counters zeroed just before and read just after: K1 launched at the
   transcriptome path's shape only (its row carries these launches as
   `launches_exact_conditional`), 0 checksum-fallback lanes, record count,
   ref_base; reads/s, peak device
   memory, a traced byte-identical rerun (device ops per batch), and the
   default draw's aligned pass timed beside it;
21. the model-fitting commands, each through the port's CLI as a process of
   its own: 2,000 reads (and 200 unaligned) simulated on the card with the
   main path's model, their alignment SAM built from the simulator's own
   error log (profiles.fixtures.build_sam_from_ground_truth), `characterize
   genome --fastq -ga`: exit 0, every model file written, its seconds
   printed, its three error rates within 5% of the reads' own; `simulate
   genome -c <refit>` of 2,000 reads on the card: K1 and K2 launched, 0
   checksum-fallback lanes, ref_base checked.  Then at a small size:
   `characterize transcriptome` (intron retention, `-q`) on a synthetic
   annotated transcriptome with spliced alignments, `characterize
   metagenome -c -q` on two species, `quantify -e trans` and `-e meta`,
   `detect_ir` and `quantify_paf`: each exits 0, and each refit loads with
   the port's load_profile for its mode (no sklearn or joblib on the card's
   machine).

The line before the last is the kernels' JSON record: every kernel at every
shape a path gives it, with that path's launches (`path`: main, circular,
-hp, chimeric, chimeric circular, chimeric -hp, transcriptome, direct RNA,
and `experiments` for the whole-step variants of K6 and K7 and the
instances of K8); the metagenome path gives K1 and K2 the chimeric path's
shapes and K4 (under NANOSIM_TPU_RECON=0) the chimeric circular path's, so
those rows also carry `launches_metagenome` and `launches_metagenome_recon0`,
and the -med/-sd path gives K1 and K2 the main path's, so those carry
`launches_lognormal`; the multi-host rows (`path` multi-host genome and
multi-host metagenome --chimeric) carry the ranks' launches at their own
shape (`launches`, their sum, and `launches_by_rank`);
the line before it holds the other shapes and the other experiment
variants.  The last line is {"ok": true, "device": {...}}.  `--quick` runs
only the builds and phase 21's small commands (a short check while working
on the newest slice); `--kernels` only the builds and the kernels at every path's shapes
(phases 3 and 13, without the walk experiments), driving no path;
`--experiments` only the builds and the measuring kernels (the walk
experiments of phase 3, and phase 15).
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
N_HP_RECON = 10000  # -hp on the host-reconstruction route (48 Mb genome)
N_HP_RECON0 = 2000  # -hp, NANOSIM_TPU_RECON=0 against the default route
# the chimeric path: the JAX package's bench.py chimeric configuration
# (bench.py:125-171: segment mean 1.3, a quarter of the batch, s_max 8)
CHI_BATCH = BATCH // 4
CHI_SEGMENT_MEAN = 1.3
N_CHI = 6000  # Route A (host reconstruction, packed walks), 48 Mb genome
N_CHI_CIRC = 2000  # Route B (device-materialized), the circular chromosome
N_CHI_RECON0 = 2000  # NANOSIM_TPU_RECON=0 against Route A
N_CHI_HP = 1000  # --chimeric -hp -k 6 on Route B (Python log per event)
# the -med/-sd path: lognormal lengths about a median of 8,000 with the bench
# model's spread (sd 2,200 of 8,000: sigma 0.27 of the log)
LN_MEDIAN, LN_SD = 8000, 0.27
ABLATION_CHECK_STEPS = 256  # every experiment variant against its plain version
TIMED_LAUNCHES = 10
# the element gather (K4) at the transcriptome shapes takes a few us a call,
# less than its launch path's host time: its CUDA-event times are taken over
# more calls, so that one late call on a shared host does not set them
GATHER_TIMED_LAUNCHES = 100
# calls of a walk wrapper for its host time: each is two launches (the
# zero-filled events, the kernel), and at the main shape the device takes
# longer than the host, so they stay well inside the launch queue
WALK_HOST_CALLS = 100
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
    from nanosim_tpu_torch.ops import (assemble_cuda, cuda_build, draw_cuda, gather_cuda,
                                       gather_window, walk_ablate, walk_cuda)

    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below; the phase fails
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (walk_cuda.LIBRARY.load, walk_ablate.LIBRARY.load,
                          gather_cuda.LIBRARY.load, assemble_cuda.LIBRARY.load,
                          gather_window.LIBRARY.load, draw_cuda.LIBRARY.load, native.get_lib)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build: {errors[0]}")
    if native.get_lib() is None:
        fail("the native writer (csrc/recon_emit.cpp, native/fastwriter.cpp) did not build")
    print(f"builds done in {time.time() - t0:.1f}s", flush=True)
    for lib in (walk_cuda.LIBRARY, walk_ablate.LIBRARY, gather_cuda.LIBRARY,
                assemble_cuda.LIBRARY, gather_window.LIBRARY, draw_cuda.LIBRARY):
        print(f"nvcc -Xptxas -v ({os.path.basename(lib.src)}):\n"
              + (lib.build_log.strip() or "(library was already built)"), flush=True)
        spills = [ln for ln in lib.build_log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if spills:
            fail(f"{os.path.basename(lib.src)}: ptxas reports register spills: {spills[0]}")
    # the code the compiler made for each instance of the experiments' kernels
    # (template arguments in the mangled name: threefry, error tables, match
    # mode 0 none / 1 scan / 2 search / 3 global, store; the warp kernel's GL, GM)
    for name, ops in sorted(cuda_build.sass_summary(walk_ablate.LIBRARY.path).items()):
        tag = name[name.find("fixed_walk"):][:52]
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:9])
        print(f"sass {tag}: {top}", flush=True)
    # the draw kernels' instances: the rotations should be funnel shifts (SHF)
    for name, ops in sorted(cuda_build.sass_summary(draw_cuda.LIBRARY.path).items()):
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:9])
        print(f"sass {name[:72]}: {top}", flush=True)


def make_fixture(d: str, genome_mb: float, mean_len: float, sd_len: float, n_kde: int):
    from nanosim_tpu_torch.profiles import fixtures

    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=mean_len, sd_read_len=sd_len,
                            n_kde_points=n_kde)
    ref = os.path.join(d, "ref.fa")
    per = int(genome_mb * 1e6 / 4)
    fixtures.make_reference_fasta(ref, [per] * 4, seed=11)
    return prefix, ref


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
    from nanosim_tpu_torch.ops import error_walk, rng
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
        else:
            args = (uwk[:B], um[:B], t.mixtures, E)
        results.append(_walk_case(kind, args, role, "main" if role else ""))
    return results


def _once_ms(fn):
    """(fn(), the ms of that one call on the card by CUDA events): a plain
    walk's call takes seconds, so the call that gives the values the kernel
    is held against is also the one timed."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _walk_case(kind: str, args, role: str, path: str):
    """One walk kernel (`kind` aligned or unaligned) on `args` against its
    plain version, timed beside its bound: the row of the kernels' record."""
    from nanosim_tpu_torch.ops import walk_cuda
    from nanosim_tpu_torch.ops.cuda_build import time_ms

    if kind == "aligned":
        name, kern, plain = "aligned_walk", walk_cuda.aligned_steps, walk_cuda.aligned_steps_plain
        mm, mixtures = args[3], args[4]
        source_line = "nanosim_tpu/ops/walk_pallas.py:464"
    else:
        name, kern = "unaligned_walk", walk_cuda.unaligned_steps
        plain = walk_cuda.unaligned_steps_plain
        mm, mixtures = None, args[2]
        source_line = "nanosim_tpu/ops/walk_pallas.py:554"
    B, E = args[1].shape[0], args[-1]
    n_t = mixtures.cdf_t.shape[1]
    if kind == "aligned":
        nb, K = mm.breaks.shape
        in_bytes = B * (8 + 4 + 4) + 4 * (3 * n_t + 2 * nb * K + 2 * nb + 21)
    else:
        in_bytes = B * (8 + 4) + 4 * 3 * n_t
    got = kern(*args)
    want, plain_ms = _once_ms(lambda: plain(*args))
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
    ms = time_ms(lambda: kern(*args), TIMED_LAUNCHES)
    # the kernel's own device time (the event time above also holds the
    # wrapper's host work and the zero-filled output, which a short launch
    # does not hide), and the wrapper's host time per call
    kernel_name = f"{kind}_walk_kernel"
    device_ms, _ = _profiled_device_ms(
        lambda: kern(*args), TIMED_LAUNCHES,
        lambda key: kernel_name in key and (kind == "unaligned" or "unaligned" not in key))
    host_us = _host_us_per_call(lambda: kern(*args), WALK_HOST_CALLS)
    # the launch takes at least the longest lane's chain: of steps (aligned),
    # of rounds of 128 steps (unaligned: four warps a lane, a step a thread)
    longest = int(got[4].max()) if B else 0
    lanes = walk_cuda.LANES_PER_BLOCK[kind]
    if kind == "aligned":
        ns_per_step = device_ms * 1e6 / longest if device_ms and longest else None
        row = {"ns_per_serial_step": ns_per_step}
        chain_txt = f"{_fmt_ns(ns_per_step)} per serial step"
    else:
        rounds = -(-longest // walk_cuda.UNALIGNED_ROUND_STEPS)
        ns_per_round = device_ms * 1e6 / rounds if device_ms and rounds else None
        row = {"rounds": rounds, "ns_per_round": ns_per_round}
        chain_txt = f"{rounds} rounds, {_fmt_ns(ns_per_round)} per round"
    blocks = -(-B // lanes)
    print(f"kernel {name}: B={B} E={E} ({blocks} blocks of {lanes} lanes) steps={steps} "
          f"longest lane {longest} exact; {ms:.4f} ms, device {_fmt_ms(device_ms)} "
          f"(profiler), host {host_us:.1f} us per call; {chain_txt} (plain {plain_ms:.1f} ms, "
          f"bound {bound:.4f} ms by {bound_by}, {ms / bound:.1f}x the bound)", flush=True)
    return {
        "name": name, "route": "cuda", "source": "nanosim_tpu_torch/csrc/walk.cu",
        "replaces": source_line, "B": B, "E": E, "blocks": blocks, "lanes_per_block": lanes,
        "steps": steps, "longest_lane_steps": longest, "device_ms": device_ms,
        "host_us_per_call": host_us, **row,
        "max_abs_err": float(max_err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "role": role,
        "path": path,
    }


def _capture_batch(fn, patches):
    """Run `fn()` with module attributes patched ((module, name, value)
    triples), restoring them after; returns (result, peak device bytes)."""
    import torch

    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, v in patches:
        setattr(m, n, v)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated()
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


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


# integer operations a Threefry-2x32 hash takes at the least: its 20 rounds'
# add, rotate and xor (the walks' bounds count 72, the 5 key injections too;
# the draw kernel runs faster than that, nvcc folding the injections' adds
# into three-input adds and issuing adds as IMAD on the float pipe)
THREEFRY_INT_OPS = 60


def _draw_case(label: str, fn, hashes: int, n_bytes: int):
    """One draw against ops/rng.py's int64 version on the same CUDA tensors
    (the routing switched inside the call), bit for bit, then timed: CUDA
    events over GATHER_TIMED_LAUNCHES calls of each, the kernel's self
    device time from a trace that must show one launch a call and no other
    op, the host's us per call, and the int64 version's device ops a call."""
    import torch

    from nanosim_tpu_torch.ops import draw_cuda, rng
    from nanosim_tpu_torch.ops.cuda_build import time_ms

    def plain():
        on_card = rng._on_card
        rng._on_card = lambda t: False
        try:
            return fn()
        finally:
            rng._on_card = on_card

    got, want = fn(), plain()
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label}: kernel output {tuple(g.shape)} {g.dtype} != int64 version's "
                 f"{tuple(w.shape)} {w.dtype}")
        if g.dtype in (torch.float32, torch.float64):
            g, w = (t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
                    for t in (g, w))
        if not torch.equal(g, w):
            fail(f"{label}: the draw kernel differs from the int64 version")
    del got, want
    before = draw_cuda.launches
    fn()
    if draw_cuda.launches != before + 1:
        fail(f"{label}: {draw_cuda.launches - before} draw launches in one call")
    bound, bound_by = _bound_ms(n_bytes, THREEFRY_INT_OPS * hashes, 0)
    others = {}
    times = {"ms": time_ms(fn, GATHER_TIMED_LAUNCHES), "plain_ms": time_ms(plain, 10)}
    times["device_ms"], seen = _profiled_device_ms(
        fn, GATHER_TIMED_LAUNCHES, lambda key: "draw_kernel" in key or "fold_kernel" in key,
        others, exact=True)
    if others or seen > GATHER_TIMED_LAUNCHES:
        fail(f"{label}: {seen} draw launches and other device ops {others} in "
             f"{GATHER_TIMED_LAUNCHES} calls")
    times["host_us_per_call"] = _host_us_per_call(fn, GATHER_TIMED_LAUNCHES)
    _, plain_ops = _profiled_device_ms(plain, 1)
    times["plain_device_ops_per_call"] = plain_ops
    print(f"kernel {label}: exact; {times['ms']:.4f} ms (int64 version {times['plain_ms']:.4f} "
          f"ms in {plain_ops} device ops; bound {bound:.4f} ms by {bound_by}, "
          f"{times['ms'] / bound:.1f}x the bound); device {_fmt_ms(times['device_ms'])} "
          f"(profiler); host {times['host_us_per_call']:.2f} us per call", flush=True)
    return {"name": label.split(" ")[0], "route": "cuda",
            "source": "nanosim_tpu_torch/csrc/draw.cu", "replaces": "none (ops/rng.py int64 ops)",
            "label": label, "hashes": hashes, **times, "bound_ms": bound, "bound_by": bound_by,
            "role": "", "path": ""}


def phase_draw_kernels():
    """The draw kernels against ops/rng.py's int64 version at the batch
    programs' shapes: the read-emitting program's [2,048 x 19,456] draws,
    a ragged [37 x 3,001], and the meta-only programs' [512]-lane draws."""
    import torch

    from nanosim_tpu_torch.ops import rng

    dev = torch.device("cuda")
    base = rng.base_key(2**63 + SEED, rng.STREAM_ALIGNED, device=dev)
    rows = []
    for B, n in ((2048, 19456), (37, 3001)):
        slots = torch.arange(2**32 - B // 2, 2**32 - B // 2 + B, dtype=torch.int64, device=dev)
        sk = rng.slot_keys(base, slots)
        pos = (torch.arange(n, device=dev, dtype=torch.int32)[None, :]
               + torch.arange(B, device=dev, dtype=torch.int32)[:, None] % 97 - 40)
        draws = B * n
        rows.append(_draw_case(f"uniform_per_slot B={B} n={n}",
                               lambda: rng.uniform_per_slot(sk, rng.SITE_QUAL, (n,)),
                               draws + B, 16 * B + 4 * draws))
        rows.append(_draw_case(f"uniform2_per_slot B={B} n={n}",
                               lambda: rng.uniform2_per_slot(sk, rng.SITE_MIS_BASE, (n,)),
                               draws + B, 16 * B + 8 * draws))
        rows.append(_draw_case(f"uniform_at B={B} n={n}",
                               lambda: rng.uniform_at(sk, rng.SITE_HEAD_TAIL, pos, n - 8),
                               draws + B, 16 * B + 8 * draws))
        del sk, pos
        torch.cuda.empty_cache()
    B = CHI_BATCH
    sk = rng.slot_keys(base, torch.arange(B, dtype=torch.int64, device=dev))
    rows.append(_draw_case(f"fold_in B={B}", lambda: rng.site_keys(sk, rng.SITE_POSITION),
                           B, 32 * B))
    rows.append(_draw_case(f"uniform_per_slot B={B} n=1",
                           lambda: rng.uniform_per_slot(sk, rng.SITE_STRAND), 2 * B, 20 * B))
    rows.append(_draw_case(f"uniform_f64 B={B} n=1", lambda: rng.uniform_f64(sk), B, 24 * B))
    return rows


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
    _capture_batch(
        lambda: sim.batch_fn()(rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev),
                               torch.arange(BATCH, dtype=torch.int64, device=dev)),
        [(apply_errors, "gather_cuda", types.SimpleNamespace(gather_codes=capture))])
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
        del got
        # each index read once (4 B), each packed row once, each code written once
        bound, bound_by = _bound_ms(4 * B * L + B * PB + B * L, 0, 0)
        # the library yardstick: one torch.gather of the packed bytes (its
        # int64 index is made outside the timed call)
        idx = (src >> 2).clamp(0, PB - 1).long()
        label = f"gather_codes B={B} L={L}"
        times = _kernel_times(label, lambda: gather_cuda.gather_codes(packed, src),
                              lambda: gather_cuda.gather_codes_plain(packed, src),
                              lambda: torch.gather(packed, 1, idx), "gather_codes",
                              GATHER_TIMED_LAUNCHES, one_kernel=True)
        del idx, want
        results.append({
            "name": "gather_codes", "route": "cuda", "source": "nanosim_tpu_torch/csrc/gather.cu",
            "replaces": "nanosim_tpu/ops/window_gather.py:115", "B": B, "L": L, "PB": PB,
            "max_abs_err": float(max_err), **times, "bound_ms": bound, "bound_by": bound_by,
            "role": role, "path": "circular" if role else "",
        })
        print(f"kernel gather_codes: B={B} L={L} PB={PB} exact; "
              f"{_times_text(times, bound, bound_by)}", flush=True)
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


def _gather_u8_case(parts, idx, role: str, path: str):
    """K4 (1-byte or 2-byte elements) on (parts, idx) against its plain
    version, timed beside its bound and one torch.gather of the same bytes."""
    import torch

    from nanosim_tpu_torch.ops import gather_cuda

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
    del got, want
    # each index read once (4 B), one element read and one written per position
    bound, bound_by = _bound_ms(B * L * (4 + 2 * es), 0, 0)
    # the library yardstick: torch.gather with its int64 index made outside
    idx64 = idx.long()
    times = _kernel_times(f"{name} B={B} L={L}", lambda: gather_cuda.gather_u8(parts, idx),
                          lambda: gather_cuda.gather_u8_plain(parts, idx),
                          lambda: torch.gather(parts, 1, idx64), "gather_rows_kernel", 1000)
    del idx64
    print(f"kernel {name}: B={B} L={L} W={W} exact; {_times_text(times, bound, bound_by)}",
          flush=True)
    return {
        "name": name, "route": "cuda", "source": "nanosim_tpu_torch/csrc/gather.cu",
        "replaces": "nanosim_tpu/ops/pallas_gather.py:79", "B": B, "L": L, "W": W,
        "elem_bytes": es, "max_abs_err": float(max_err), **times,
        "bound_ms": bound, "bound_by": bound_by, "role": role, "path": path,
    }


def _kernel_times(label: str, kern, plain, lib, match: str, host_calls: int,
                  one_kernel: bool = False) -> dict:
    """A gather-like kernel's figures on its inputs: CUDA-event ms per call
    of the wrapper, of its plain version and of the library call
    (GATHER_TIMED_LAUNCHES calls each, after a warm-up); the kernel's and
    the library call's self device time per launch (torch.profiler; the
    kernel's names contain `match`); and the host's us per call of the
    wrapper and of the library call (`host_calls` calls, the clock read
    before the synchronisation).  With one_kernel, the trace's counts go
    into the figures (`trace_calls`, the kernel launches it saw in
    `trace_kernel_launches`, every other device op in `trace_other_ops`),
    a device time counts only from a trace that shows exactly one launch a
    call (else it is "not measured"), and the case fails if a trace shows
    any other op or more launches than calls."""
    from nanosim_tpu_torch.ops.cuda_build import time_ms

    times = {"ms": time_ms(kern, GATHER_TIMED_LAUNCHES),
             "plain_ms": time_ms(plain, GATHER_TIMED_LAUNCHES),
             "library_ms": time_ms(lib, GATHER_TIMED_LAUNCHES)}
    others = {}
    times["device_ms"], seen = _profiled_device_ms(kern, GATHER_TIMED_LAUNCHES,
                                                   lambda key: match in key, others, one_kernel)
    times["library_device_ms"], lib_seen = _profiled_device_ms(lib, GATHER_TIMED_LAUNCHES,
                                                               exact=one_kernel)
    times["host_us_per_call"] = _host_us_per_call(kern, host_calls)
    times["library_host_us_per_call"] = _host_us_per_call(lib, host_calls)
    if seen != GATHER_TIMED_LAUNCHES or lib_seen != GATHER_TIMED_LAUNCHES:
        log(f"{label}: the trace shows {seen} kernel launches of "
            f"{GATHER_TIMED_LAUNCHES} (the library call: {lib_seen})")
    if one_kernel:
        times.update(trace_calls=GATHER_TIMED_LAUNCHES, trace_kernel_launches=seen,
                     trace_other_ops=sum(others.values()))
        if others:
            fail(f"{label}: the wrapper ran device ops besides its kernel: {others}")
        if seen > GATHER_TIMED_LAUNCHES:
            fail(f"{label}: {seen} kernel launches in {GATHER_TIMED_LAUNCHES} calls")
    return times


def _times_text(t: dict, bound: float, bound_by: str) -> str:
    return (f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, torch.gather "
            f"{t['library_ms']:.4f} ms, bound {bound:.4f} ms by {bound_by}, "
            f"{t['ms'] / bound:.1f}x the bound); device {_fmt_ms(t['device_ms'])} against "
            f"torch.gather's {_fmt_ms(t['library_device_ms'])} (profiler); host "
            f"{t['host_us_per_call']:.2f} us per call against torch.gather's "
            f"{t['library_host_us_per_call']:.2f} us")


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _fmt_ns(ns):
    return "not measured" if ns is None else f"{ns:.1f} ns"


PROFILE_TRIES = 3  # traces taken before a device time is "not measured"
TRACE_PAD_S = 0.02  # idle host time at each end of a trace window


def _profiled_device_ms(fn, n: int, match=None, others=None, exact: bool = False):
    """Self device time per launch of the kernels whose name `match`
    accepts (every device kernel when it is None) over n calls of fn, from
    torch.profiler: (ms per launch or None, launches seen).  `others`, a
    dict, gets the count of every other device op the trace shows, by name.
    The tracer keeps only the device records that fall inside its window,
    whose ends it takes from the host's clock: the window is padded with
    idle time at both ends.  Without `exact`, the mean is over the launches
    seen, and a trace that shows none is taken again, up to PROFILE_TRIES
    times.  With `exact`, a trace counts only when it shows exactly n
    launches (one a call); after PROFILE_TRIES traces that do not, the time
    is None ("not measured") and the launches seen are the last trace's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    count = 0
    for _ in range(PROFILE_TRIES):
        if others is not None:
            others.clear()  # the counts of the trace that is returned
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0 and (match is None or match(e.key)):
                total_us += us
                count += e.count
            elif us > 0 and others is not None:
                others[e.key] = others.get(e.key, 0) + e.count
        if count and (count == n or not exact):
            return total_us / 1e3 / count, count
    return None, count


def _host_us_per_call(fn, n: int = 1000) -> float:
    """Host clock over n calls of fn with no synchronisation inside the
    loop, read before the one after it: us per call.  Where the device takes
    longer than the host, n must stay below the launch queue's depth (about
    a thousand launches), or the host waits for the device inside the loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


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
    gather_ns = types.SimpleNamespace(gather_u8=cap_gather)
    out, peak = _capture_batch(
        lambda: sim.batch_fn()(rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev),
                               torch.arange(BATCH, dtype=torch.int64, device=dev)),
        [(apply_errors, "gather_cuda", gather_ns), (homopolymer, "gather_cuda", gather_ns),
         (genome_mode, "assemble_cuda", types.SimpleNamespace(assemble_rolls=cap_assemble))])
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
        results.append(_gather_u8_case(parts, idx, role, "-hp" if role else ""))
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
        del got
        # what this run's data needs: one 16-bit element read per position
        # below the lane's total, every output position written once, 13
        # bytes of per-lane scalars
        n_read = int(total.clamp(0, l_out).long().sum())
        bound, bound_by = _bound_ms(2 * n_read + 2 * B * l_out + 13 * B, 0, 0)
        # the library yardstick: the one torch.gather of the one-gather
        # formulation, its concatenated input and int64 index made outside
        parts = torch.cat([mid, ht], dim=1)
        idx64 = torch.arange(l_out, device=dev)[None, :].expand(B, l_out).clamp_max(
            parts.shape[1] - 1).contiguous()
        label = f"assemble_rolls B={B} l_out={l_out}"
        times = _kernel_times(label, lambda: assemble_cuda.assemble_rolls(*args),
                              lambda: assemble_cuda.assemble_rolls_plain(*args),
                              lambda: torch.gather(parts, 1, idx64), "assemble_kernel",
                              GATHER_TIMED_LAUNCHES, one_kernel=True)
        del parts, idx64, want
        results.append({
            "name": "assemble_rolls", "route": "cuda",
            "source": "nanosim_tpu_torch/csrc/assemble.cu",
            "replaces": "nanosim_tpu/ops/pallas_assemble.py:93", "B": B, "l_cap": l_cap,
            "ht_cap": ht_cap, "l_out": l_out, "positions_read": n_read,
            "max_abs_err": float(max_err), **times, "bound_ms": bound, "bound_by": bound_by,
            "role": role, "path": "-hp" if role else "",
        })
        print(f"kernel assemble_rolls: B={B} l_cap={l_cap} ht_cap={ht_cap} l_out={l_out} "
              f"({n_read} positions below total, {int(is_rev.sum())} reversed lanes) exact; "
              f"{_times_text(times, bound, bound_by)}", flush=True)
    return results


def phase_chimeric_kernels(prefix: str, ref: str, circ_ref: str):
    """K1, K2 and K4 at the chimeric path's shapes, each against its plain
    version and timed as at the other shapes.  The walks on the inputs the
    first meta-only batch (packed walk lanes) gives them: K1 at B = k_cap,
    E = e_max, K2 at B = kg_cap, E = gap_steps.  K4 on the inputs the first
    read-emitting batch on the circular chromosome gives it (segment rows
    [S*B, l_cap] and gap rows [(S-1)*B, gap_cap], bytes) and, from the
    `-hp -k 6` batch, the 16-bit resize gather; both batches' peak device
    memory is printed."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import apply_errors, error_walk, gather_cuda, homopolymer, rng
    from nanosim_tpu_torch.ops import walk_cuda
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.chimeric_mode import ChimericGenomeSimulator

    dev = torch.device("cuda")
    base = rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev)
    slots = torch.arange(CHI_BATCH, dtype=torch.int64, device=dev)
    prof = profile.load_profile(prefix, mode="genome", fastq=True, chimeric=True)
    sim = ChimericGenomeSimulator(PackedGenome.from_fasta(ref), prof, fastq=True,
                                  batch=CHI_BATCH, device=dev)
    print(f"chimeric plan: batch={CHI_BATCH} s_max={sim.s_max} segment_mean="
          f"{prof.segment_mean} l_cap={sim.l_cap} l_out={sim.l_out} ht_cap={sim.ht_cap} "
          f"e_max={sim.e_max} gap_cap={sim.gap_cap} gap_steps={sim.gap_steps}", flush=True)
    walks = {}
    proxy = types.SimpleNamespace(**{k: getattr(walk_cuda, k) for k in dir(walk_cuda)
                                     if not k.startswith("__")})

    def cap_aligned(*args):
        walks["aligned"] = args
        return walk_cuda.aligned_steps(*args)

    def cap_unaligned(*args):
        walks["unaligned"] = args
        return walk_cuda.unaligned_steps(*args)

    proxy.aligned_steps, proxy.unaligned_steps = cap_aligned, cap_unaligned
    out, peak = _capture_batch(lambda: sim.batch_fn(emit_reads=False)(base, slots),
                               [(error_walk, "walk_cuda", proxy)])
    if sorted(walks) != ["aligned", "unaligned"]:
        fail(f"the meta-only chimeric batch reached the walks {sorted(walks)}")
    n_seg = out.n_seg.long()
    print(f"chimeric meta-only batch: K1 on {walks['aligned'][1].shape[0]} packed lanes "
          f"({int(n_seg.sum())} active pairs), K2 on {walks['unaligned'][1].shape[0]} "
          f"({int((n_seg - 1).sum())} active gaps); {int(out.valid.sum())} valid reads, "
          f"{int((n_seg > 1).sum())} of {CHI_BATCH} with more than one segment, spill "
          f"{bool(out.packed_spill)}; peak device memory {peak / 1e9:.3f} GB", flush=True)
    if bool(out.packed_spill):
        fail("the first chimeric batch spilled its packed walk lanes")
    results = [_walk_case("aligned", walks["aligned"], "record", "chimeric"),
               _walk_case("unaligned", walks["unaligned"], "record", "chimeric")]
    del out, walks

    cgenome = PackedGenome.from_fasta(circ_ref, dna_type="circular")
    for k, path in ((None, "chimeric circular"), (HP_K, "chimeric -hp")):
        cprof = profile.load_profile(prefix, mode="genome", fastq=True, chimeric=True,
                                     homopolymer=k is not None)
        csim = ChimericGenomeSimulator(cgenome, cprof, fastq=True, circular_dna=True,
                                       batch=CHI_BATCH, kmer_bias=k, device=dev)
        rows = []

        def cap_gather(parts, idx):
            rows.append((parts, idx))
            return gather_cuda.gather_u8(parts, idx)

        ns = types.SimpleNamespace(gather_u8=cap_gather)
        out, peak = _capture_batch(lambda: csim.batch_fn()(base, slots),
                                   [(apply_errors, "gather_cuda", ns),
                                    (homopolymer, "gather_cuda", ns)])
        shapes = [(tuple(i.shape), p_.element_size()) for p_, i in rows]
        want = [((csim.s_max - 1) * CHI_BATCH, csim.gap_cap), (csim.s_max * CHI_BATCH, csim.l_cap)]
        if [sh for sh, _ in shapes[:2]] != want or [es for _, es in shapes] != (
                [1, 1] if k is None else [1, 1, 2]):
            fail(f"the {path} batch called the element gather at {shapes}")
        print(f"{path} batch (B={CHI_BATCH}, S*B={csim.s_max * CHI_BATCH} segment lanes): "
              f"peak device memory {peak / 1e9:.3f} GB; {int(out.valid.sum())} valid reads",
              flush=True)
        del out
        # the plain batch gives the byte rows (gaps, then segments), the -hp
        # batch the 16-bit rows; its byte rows have the same shapes
        for parts, idx in (rows if k is None else rows[2:]):
            results.append(_gather_u8_case(parts, idx, "record", path))
        del rows
        torch.cuda.empty_cache()
    return results


def _experiment_bound(switches, n_t: int, nb: int, K: int, B: int, E: int, table_bytes: int):
    """Bound of one fixed-step walk launch: the aligned step's operations
    (_aligned_ops_per_step) times E*B, less what the variant switches off."""
    threefry, err_tables, match, store = switches
    ints, f32 = _aligned_ops_per_step(n_t, nb, K)
    if not threefry:  # four hashes, three uniforms from bits
        ints -= 4 * THREEFRY_INT_OPS + 3 * 2
        f32 -= 3
    if not err_tables:  # one compare instead of the transition and mixture rows
        f32 -= 3 + _lookup(n_t) - 1
    if match == "none":  # a multiply and a convert instead of bin and break row
        ints -= _lookup(nb)
        f32 -= _lookup(K) - 2
    n_bytes = 8 * B + table_bytes + (4 * E * B if store else 0) + 8 * B
    return _bound_ms(n_bytes, ints * E * B, f32 * E * B)


RAGGED_LANES = 37  # not a multiple of the warp-per-lane kernel's 8 lanes a block


def phase_experiments(prefix: str, ref: str, card: str):
    """K6 and K7, the fixed-step walk experiments, both on the warp-per-lane
    kernel, with the tables of the chimeric simulator at batch 1,024 as the
    JAX package's scripts take them.  Every variant against its plain version
    at 256 steps on 1,024 and on 37 lanes; the exact row-select variants
    (scan, search, global) against each other on both; the whole step
    (`full`, and `scan` of the row-select experiment) at 2,048 steps, where
    the plain version is timed (the row's `plain_steps`); K6's `full`
    against K7's `search` (the same function through other match code) at
    8,192 steps, bit for bit; the exact row-select variants against each
    other at 2,048.  Then, with the counters zeroed,
    walk_ablate.measure_step_costs: ms per launch, ns per lane-step and per
    serial step for every variant, and the differences that split a step and
    set the row selects apart."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import walk_ablate
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim.chimeric_mode import ChimericGenomeSimulator

    dev = torch.device("cuda")
    prof = profile.load_profile(prefix, mode="genome", chimeric=True)
    sim = ChimericGenomeSimulator(PackedGenome.from_fasta(ref), prof, batch=walk_ablate.N_LANES,
                                  device=dev)
    t = (sim.tables.match_markov, sim.tables.mixtures, sim.tables.trans)
    n_t = sim.tables.mixtures.cdf_t.shape[1]
    nb, K = sim.tables.match_markov.breaks.shape
    table_bytes = 4 * (3 * n_t + 2 * nb * K + 2 * nb + 21)
    wk = walk_ablate.experiment_keys(dev)
    B = wk.shape[0]
    print(f"experiments: {B} lanes, tables n_t={n_t} nb={nb} K={K}", flush=True)
    experiments = (
        ("walk_ablation", walk_ablate.walk_ablation, walk_ablate.ABLATION_VARIANTS,
         walk_ablate.ABLATION_STEPS, "full", "bench/micro_walk8.py:142"),
        ("walk_row_select", walk_ablate.walk_row_select, walk_ablate.ROW_SELECT_VARIANTS,
         walk_ablate.ROW_SELECT_STEPS, "scan", "bench/micro_walk9.py:188"))

    def compare(fn, variants, v, steps, keys=wk):
        got = fn(v, keys, *t, steps)
        t0 = time.time()
        want = walk_ablate.fixed_walk_plain(variants[v], keys, *t, steps)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = 0
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"{fn.__name__}[{v}]: kernel and plain disagree on storing the words")
            if g is not None:
                if g.shape != w.shape or g.dtype != w.dtype:
                    fail(f"{fn.__name__}[{v}] E={steps}: output {tuple(g.shape)} {g.dtype} != "
                         f"plain {tuple(w.shape)} {w.dtype}")
                err = max(err, int((g.long() - w.long()).abs().max()))
        if err != 0:
            fail(f"{fn.__name__}[{v}] B={keys.shape[0]} E={steps}: kernel differs from its plain "
                 f"version (max abs err {err})")
        return got, plain_ms

    def exact_agree(got, where):
        for v in walk_ablate.ROW_SELECT_EXACT[1:]:
            if not all(torch.equal(x, y) for x, y in zip(got[v], got["scan"])):
                fail(f"walk_row_select[{v}] differs from `scan` {where}")

    plain_short, plain_full, plain_steps = {}, {}, {}
    ragged = wk[:RAGGED_LANES].contiguous()
    for name, fn, variants, steps, whole, _ in experiments:
        short, short_ragged = {}, {}
        for v in variants:
            short[v], plain_short[name, v] = compare(fn, variants, v, ABLATION_CHECK_STEPS)
            short_ragged[v], _ = compare(fn, variants, v, ABLATION_CHECK_STEPS, ragged)
        # K6's plain version runs at the row-select experiment's step count
        # (its 8,192 steps took 12-24 s); its kernel is held at 8,192 steps
        # against K7's `search` below
        plain_steps[name] = min(steps, walk_ablate.ROW_SELECT_STEPS)
        got, plain_full[name] = compare(fn, variants, whole, plain_steps[name])
        if plain_steps[name] != steps:
            got = fn(whole, wk, *t, steps)
        print(f"experiment {name}: {len(variants)} variants equal their plain versions at "
              f"{ABLATION_CHECK_STEPS} steps on {B} and on {RAGGED_LANES} lanes, `{whole}` at "
              f"{plain_steps[name]} steps (plain {plain_full[name]:.0f} ms)", flush=True)
        if name == "walk_ablation":
            # K7's `search` computes the same function through other match code
            search = walk_ablate.walk_row_select("search", wk, *t, steps)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, search)):
                fail(f"walk_ablation[full] differs from walk_row_select[search] at {steps} steps")
            print(f"experiment {name}: `full` equals walk_row_select[search] bit for bit at "
                  f"{steps} steps", flush=True)
            del search
        else:
            exact_agree(short, f"at {ABLATION_CHECK_STEPS} steps on {B} lanes")
            exact_agree(short_ragged, f"at {ABLATION_CHECK_STEPS} steps on {RAGGED_LANES} lanes")
            full = {"scan": got}
            for v in walk_ablate.ROW_SELECT_EXACT[1:]:
                full[v] = fn(v, wk, *t, steps)
            torch.cuda.synchronize()
            exact_agree(full, f"at {steps} steps")
            print(f"experiment {name}: scan, search and global agree bit for bit at "
                  f"{ABLATION_CHECK_STEPS} steps on {B} and {RAGGED_LANES} lanes and at {steps} "
                  "steps", flush=True)
            del full
        del got, short, short_ragged

    zero_counters()
    res = walk_ablate.measure_step_costs(sim.tables, dev, launches=TIMED_LAUNCHES)
    counts = {"walk_ablation": dict(walk_ablate.walk_ablation.launches_by_variant),
              "walk_row_select": dict(walk_ablate.walk_row_select.launches_by_variant)}
    if not res["exact_variants_agree"]:
        fail("measure_step_costs: the exact row-select variants disagree")
    results = []
    for name, fn, variants, steps, whole, replaces in experiments:
        key = "ablation" if name == "walk_ablation" else "row_select"
        for v in variants:
            r = res[key][v]
            if counts[name].get(v, 0) == 0:
                fail(f"{name}[{v}] was not launched by measure_step_costs: {counts}")
            bound, bound_by = _experiment_bound(variants[v], n_t, nb, K, B, steps, table_bytes)
            row = {
                "name": f"{name}[{v}]", "route": "cuda",
                "source": "nanosim_tpu_torch/csrc/walk_ablate.cu", "replaces": replaces,
                "kernel": "fixed_walk_warp_kernel", "B": B, "E": steps,
                "launches": counts[name][v], "max_abs_err": 0.0, "ms": r["ms"],
                "ns_per_lane_step": r["ns_per_lane_step"],
                "ns_per_serial_step": r["ns_per_serial_step"],
                "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                "path": "experiments",
            }
            if v == whole:
                row.update(plain_ms=plain_full[name], plain_steps=plain_steps[name],
                           role="record")
            else:  # the plain version of the other variants ran at the short check only
                row.update(plain_ms_at_check_steps=plain_short[name, v],
                           check_steps=ABLATION_CHECK_STEPS, role="variant")
            results.append(row)
            print(f"experiment {name}[{v}]: {r['ms']:.3f} ms per launch, {steps} steps x {B} "
                  f"lanes, {r['ns_per_lane_step']:.4f} ns per lane-step, "
                  f"{r['ns_per_serial_step']:.1f} ns per serial step (bound {bound:.4f} ms by "
                  f"{bound_by}, {r['ms'] / bound:.1f}x); launches {counts[name][v]}", flush=True)
    for label, key, steps in (
            ("step cost", "differences_ms", walk_ablate.ABLATION_STEPS),
            ("row select", "row_select_differences_ms", walk_ablate.ROW_SELECT_STEPS)):
        print(f"{label} differences (ms per launch of {steps} steps x {B} lanes, {card}): "
              + ", ".join(f"{k} = {v:.3f}" for k, v in res[key].items()), flush=True)
    return results


def _run_sim(ref, prefix, out, n, batch, fastq, device, seed=SEED, dna_type="linear",
             kmer_bias=None, chimeric=False, **kw):
    from nanosim_tpu_torch.sim.run import simulate_genome

    return simulate_genome(ref, prefix, out, n, fastq=fastq, seed=seed, batch=batch,
                           device=device, dna_type=dna_type, kmer_bias=kmer_bias,
                           chimeric=chimeric, **kw)


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


def phase_cuda_vs_cpu(d: str, only_chimeric: bool = False):
    from nanosim_tpu_torch.profiles import error_model, fixtures

    prefix, ref = make_fixture(os.path.join(d, "small"), 0.4, 700, 250, 300)
    # a segment mean of 1.9 makes multi-segment reads common in the chimeric runs
    error_model.write_chimeric_info(prefix + "_chimeric_info", 1.9, 0.2)
    circ = os.path.join(d, "small", "circ.fa")
    fixtures.make_reference_fasta(circ, [200000], seed=12, with_iupac=True)
    # -hp: references with long runs, so that suppression and resizing fire
    hp_ref = os.path.join(d, "small", "hp_ref.fa")
    fixtures.make_reference_fasta(hp_ref, [100000] * 4, seed=14, hp_bias=0.6)
    hp_circ = os.path.join(d, "small", "hp_circ.fa")
    fixtures.make_reference_fasta(hp_circ, [200000], seed=15, hp_bias=0.6)
    # -med/-sd: lognormal lengths about the small model's (mean 700, sd 250)
    ln = dict(median_len=650, sd_len=0.35)
    for label, r, dna, recon, k, chi, kw in (
            ("linear", ref, "linear", None, None, False, {}),
            ("circular", circ, "circular", None, None, False, {}),
            ("linear NANOSIM_TPU_RECON=0", ref, "linear", "0", None, False, {}),
            ("-hp linear", hp_ref, "linear", None, HP_K, False, {}),
            ("-hp circular", hp_circ, "circular", None, HP_K, False, {}),
            ("-hp linear NANOSIM_TPU_RECON=0", hp_ref, "linear", "0", HP_K, False, {}),
            ("--chimeric linear", ref, "linear", None, None, True, {}),
            ("--chimeric circular", circ, "circular", None, None, True, {}),
            ("--chimeric linear NANOSIM_TPU_RECON=0", ref, "linear", "0", None, True, {}),
            ("--chimeric -hp circular", hp_circ, "circular", None, HP_K, True, {}),
            ("-med/-sd linear", ref, "linear", None, None, False, ln),
            ("-med/-sd circular", circ, "circular", None, None, False, ln),
            ("-med/-sd linear NANOSIM_TPU_RECON=0", ref, "linear", "0", None, False, ln),
            ("-med/-sd --perfect linear", ref, "linear", None, None, False,
             dict(ln, perfect=True))):
        if only_chimeric and not chi:
            continue
        outs = {}
        files = FILES[:2] if kw.get("perfect") else FILES  # perfect reads: no unaligned pass
        with recon_env(recon):
            for dev in ("cpu", "cuda"):
                out = os.path.join(d, "small", label.replace(" ", "_").replace("/", "") + "_"
                                   + dev)
                _run_sim(r, prefix, out, 400, 64, True, dev, dna_type=dna, kmer_bias=k,
                         chimeric=chi, **kw)
                outs[dev] = [sha(out + s) for s in files]
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
        if ";" in nm:  # a chimeric read of several segments: not one span
            continue
        pos = int(nm.split("_aligned_")[0].rsplit("_", 1)[1])
        if pos + int(nm.split("_")[-2]) > genome_len:
            out.append(nm)
    return out


def check_error_profile(path: str, g, n_records: int = 200, crossing=(), ref_pos=None):
    """ref_base must equal the genome at pos + Seq_pos (wrapping at the
    origin of a circular chromosome) on the first n_records records and on
    every record of the reads in `crossing`.  Records of chimeric reads with
    several segments are passed over (their rows do not say which segment
    they belong to), and so are those for which `ref_pos(chrom, pos)` (the
    name's position mapped to the sequence's) gives None.  Returns the number
    of checked records that wrap the origin."""
    import mmap

    idx = g.name_index()
    wraps = 0

    def check(line: str):
        nonlocal wraps
        name, seq_pos, etype, elen, ref_base, _ = line.rstrip("\n").split("\t")
        if ";" in name:
            return False
        if etype == "ins":
            if ref_base != "-" * int(elen):
                fail(f"insertion with ref bases: {line!r}")
            return True
        chrom, pos = name.split("_aligned_")[0].rsplit("_", 1)
        pos = int(pos) if ref_pos is None else ref_pos(chrom, int(pos))
        if pos is None:
            return False
        c = idx[chrom]
        ln = int(g.lengths[c])
        start = pos + int(seq_pos)
        if g.slice(c, start % ln, int(elen)).tobytes().decode() != ref_base:
            fail(f"ref_base does not match the genome: {line!r}")
        wraps += start + int(elen) > ln
        return True

    checked = 0
    with open(path) as f:
        header = f.readline()
        if not header.startswith("Seq_name"):
            fail("error profile has no header")
        for line in f:
            checked += check(line)
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
    from nanosim_tpu_torch.ops import (assemble_cuda, gather_cuda, gather_window, walk_ablate,
                                       walk_cuda)
    from nanosim_tpu_torch.sim import output

    output.RUN_STATS.reset()
    walk_cuda.aligned_steps.launches = 0
    walk_cuda.aligned_steps.launches_by_shape = {}
    walk_cuda.unaligned_steps.launches = 0
    walk_cuda.unaligned_steps.launches_by_shape = {}
    gather_cuda.gather_codes.launches = 0
    gather_cuda.gather_u8.launches = 0
    gather_cuda.gather_u8.launches_by_width = {}
    assemble_cuda.assemble_rolls.launches = 0
    gather_window.gather_windowed.launches = 0
    gather_window.gather_windowed.launches_by_variant = {}
    gather_window.gather_windowed.launches_by_copy = {}
    for fn in (walk_ablate.walk_ablation, walk_ablate.walk_row_select):
        fn.launches = 0
        fn.launches_by_variant = {}


def _by_budget(by_shape: dict) -> dict:
    out = {}
    for (_, e), n in by_shape.items():
        out[e] = out.get(e, 0) + n
    return out


def read_counters() -> dict:
    from nanosim_tpu_torch.ops import assemble_cuda, gather_cuda, walk_cuda
    from nanosim_tpu_torch.sim import output

    return {"aligned": walk_cuda.aligned_steps.launches,
            "aligned_by_budget": _by_budget(walk_cuda.aligned_steps.launches_by_shape),
            "unaligned": walk_cuda.unaligned_steps.launches,
            # per walk shape, keyed "BxE" (the ranks send them as JSON)
            **{f"{kind}_by_shape": {f"{b}x{e}": n for (b, e), n in fn.launches_by_shape.items()}
               for kind, fn in (("aligned", walk_cuda.aligned_steps),
                                ("unaligned", walk_cuda.unaligned_steps))},
            "gather": gather_cuda.gather_codes.launches,
            "gather_u8": gather_cuda.gather_u8.launches,
            "gather_u8_by_width": dict(gather_cuda.gather_u8.launches_by_width),
            "assemble": assemble_cuda.assemble_rolls.launches,
            "packed_spills": output.RUN_STATS.packed_spills,
            "overflow_rescue_lanes": output.RUN_STATS.overflow_rescue_lanes,
            "checksum_fallback_lanes": output.RUN_STATS.checksum_fallback_lanes}


@contextlib.contextmanager
def timed_hp_log(seconds: list):
    """Adds the host seconds spent composing the device-materialized -hp
    routes' error logs in Python (`_hp_log_bytes` of GenomeBatchWriter and of
    ChimericBatchWriter) to seconds[0]."""
    from nanosim_tpu_torch.sim.output import ChimericBatchWriter, GenomeBatchWriter

    saved = []
    for cls in (GenomeBatchWriter, ChimericBatchWriter):
        raw = cls.__dict__["_hp_log_bytes"]
        static = isinstance(raw, staticmethod)

        def timed(*a, _inner=raw.__func__ if static else raw, **kw):
            t0 = time.time()
            try:
                return _inner(*a, **kw)
            finally:
                seconds[0] += time.time() - t0

        saved.append((cls, raw))
        setattr(cls, "_hp_log_bytes", staticmethod(timed) if static else timed)
    try:
        yield
    finally:
        for cls, raw in saved:
            setattr(cls, "_hp_log_bytes", raw)


def phase_path(label: str, d: str, prefix: str, ref: str, n: int, card: str,
               dna_type: str, kernels, kmer_bias=None, traced_rerun: bool = True,
               batch: int = BATCH, chimeric: bool = False, **kw):
    """Drive one path through `simulate_genome(device="cuda")` (`kw`: more
    of its options) with the counters zeroed just before and read just
    after; every kernel in `kernels` must have launched, no lane may have
    needed the checksum fallback, the record counts must match, ref_base must
    match the genome, and a traced same-seed rerun must give the same bytes."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome

    out1 = os.path.join(d, label, "run1", "sim")
    os.makedirs(os.path.dirname(out1))
    log_s = [0.0]
    zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with timed_hp_log(log_s):
        counts = _run_sim(ref, prefix, out1, n, batch, True, "cuda", dna_type=dna_type,
                          kmer_bias=kmer_bias, chimeric=chimeric, **kw)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_counters()
    launches["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{label} path: {counts} in {dt:.2f}s -> {n / dt:.1f} reads/s on {card}; "
          f"peak device memory {launches['peak_device_bytes'] / 2**20:.1f} MiB; "
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
    if chimeric:
        n_chi = sum(1 for nm in names if "_chimeric_" in nm)
        print(f"{label} path: {n_chi} of {len(names)} aligned reads have more than one "
              f"segment; packed_spills {launches['packed_spills']}", flush=True)
        if n_chi == 0:
            fail(f"no chimeric read on the {label} path")
    nu = len(read_names(out1 + "_unaligned_reads.fastq"))
    if (len(names), nu) != (counts["aligned"], counts["unaligned"]):
        fail(f"read counts {(len(names), nu)} != requested {counts}")
    g = PackedGenome.from_fasta(ref, dna_type=dna_type)
    crossing = crossing_reads(names, g.total_len) if dna_type == "circular" else []
    wraps = check_error_profile(out1 + "_aligned_error_profile", g, crossing=crossing)
    print(f"{label} path: ref_base checked; {len(crossing)} reads cross the origin, "
          f"{wraps} checked records wrap it", flush=True)
    if dna_type == "circular" and wraps == 0 and not chimeric:
        # (the short chimeric runs hold too few one-segment reads across the origin)
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
        _run_sim(ref, prefix, out2, n, batch, True, "cuda", dna_type=dna_type,
                 kmer_bias=kmer_bias, chimeric=chimeric, **kw)
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
                 kmer_bias=None, chimeric: bool = False, batch: int = BATCH):
    """NANOSIM_TPU_RECON=0 at full width: the read-emitting program's files
    (with kmer_bias: the unfused -hp program's) must equal the host
    reconstruction's for the same seed and size."""
    import torch

    tag = ("--chimeric " if chimeric else "") + ("-hp " if kmer_bias else "")
    if chimeric:  # the parts assembly is plain torch: K4, no K3, no K5
        kernels = ("gather_u8", "aligned", "unaligned")
    else:
        kernels = (("gather_u8", "assemble") if kmer_bias else ("gather",)) + (
            "aligned", "unaligned")
    outs, launches = {}, None
    for recon in ("0", None):
        out = os.path.join(d, f"recon{recon or ''}{'_hp' if kmer_bias else ''}"
                              f"{'_chi' if chimeric else ''}", "sim")
        os.makedirs(os.path.dirname(out))
        zero_counters()
        with recon_env(recon):
            t0 = time.time()
            _run_sim(ref, prefix, out, n, batch, True, "cuda", kmer_bias=kmer_bias,
                     chimeric=chimeric)
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


# --- K8: the windowed byte gather (the measuring kernel of the gather window) ---


def _ragged_window_inputs(B: int, L: int, PB: int, seed: int):
    """Packed rows, near-contiguous indices and their window starts at a
    ragged shape (B not a multiple of 8, L not of 1,024), from numpy: lane 0
    reads past the row's end (window rows that do not exist read as zeros),
    lane 1 has a tile whose span exceeds a 2,048-code (W4) window."""
    import numpy as np
    import torch

    from nanosim_tpu_torch.ops import gather_window

    rs = np.random.default_rng(seed)
    packed = rs.integers(0, 256, (B, PB), dtype=np.uint8)
    drift = np.cumsum(rs.integers(-1, 2, (B, L)), axis=1)
    idx = np.clip(rs.integers(0, 64, (B, 1)) + np.arange(L)[None, :] + drift, 0, 4 * PB - 1)
    idx[0, -700:] = 4 * PB - 1 - np.arange(700)[::-1] // 4
    idx[1, 1024:1024 + 300] += 2500
    idx = np.clip(idx, 0, 4 * PB - 1).astype(np.int32)
    idx_t = torch.from_numpy(idx).cuda()
    n_tiles = -(-L // gather_window.TILE)
    ws, _ = gather_window.window_starts(idx_t, torch.ones_like(idx_t, dtype=torch.bool), n_tiles)
    # lane 0's last window starts past the row's end by a row
    ws[0, -1] = ((PB // 128 + 1) * 128) * 4
    return torch.from_numpy(packed).cuda(), idx_t, ws.contiguous()


def phase_gather_window(card: str):
    """K8 (bench/gather_variants.py:75) on the experiment's inputs (B=1,024,
    L=19,456, 4,608 packed bytes, realistic_idx from RandomState(0); the
    windows come by TMA bulk copies) and at a ragged shape (B=37, L=3,000,
    770-byte rows: the threads' copies): every instance against its plain
    version, each input on the copy route the launcher must report for it.
    Then, with the counters zeroed,
    gather_window.measure_gather_variants (every instance launched, the W4
    coverage check), and each instance's figures from _kernel_times: ms per
    launch beside the bound, the plain version and one torch.gather of the
    same bytes, the kernel's and torch.gather's device time, the host's us
    per call, and a trace of 100 calls that may show nothing but the
    kernel, whose device time counts only where it shows one launch a
    call."""
    import torch

    from nanosim_tpu_torch.ops import gather_window as gw

    dev = torch.device("cuda")
    rec = gw.experiment_inputs(dev)
    ragged = _ragged_window_inputs(37, 3000, 770, 9)
    copy = {}  # the copy route the launcher reported for each input
    for role, (packed, idx, ws), route in (("record", rec[:3], "bulk"),
                                           ("ragged", ragged, "threads")):
        B, L = idx.shape
        gw.gather_windowed.launches_by_copy = {}
        for kt, w8v in gw.INSTANCES:
            got = gw.gather_windowed(packed, idx, ws, kt, w8v)
            want = gw.gather_windowed_plain(packed, idx, ws, w8v)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"gather_windowed KT{kt} W{w8v} B={B} L={L}: kernel output "
                     f"{tuple(got.shape)} {got.dtype} != plain {tuple(want.shape)} {want.dtype}")
            err = int((got.long() - want.long()).abs().max())
            if err != 0:
                fail(f"gather_windowed KT{kt} W{w8v} B={B} L={L}: kernel differs from its plain "
                     f"version (max abs err {err})")
        routes = dict(gw.gather_windowed.launches_by_copy)
        if routes != {route: len(gw.INSTANCES)}:
            fail(f"gather_windowed B={B} L={L} PB={packed.shape[1]}: the launcher took the copy "
                 f"routes {routes}, not the {route} route on every launch")
        copy[role] = route
        print(f"kernel gather_windowed: B={B} L={L} PB={packed.shape[1]} (copies by the "
              f"{route} route, as the launcher reported): instances {gw.INSTANCES} exact against "
              f"the plain version; W4 windows cover every tile: {gw.window_covers(idx, ws, 4)}",
              flush=True)
    packed, idx, ws, want = rec
    B, L = idx.shape
    PB = packed.shape[1]
    zero_counters()
    res = gw.measure_gather_variants(dev, launches=GATHER_TIMED_LAUNCHES, inputs=rec)
    counts = dict(gw.gather_windowed.launches_by_variant)
    # the library yardstick: one torch.gather of the packed bytes (its int64
    # index made outside the timed call)
    i64 = (idx >> 2).long()
    times = {}
    for name, v in res["instances"].items():
        kt, w8v = v["kt"], v["w8v"]
        times[name] = _kernel_times(
            f"gather_windowed[{name}]", lambda: gw.gather_windowed(packed, idx, ws, kt, w8v),
            lambda: gw.gather_windowed_plain(packed, idx, ws, w8v),
            lambda: torch.gather(packed, 1, i64), "gather_window_kernel",
            GATHER_TIMED_LAUNCHES, one_kernel=True)
    del i64
    # each index read once (4 B), each result written once (4 B), each
    # packed row read once
    bound, bound_by = _bound_ms(8 * B * L + B * PB, 0, 0)
    results = []
    for name, v in res["instances"].items():
        kt, w8v, t = v["kt"], v["w8v"], times[name]
        print(f"experiment gather_windowed[{name}] (the experiment's {', '.join(v['names'])}; "
              f"{copy['record']} copies): sweep {v['ms']:.4f} ms; "
              + _times_text(t, bound, bound_by)
              + f"; one kernel a call: {t['trace_kernel_launches']} launches, "
              f"{t['trace_other_ops']} other device ops in {t['trace_calls']} calls"
              + f"; correct={v['correct']} window covers={v['window_covers']}; {card}",
              flush=True)
        if counts.get((kt, w8v), 0) == 0:
            fail(f"gather_windowed KT{kt} W{w8v} was not launched by measure_gather_variants")
        row = {
            "name": f"gather_windowed[{name}]", "route": "cuda",
            "source": "nanosim_tpu_torch/csrc/gather_window.cu",
            "replaces": "bench/gather_variants.py:75", "B": B, "L": L, "PB": PB,
            "kt": kt, "w8v": w8v, "copy": copy["record"],
            "variants": v["names"], "launches": counts[kt, w8v], "max_abs_err": 0.0,
            "sweep_ms": v["ms"], **t, "bound_ms": bound, "bound_by": bound_by,
            "correct": v["correct"], "role": "record", "path": "experiments",
        }
        results.append(row)
    return results


# --- the transcriptome slice ---------------------------------------------------

TRX_BATCH = BATCH // 4  # bench.py:319
N_TRX = 100000  # transcripts (GENCODE's human set is about 250,000)
TRX_MEAN = 1800
N_TRX_READS = 10000
N_TRX_RECON0 = 2000
N_TRX_HP = 1000
N_EXACT = 4000  # phase 20: fewer reads than phase 13, to keep the script in its limit
N_IR_TRX = 2000
IR_GENOME = 10_000_000
# exon counts of the longest structures: TTN's longest transcript has 363
# exons, and a few hundred human genes have more than 100
IR_LONG_EXONS = (363, 250, 180, 120)
IR_MARKOV = ((0.6, 0.4), (0.55, 0.45), (0.35, 0.65))  # bench.py:295-298
# the small fixture's structures put on the '-' strand for the '-' strand runs
# (the CPU test's ir_minus fixture flips the same three)
MINUS_STRAND_IR = (1, 4, 6)


def make_ir_structures(d: str, n_transcripts: int, genome_len: int, seed: int,
                       long_exons=()):
    """A genome of one chromosome, transcripts with introns between their
    exons and their GFF3 structures, in the layout of the fixture writer's
    make_ir_fixture (every structure on the '+' strand: on the '-' strand the
    JAX package's two routes disagree, ROADMAP section 3).  Exon counts are
    lognormal (median 7, as in GENCODE's human transcripts, at most 80)
    except for the first structures, which have `long_exons` exons each (a
    structure of n exons has 2n - 1 features); exons are 80-320 bp, introns
    80-400 bp.  Returns (genome_fa, trx_fa, [(name, length)])."""
    import numpy as np

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures

    rng = np.random.default_rng(seed)
    genome_fa = os.path.join(d, "genome.fa")
    fixtures.make_reference_fasta(genome_fa, [genome_len], seed=seed + 1)
    g = PackedGenome.from_fasta(genome_fa)
    trx_fa = os.path.join(d, "transcripts.fa")
    out = []
    cursor = 100
    with open(trx_fa, "w") as tf, open(os.path.join(d, "training_added_intron_final.gff3"),
                                       "w") as gf:
        gf.write("##gff-version 3\n")
        for i in range(n_transcripts):
            name = f"ENSTIR{i:06d}"
            feats, pos = [], cursor
            n_exon = (long_exons[i] if i < len(long_exons)
                      else int(np.clip(np.rint(rng.lognormal(np.log(7), 0.75)), 2, 80)))
            for e in range(n_exon):
                elen = int(rng.integers(80, 320))
                feats.append(("exon", pos, pos + elen))
                pos += elen
                if e < n_exon - 1:
                    ilen = int(rng.integers(80, 400))
                    feats.append(("intron", pos, pos + ilen))
                    pos += ilen
            cursor = pos + int(rng.integers(200, 500))
            if cursor >= genome_len:
                raise ValueError("the IR genome is too short for its transcripts")
            seq = np.concatenate([g.flat[s:e] for t, s, e in feats if t == "exon"])
            tf.write(f">{name}\n{seq.tobytes().decode()}\n")
            for t, s, e in feats:
                gf.write(f"chr1\tfix\t{t}\t{s + 1}\t{e}\t.\t+\t.\ttranscript_id={name}\n")
            out.append((name, len(seq)))
    return genome_fa, trx_fa, out


def flip_strands(gff: str, names):
    """Rewrite the structures' GFF3 with those of `names` on the '-' strand."""
    out = []
    with open(gff) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if len(c) >= 9 and c[8].split("=")[-1] in names:
                c[6] = "-"
            out.append("\t".join(c))
    with open(gff, "w") as f:
        f.write("\n".join(out) + "\n")


def make_trx_fixtures(d: str, n_trx: int, ir_trx: int, ir_genome: int, n_kde: int = 2000,
                      long_exons=()):
    """The transcriptome model (bench.py:287-289: mean read 1,000, sd 300, 2D
    mean 1,600) with the IR Markov of bench.py:295-298, a transcriptome of
    n_trx transcripts (mean 1,800 bp) with its expression table and a polyA
    list of every transcript, and the IR structures.  Returns a dict of
    paths."""
    import numpy as np

    from nanosim_tpu_torch.profiles import error_model, fixtures

    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=1000, sd_read_len=300, transcriptome=True,
                            mean_2d_ref_len=1600, n_kde_points=n_kde)
    error_model.write_ir_markov(prefix + "_IR_markov_model", np.array(IR_MARKOV))
    trx_fa = os.path.join(d, "trx.fa")
    trxs = fixtures.make_transcript_reference(trx_fa, n_transcripts=n_trx, mean_len=TRX_MEAN,
                                              seed=3)
    exp = os.path.join(d, "exp.tsv")
    fixtures.make_expression_tsv(exp, trxs, seed=4)
    polya = os.path.join(d, "polya.txt")
    with open(polya, "w") as f:
        f.write("".join(name + "\n" for name, _ in trxs))
    genome_fa, ir_trx_fa, ir_trxs = make_ir_structures(d, ir_trx, ir_genome, 7, long_exons)
    ir_exp = os.path.join(d, "ir_exp.tsv")
    fixtures.make_expression_tsv(ir_exp, ir_trxs, seed=8)
    return {"prefix": prefix, "trx": trx_fa, "exp": exp, "polya": polya, "genome": genome_fa,
            "ir_trx": ir_trx_fa, "ir_exp": ir_exp}


def ir_ref_pos(gff3: str):
    """The position in its transcript of an intron-retention read's name.
    A read whose transcript retained an intron is cut from the genome's
    intervals and named by its genomic start; if it took no base of the
    retained intron (no ';' in its name) it lies on exons only, so its
    genomic start maps into the transcript.  Other reads are named by their
    transcript position.  None where the two readings overlap or the
    genomic start is in no exon ('+' strand structures)."""
    exons = {}
    with open(gff3) as f:
        for line in f:
            cols = line.split("\t")
            if len(cols) > 8 and cols[2] == "exon":
                exons.setdefault(cols[8].strip().split("=")[1], []).append(
                    (int(cols[3]) - 1, int(cols[4])))

    def ref_pos(chrom: str, pos: int):
        ex = exons.get(chrom)
        if not ex or pos < ex[0][0]:
            return pos
        if pos < sum(e - s for s, e in ex):
            return None
        off = 0
        for s, e in ex:
            if s <= pos < e:
                return off + pos - s
            off += e - s
        return None

    return ref_pos


# run kinds: (transcriptome, genome, expression, kwargs)
def _trx_run_args(fx: dict, kind: str):
    cdna = dict(model_ir=False, polya=fx["polya"], basecaller="guppy")
    return {
        "cDNA": (fx["trx"], "", fx["exp"], cdna),
        "direct RNA": (fx["trx"], "", fx["exp"], dict(cdna, uracil=True)),
        "intron retention": (fx["ir_trx"], fx["genome"], fx["ir_exp"], dict(model_ir=True)),
        "-hp": (fx["trx"], "", fx["exp"], dict(cdna, kmer_bias=HP_K, homopolymer=True)),
        "--perfect": (fx["trx"], "", fx["exp"], dict(cdna, perfect=True)),
    }[kind]


def _run_trx(fx: dict, kind: str, out: str, n: int, batch: int, device: str, seed: int = SEED):
    from nanosim_tpu_torch.sim.run_transcriptome import simulate_transcriptome

    trx, genome, exp, kw = _trx_run_args(fx, kind)
    return simulate_transcriptome(trx, genome, exp, fx["prefix"], out, n, fastq=True, seed=seed,
                                  batch=batch, device=device, **kw)


def _run_trx_exact(fx: dict, out: str, n: int, batch: int, device: str, seed: int = SEED,
                   exact_conditional: bool = True):
    """The cDNA aligned pass (polyA tails, FASTQ) with
    `TranscriptomeSimulator(exact_conditional=True)`: the aligned lengths
    from the 2D KDE's exact conditional ([B, N] float32 weights, XLA CPU's
    sum orders); with exact_conditional=False the default nearest-of-a-pool
    draw.  Returns the reads written."""
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim import output
    from nanosim_tpu_torch.sim.run_transcriptome import (POLYA_SCALE, TranscriptomeSimulator,
                                                         TrxBatchWriter)

    trx = PackedGenome.from_fasta(fx["trx"])
    prof = profile.load_profile(fx["prefix"], mode="transcriptome", fastq=True, model_ir=False,
                                polya_path=fx["polya"])
    expr = profile.load_expression(fx["exp"], dict(zip(trx.names, (int(x) for x in trx.lengths))))
    sim = TranscriptomeSimulator(trx, prof, expr, fastq=True, polya_scale=POLYA_SCALE["guppy"],
                                 batch=batch, exact_conditional=exact_conditional, device=device)
    fw = output.FastxWriter(out + "_aligned_reads.fastq", True)
    el = output.ErrorLogWriter(out + "_aligned_error_profile", header=True)
    got = sim.run(n, TrxBatchWriter(fw, el), seed=seed)
    fw.close()
    el.close()
    return got


def phase_exact_conditional_path(d: str, fx: dict, card: str, n: int = N_EXACT):
    """Phase 20: the cDNA aligned pass with the exact 2D-KDE conditional at
    the transcriptome configuration of phase 13 (batch 512, the 2D KDE's
    2,000 points), n reads, counters zeroed just before and read just after:
    K1 must have launched with 0 checksum-fallback lanes, the record count
    must match and ref_base must match the transcript on 200 records.
    Prints reads/s and the peak device memory; then a traced same-seed
    rerun must give the same bytes (device ops per batch), and the default
    draw's aligned pass is timed beside it.  Returns (reads/s, launches)."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome

    out = os.path.join(d, "exact conditional", "sim")
    os.makedirs(os.path.dirname(out))
    out2 = os.path.join(d, "exact conditional", "run2")
    zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    got = _run_trx_exact(fx, out, n, TRX_BATCH, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"exact conditional path (cDNA aligned pass, batch {TRX_BATCH}): {got} reads in "
          f"{dt:.2f}s -> {n / dt:.1f} reads/s on {card}; peak device memory {peak:.1f} MiB; "
          f"launches {launches}", flush=True)
    if launches["aligned"] == 0 or launches["checksum_fallback_lanes"] != 0:
        fail(f"exact conditional path: launches {launches}")
    names = read_names(out + "_aligned_reads.fastq")
    if len(names) != n or got != n:
        fail(f"exact conditional path: {len(names)} records, {got} written, {n} requested")
    check_error_profile(out + "_aligned_error_profile", PackedGenome.from_fasta(fx["trx"]))
    print("exact conditional path: ref_base checked on 200 records", flush=True)
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run_trx_exact(fx, out2, n, TRX_BATCH, "cuda")
        torch.cuda.synchronize()
    dt2 = time.time() - t0
    if [sha(out + s) for s in FILES[:2]] != [sha(out2 + s) for s in FILES[:2]]:
        fail("exact conditional path: second run with the same seed differs")
    print(f"exact conditional path: second run byte-identical ({n / dt2:.1f} reads/s, traced)",
          flush=True)
    _, n_ops = report_trace(prof, dt2)
    print(f"exact conditional path: {n_ops / launches['aligned']:.0f} device ops per batch "
          f"({launches['aligned']} batches of {TRX_BATCH})", flush=True)
    t0 = time.time()
    _run_trx_exact(fx, os.path.join(d, "exact conditional", "default"), n, TRX_BATCH, "cuda",
                   exact_conditional=False)
    torch.cuda.synchronize()
    dt3 = time.time() - t0
    print(f"cDNA aligned pass with the default nearest-of-a-pool draw: {n} reads in {dt3:.2f}s "
          f"-> {n / dt3:.1f} reads/s on {card}", flush=True)
    return n / dt, launches


def exact_cuda_vs_cpu(fx: dict):
    """The cDNA aligned pass with the exact conditional at a small size:
    the CUDA files must equal the CPU files."""
    outs = {}
    for dev in ("cpu", "cuda"):
        out = os.path.join(os.path.dirname(fx["prefix"]), f"exact_cDNA_{dev}")
        _run_trx_exact(fx, out, 200, 64, dev)
        outs[dev] = [sha(out + s) for s in FILES[:2]]
    if outs["cpu"] != outs["cuda"]:
        fail(f"small transcriptome cDNA exact_conditional=True run: CUDA output differs from the "
             f"CPU output: {outs}")
    print("small transcriptome cDNA exact_conditional=True run: CUDA files byte-identical to "
          "the CPU path", flush=True)


def phase_trx_cuda_vs_cpu(d: str):
    """The transcriptome and --perfect runs at a small size, CUDA against the
    CPU path: byte-identical files (the CPU path is held byte-identical to
    the JAX package by the test suite)."""
    from nanosim_tpu_torch.profiles import fixtures

    fx = make_trx_fixtures(os.path.join(d, "trx_small"), 25, 12, 150000, n_kde=300)
    # the same fixture with three of its structures on the '-' strand
    fx_minus = make_trx_fixtures(os.path.join(d, "trx_small_minus"), 25, 12, 150000, n_kde=300)
    minus = {f"ENSTIR{i:06d}" for i in MINUS_STRAND_IR}
    flip_strands(os.path.join(d, "trx_small_minus", "training_added_intron_final.gff3"), minus)
    gprefix, gref = make_fixture(os.path.join(d, "perfect_small"), 0.4, 700, 250, 300)
    gcirc = os.path.join(d, "perfect_small", "circ.fa")
    fixtures.make_reference_fasta(gcirc, [200000], seed=12, with_iupac=True, hp_bias=0.6)
    runs = [(fx, k, None, "") for k in ("cDNA", "direct RNA", "intron retention", "-hp",
                                        "--perfect")]
    runs += [(fx, "cDNA", "0", ""), (fx, "intron retention", "0", "")]
    # '-' strand intron retention on both routes: each route's CUDA files
    # equal its own CPU files (the two routes differ there by inheritance
    # from the JAX package, ROADMAP section 3, and are not compared)
    runs += [(fx_minus, "intron retention", recon, " (-)") for recon in (None, "0")]
    for rfx, kind, recon, strand in runs:
        outs = {}
        label = f"{kind}{strand}"
        with recon_env(recon):
            for dev in ("cpu", "cuda"):
                out = os.path.join(os.path.dirname(rfx["prefix"]),
                                   f"{kind.replace(' ', '_')}{recon or ''}_{dev}")
                _run_trx(rfx, kind, out, 200, 64, dev)
                outs[dev] = [sha(out + s) for s in FILES if os.path.exists(out + s)]
        if outs["cpu"] != outs["cuda"]:
            fail(f"small transcriptome {label} run (RECON={recon}): CUDA output differs from the "
                 f"CPU output: {outs}")
        extra = ""
        if strand:  # the reads that retain an intron of a '-' strand structure
            names = read_names(out + "_aligned_reads.fastq")
            n_minus = sum(1 for nm in names
                          if "_RetainedIntron_" in nm and nm.split("_")[0] in minus)
            if n_minus == 0:
                fail(f"small transcriptome {label} run: no read retains an intron of a '-' "
                     "strand structure")
            extra = f" ({n_minus} reads retain an intron of a '-' strand structure)"
        print(f"small transcriptome {label} run{' NANOSIM_TPU_RECON=0' if recon else ''}: CUDA "
              f"files byte-identical to the CPU path{extra}", flush=True)
    exact_cuda_vs_cpu(fx)
    from nanosim_tpu_torch.sim.run import simulate_genome

    for label, ref, dna, recon, k in (("linear", gref, "linear", None, None),
                                      ("circular", gcirc, "circular", None, None),
                                      ("linear NANOSIM_TPU_RECON=0", gref, "linear", "0", None),
                                      ("-hp circular", gcirc, "circular", None, HP_K)):
        outs = {}
        with recon_env(recon):
            for dev in ("cpu", "cuda"):
                out = os.path.join(d, "perfect_small", f"{dna}{recon or ''}{k or ''}_{dev}")
                simulate_genome(ref, gprefix, out, 300, fastq=True, perfect=True, seed=SEED,
                                batch=64, device=dev, dna_type=dna, kmer_bias=k)
                outs[dev] = [sha(out + s) for s in FILES[:2]]
        if outs["cpu"] != outs["cuda"]:
            fail(f"small genome --perfect {label} run: CUDA output differs from the CPU output")
        print(f"small genome --perfect {label} run: CUDA files byte-identical to the CPU path",
              flush=True)


def phase_trx_kernels(fx: dict):
    """K1, K2 and K4 at the transcriptome paths' shapes, each against its
    plain version and timed as at the other shapes: the walks on the inputs
    the cDNA path's first meta-only batch and its unaligned pass's first
    batch give them; K4 on the direct-RNA unaligned pass's first
    read-emitting batch, on the first read-emitting aligned batch of cDNA
    (the RECON=0 route) and of `-hp` (bytes and 16-bit); K1 and K4 on the
    intron-retention batches (meta-only and read-emitting).  Each batch's
    peak device memory, and the IR walk's launches (traced) and time per
    batch at the fixture's f_max and at two smaller caps."""
    import dataclasses

    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.ops import apply_errors, error_walk, gather_cuda, homopolymer, rng
    from nanosim_tpu_torch.ops import walk_cuda
    from nanosim_tpu_torch.ops.cuda_build import time_ms
    from nanosim_tpu_torch.profiles import profile
    from nanosim_tpu_torch.sim import ir as ir_mod
    from nanosim_tpu_torch.sim.run_transcriptome import POLYA_SCALE, TranscriptomeSimulator
    from nanosim_tpu_torch.sim.unaligned_mode import UnalignedSimulator

    dev = torch.device("cuda")
    slots = torch.arange(TRX_BATCH, dtype=torch.int64, device=dev)
    trx = PackedGenome.from_fasta(fx["trx"])
    seq_len = dict(zip(trx.names, (int(x) for x in trx.lengths)))
    expr = profile.load_expression(fx["exp"], seq_len)

    def cdna_sim(k):
        prof = profile.load_profile(fx["prefix"], mode="transcriptome", fastq=True,
                                    homopolymer=k is not None, polya_path=fx["polya"])
        return TranscriptomeSimulator(trx, prof, expr, fastq=True,
                                      polya_scale=POLYA_SCALE["guppy"], batch=TRX_BATCH,
                                      kmer_bias=k, device=dev), prof

    sim, prof = cdna_sim(None)
    usim = UnalignedSimulator(trx, prof, fastq=True, batch=TRX_BATCH, uracil=True,
                              transcriptome_mode=True, device=dev)
    print(f"transcriptome plan: {trx.n_chrom} transcripts ({trx.total_len} bp), batch "
          f"{TRX_BATCH}, l_cap={sim.l_cap} l_out={sim.l_out} ht_cap={sim.ht_cap} "
          f"e_max={sim.e_max}; unaligned l_cap={usim.l_cap} e_max={usim.e_max}", flush=True)
    walks, rows = {}, []
    proxy = types.SimpleNamespace(**{k: getattr(walk_cuda, k) for k in dir(walk_cuda)
                                     if not k.startswith("__")})

    def cap_aligned(*args):
        walks["aligned"] = args
        return walk_cuda.aligned_steps(*args)

    def cap_unaligned(*args):
        walks["unaligned"] = args
        return walk_cuda.unaligned_steps(*args)

    proxy.aligned_steps, proxy.unaligned_steps = cap_aligned, cap_unaligned

    def cap_gather(parts, idx):
        rows.append((parts, idx))
        return gather_cuda.gather_u8(parts, idx)

    gather_ns = types.SimpleNamespace(gather_u8=cap_gather)
    gathers = [(apply_errors, "gather_cuda", gather_ns), (homopolymer, "gather_cuda", gather_ns)]
    base = rng.base_key(SEED, rng.STREAM_ALIGNED, device=dev)
    ubase = rng.base_key(SEED, rng.STREAM_UNALIGNED, device=dev)
    out, peak = _capture_batch(lambda: sim.batch_fn(emit_reads=False)(base, slots),
                               [(error_walk, "walk_cuda", proxy)])
    print(f"transcriptome meta-only batch: peak device memory {peak / 1e9:.3f} GB; "
          f"{int(out.valid.sum())} valid lanes of {TRX_BATCH}", flush=True)
    out, peak = _capture_batch(lambda: usim.batch_fn()(ubase, slots),
                               [(error_walk, "walk_cuda", proxy)] + gathers)
    print(f"direct-RNA unaligned batch (read-emitting, raw bytes): peak device memory "
          f"{peak / 1e9:.3f} GB; {int(out.valid.sum())} valid lanes", flush=True)
    del out
    if sorted(walks) != ["aligned", "unaligned"] or len(rows) != 1:
        fail(f"the transcriptome batches reached the walks {sorted(walks)} and the element "
             f"gather {len(rows)} times")
    results = [_walk_case("aligned", walks["aligned"], "record", "transcriptome"),
               _walk_case("unaligned", walks["unaligned"], "record", "transcriptome"),
               _gather_u8_case(*rows[0], "record", "direct RNA")]
    walks.clear()
    rows.clear()

    # the read-emitting aligned batches: cDNA (the RECON=0 route: bytes
    # through materialize_read) and -hp (bytes, then 16-bit elements through
    # resize_homopolymers)
    for k, path, widths in ((None, "cDNA RECON=0", [1]), (HP_K, "transcriptome -hp", [1, 2])):
        esim = sim if k is None else cdna_sim(k)[0]
        out, peak = _capture_batch(lambda: esim.batch_fn()(base, slots), gathers)
        if [p_.element_size() for p_, _ in rows] != widths:
            fail(f"the {path} read-emitting batch called the element gather at widths "
                 f"{[p_.element_size() for p_, _ in rows]}, not {widths}")
        print(f"{path} read-emitting batch: peak device memory {peak / 1e9:.3f} GB; "
              f"{int(out.valid.sum())} valid lanes", flush=True)
        del out
        for parts, idx in rows:
            results.append(_gather_u8_case(parts, idx, "record", path))
        rows.clear()
        torch.cuda.empty_cache()

    itrx = PackedGenome.from_fasta(fx["ir_trx"])
    iprof = profile.load_profile(fx["prefix"], mode="transcriptome", fastq=True, model_ir=True)
    iexpr = profile.load_expression(fx["ir_exp"], dict(zip(itrx.names,
                                                           (int(x) for x in itrx.lengths))))
    isim = TranscriptomeSimulator(itrx, iprof, iexpr, fastq=True, model_ir=True,
                                  ir_genome=PackedGenome.from_fasta(fx["genome"]),
                                  batch=TRX_BATCH, device=dev)
    if not isim.with_ir:
        fail("the intron-retention fixture has no eligible transcript")
    ir_calls = []
    ir_walk = ir_mod.ir_walk_and_extract

    def cap_ir(*args):
        ir_calls.append(args)
        return ir_walk(*args)

    out, peak = _capture_batch(lambda: isim.batch_fn(emit_reads=False)(base, slots),
                               [(ir_mod, "ir_walk_and_extract", cap_ir),
                                (error_walk, "walk_cuda", proxy)])
    if len(ir_calls) != 1 or "aligned" not in walks:
        fail(f"the intron-retention batch called the IR walk {len(ir_calls)} times and reached "
             f"the walks {sorted(walks)}")
    n_has_ir = int(out.has_ir.sum())
    del out
    results.append(_walk_case("aligned", walks["aligned"], "record", "intron retention"))
    walks.clear()
    out, epeak = _capture_batch(lambda: isim.batch_fn()(base, slots), gathers)
    if [p_.element_size() for p_, _ in rows] != [1]:
        fail(f"the intron-retention read-emitting batch called the element gather at widths "
             f"{[p_.element_size() for p_, _ in rows]}")
    del out
    results.append(_gather_u8_case(*rows[0], "record", "intron retention RECON=0"))
    rows.clear()
    from torch.profiler import ProfilerActivity, profile as tprofile

    f_max = isim.ir_tables.f_max
    batch_ms = time_ms(lambda: isim.batch_fn(emit_reads=False)(base, slots), 3)
    print(f"intron-retention batch (f_max={f_max}, {itrx.n_chrom} structured transcripts): "
          f"peak device memory {peak / 1e9:.3f} GB meta-only, {epeak / 1e9:.3f} GB "
          f"read-emitting; {n_has_ir} of {TRX_BATCH} lanes retain an intron; the meta-only "
          f"batch takes {batch_ms:.2f} ms", flush=True)
    # the IR walk at the fixture's f_max and, on the same inputs, with the
    # structure tables cut to fewer feature steps (the work of a table whose
    # longest structure has that many features)
    for cap in sorted({7, 63, f_max}):
        if cap > f_max:
            continue
        args = list(ir_calls[0])
        args[4] = dataclasses.replace(args[4], f_max=cap)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as tp:
            ir_walk(*args)
            torch.cuda.synchronize()
        n_kernels = sum(e.count for e in tp.key_averages()
                        if (getattr(e, "self_device_time_total", None)
                            or getattr(e, "self_cuda_time_total", 0)) > 0)
        ms = time_ms(lambda: ir_walk(*args), 3)
        print(f"IR walk at f_max={cap}: {n_kernels} device kernels per batch (traced), "
              f"{ms:.2f} ms per batch of {TRX_BATCH}", flush=True)
    return results


def phase_trx_path(label: str, d: str, fx: dict, kind: str, n: int, card: str, kernels,
                   traced_rerun: bool = True, recon=None):
    """Drive one transcriptome path through `simulate_transcriptome(device=
    "cuda")` with the counters zeroed just before and read just after; every
    kernel in `kernels` must have launched, no lane may have needed the
    checksum fallback, the record counts must match, ref_base must match the
    transcript on 200 records, and a traced same-seed rerun must give the
    same bytes."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome

    out1 = os.path.join(d, label, "run1", "sim")
    os.makedirs(os.path.dirname(out1))
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with recon_env(recon):
        counts = _run_trx(fx, kind, out1, n, TRX_BATCH, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_counters()
    print(f"{label} path: {counts} in {dt:.2f}s -> {n / dt:.1f} reads/s on {card}; "
          f"launches {launches}", flush=True)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"{missing} kernels were not launched on the {label} path: {launches}")
    if launches["checksum_fallback_lanes"] != 0:
        fail(f"{launches['checksum_fallback_lanes']} lanes failed the host replay's checksum")
    names = read_names(out1 + "_aligned_reads.fastq")
    nu = (len(read_names(out1 + "_unaligned_reads.fastq"))
          if os.path.exists(out1 + "_unaligned_reads.fastq") else 0)
    if (len(names), nu) != (counts["aligned"], counts["unaligned"]):
        fail(f"read counts {(len(names), nu)} != requested {counts}")
    n_ir = sum(1 for nm in names if "_RetainedIntron_" in nm)
    trx_key = "ir_trx" if kind == "intron retention" else "trx"
    if kind != "--perfect":
        # records of reads with bases of a retained intron (names with ';')
        # are passed over: their ref bases come from genomic intervals
        check_error_profile(
            out1 + "_aligned_error_profile", PackedGenome.from_fasta(fx[trx_key]),
            ref_pos=ir_ref_pos(os.path.join(os.path.dirname(fx["prefix"]),
                                            "training_added_intron_final.gff3"))
            if kind == "intron retention" else None)
    print(f"{label} path: ref_base checked on 200 records; {n_ir} reads retain an intron",
          flush=True)
    if kind == "intron retention" and n_ir == 0:
        fail("no read retains an intron on the intron-retention path")
    if kind in ("direct RNA",):
        with open(out1 + "_aligned_reads.fastq", "rb") as f:
            head = f.read(1 << 20)
        if b"T" in head.split(b"\n")[1] or b"U" not in head:
            fail("direct RNA reads carry T or no U")
    if not traced_rerun:
        return launches, n / dt, None, out1
    out2 = os.path.join(d, label, "run2", "sim")
    os.makedirs(os.path.dirname(out2))
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with recon_env(recon), profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run_trx(fx, kind, out2, n, TRX_BATCH, "cuda")
        torch.cuda.synchronize()
    dt2 = time.time() - t0
    for s in FILES:
        if os.path.exists(out1 + s) and sha(out1 + s) != sha(out2 + s):
            fail(f"{label} path: second run with the same seed differs in {s}")
    print(f"{label} path: second run byte-identical ({n / dt2:.1f} reads/s, traced)", flush=True)
    report_trace(prof, dt2)
    return launches, n / dt, n / dt2, out1


def phase_trx_recon0(d: str, fx: dict, kind: str, card: str, n: int = N_TRX_RECON0):
    """NANOSIM_TPU_RECON=0 at full width: the read-emitting program's files
    must equal the host reconstruction's for the same seed and size."""
    import torch

    outs, launches = {}, None
    for recon in ("0", None):
        out = os.path.join(d, f"trx_recon{recon or ''}_{kind.replace(' ', '_')}", "sim")
        os.makedirs(os.path.dirname(out))
        zero_counters()
        with recon_env(recon):
            t0 = time.time()
            _run_trx(fx, kind, out, n, TRX_BATCH, "cuda")
            torch.cuda.synchronize()
            dt = time.time() - t0
        got = read_counters()
        if got["checksum_fallback_lanes"] != 0:
            fail(f"{got['checksum_fallback_lanes']} lanes failed the host replay's checksum")
        if recon == "0":
            launches = got
            if any(got[k] == 0 for k in ("aligned", "unaligned", "gather_u8")):
                fail(f"a kernel was not launched with {kind} NANOSIM_TPU_RECON=0: {got}")
        print(f"{kind} NANOSIM_TPU_RECON={recon or 'unset'}: {n} reads in {dt:.2f}s -> "
              f"{n / dt:.1f} reads/s on {card}; launches {got}", flush=True)
        outs[recon] = [sha(out + s) for s in FILES]
    if outs["0"] != outs[None]:
        fail(f"{kind} NANOSIM_TPU_RECON=0 files differ from the host reconstruction's: {outs}")
    print(f"{kind} NANOSIM_TPU_RECON=0: files byte-identical to the host-reconstruction route",
          flush=True)
    return launches


def run_trx_slice(d: str, card: str):
    """Phases 12-14 and 20: the transcriptome and --perfect runs CUDA against
    CPU, the transcriptome kernels' shapes, the transcriptome paths at full
    width, and the exact conditional's path.  Returns (kernel rows, {path:
    launches}, rates)."""
    phase_trx_cuda_vs_cpu(d)
    t0 = time.time()
    fx = make_trx_fixtures(os.path.join(d, "trx"), N_TRX, N_IR_TRX, IR_GENOME,
                           long_exons=IR_LONG_EXONS)
    print(f"transcriptome fixture ({N_TRX} transcripts, mean {TRX_MEAN} bp; {N_IR_TRX} "
          f"structured transcripts on {IR_GENOME} bp) in {time.time() - t0:.1f}s", flush=True)
    rows = phase_trx_kernels(fx)
    paths, rates = {}, {}
    for label, kind, n, kernels, traced in (
            ("transcriptome", "cDNA", N_TRX_READS, ("aligned", "unaligned"), True),
            ("direct RNA", "direct RNA", N_TRX_READS, ("aligned", "unaligned", "gather_u8"),
             False),
            ("intron retention", "intron retention", N_TRX_READS, ("aligned", "unaligned"),
             False),
            ("transcriptome -hp", "-hp", N_TRX_HP, ("aligned", "unaligned", "gather_u8"),
             False)):
        launches, rate, rate2, _ = phase_trx_path(label, d, fx, kind, n, card, kernels,
                                                  traced_rerun=traced)
        paths[label] = launches
        rates[label] = (rate, rate2)
    for kind in ("cDNA", "intron retention"):
        paths[f"{kind} RECON=0"] = phase_trx_recon0(d, fx, kind, card)
    rate, paths["exact conditional"] = phase_exact_conditional_path(d, fx, card)
    rates["exact conditional (aligned pass)"] = (rate, None)
    return rows, paths, rates


# --- the metagenome slice --------------------------------------------------------

# the JAX package's metagenome configuration (bench.py:339-391): three species
# of two linear 8 Mb chromosomes each (48 Mb), the bench model with segment
# mean 1.3, abundances 50/30/20, `--chimeric`, batch 512
META_SPECIES = ("Escherichia_coli", "Bacillus_subtilis", "Salmonella_enterica")
META_ABUN = (50, 30, 20)
META_CHROM = 8_000_000
N_META = 10000
N_META_RECON0 = 2000  # NANOSIM_TPU_RECON=0 against Route A
META_FILES = ("_aligned_reads.fastq", "_aligned_error_profile", "_unaligned_reads.fastq")


def make_meta_fixture(d: str, sizes, mean_len: float, sd_len: float, n_kde: int,
                      segment_mean: float, numbers, abundances, hp_bias: float = 0.0) -> dict:
    """Model, one FASTA per species (`sizes[i]` its chromosome lengths), the
    genome list, a dna-type list making every chromosome linear, and an
    abundance matrix with one column per entry of `numbers`."""
    from nanosim_tpu_torch.profiles import error_model, fixtures

    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "training")
    fixtures.make_model_dir(prefix, mean_read_len=mean_len, sd_read_len=sd_len,
                            n_kde_points=n_kde)
    error_model.write_chimeric_info(prefix + "_chimeric_info", segment_mean, 0.2)
    glist, dl, abun = (os.path.join(d, f) for f in ("genome_list.tsv", "dna_types.tsv",
                                                    "abun.tsv"))
    with open(glist, "w") as gf, open(dl, "w") as df:
        for i, (sp, sz) in enumerate(zip(META_SPECIES, sizes)):
            path = os.path.join(d, f"{sp}.fa")
            fixtures.make_reference_fasta(path, sz, seed=20 + i, name_prefix=f"{sp[:3]}chr",
                                          hp_bias=hp_bias)
            gf.write(f"{sp}\t{path}\n")
            for ci in range(len(sz)):
                df.write(f"{sp}\t{sp[:3]}chr{ci + 1}\tlinear\n")
    with open(abun, "w") as f:
        f.write("Species\t" + "\t".join(str(n) for n in numbers) + "\n")
        for sp, row in zip(META_SPECIES, abundances):
            f.write(sp.replace("_", " ") + "\t" + "\t".join(str(a) for a in row) + "\n")
    return {"prefix": prefix, "glist": glist, "dl": dl, "abun": abun}


def _run_meta(fx: dict, out: str, batch: int, device: str, seed: int = SEED, **kw):
    from nanosim_tpu_torch.sim.run_metagenome import simulate_metagenome

    os.makedirs(os.path.dirname(out), exist_ok=True)
    return simulate_metagenome(fx["glist"], fx["abun"], fx["dl"], fx["prefix"], out,
                               fastq=True, seed=seed, batch=batch, device=device, **kw)


def _meta_shas(out: str, samples, perfect: bool = False) -> list:
    return [sha(f"{out}_{s}{suf}") for s in samples for suf in META_FILES
            if not (perfect and suf.startswith("_unaligned"))]


def phase_meta_cuda_vs_cpu(d: str):
    """Phase 16: the metagenome at a small size (three species, two samples of
    300 and 200 reads, batch 64, so that the species quota crosses batches),
    CUDA against CPU: byte-identical files for plain reads, `--chimeric` on
    Route A and with NANOSIM_TPU_RECON=0, `--perfect` and `-hp -k 6`; and
    `-med/-sd` (lognormal lengths, non-chimeric) on two species."""
    fx = make_meta_fixture(os.path.join(d, "meta_small"),
                           [[150000], [100000, 40000], [120000]], 700, 250, 300, 1.9,
                           (300, 200), ((60, 20), (30, 50), (10, 30)), hp_bias=0.5)
    fx2 = make_meta_fixture(os.path.join(d, "meta_small2"), [[150000], [100000, 40000]], 700,
                            250, 300, 1.9, (300, 200), ((70, 40), (30, 60)))
    samples = ("sample0", "sample1")
    for label, recon, f, kw in (
            ("metagenome", None, fx, {}),
            ("metagenome --chimeric", None, fx, dict(chimeric=True)),
            ("metagenome --chimeric NANOSIM_TPU_RECON=0", "0", fx, dict(chimeric=True)),
            ("metagenome --perfect", None, fx, dict(perfect=True)),
            ("metagenome -hp -k 6", None, fx, dict(kmer_bias=HP_K, homopolymer=True)),
            ("metagenome -med/-sd (two species)", None, fx2, dict(median_len=650, sd_len=0.35))):
        outs = {}
        with recon_env(recon):
            for dev in ("cpu", "cuda"):
                out = os.path.join(d, "meta_small", label.replace(" ", "_").replace("/", ""),
                                   dev, "sim")
                _run_meta(f, out, 64, dev, **kw)
                outs[dev] = _meta_shas(out, samples, kw.get("perfect", False))
        if outs["cpu"] != outs["cuda"]:
            fail(f"small {label} run: CUDA output differs from the CPU output: {outs}")
        print(f"small {label} run: CUDA files byte-identical to the CPU path (2 samples)",
              flush=True)


@contextlib.contextmanager
def timed_species_assignment(acc: list):
    """Counts the batches and adds the host seconds of
    run_metagenome.assign_species_batch to acc = [calls, seconds]."""
    from nanosim_tpu_torch.sim import run_metagenome

    raw = run_metagenome.assign_species_batch

    def timed(*a, **kw):
        t0 = time.time()
        try:
            return raw(*a, **kw)
        finally:
            acc[0] += 1
            acc[1] += time.time() - t0

    run_metagenome.assign_species_batch = timed
    try:
        yield
    finally:
        run_metagenome.assign_species_batch = raw


def _segment_bases_by_species(names) -> dict:
    """Reference bases per species over every segment of the aligned reads'
    names (`<sp>-<chrom>_<pos>[;gap_<len>;<sp>-...]_aligned_<i>..._<head>_
    <m1;m2;...>_<tail>`): what the species quota counts."""
    out = {sp: 0 for sp in META_SPECIES}
    for nm in names:
        comps = [c for c in nm.split("_aligned_")[0].split(";") if not c.startswith("gap_")]
        mids = nm.split("_")[-2].split(";")
        if len(comps) != len(mids):
            fail(f"malformed metagenome read name {nm!r}")
        for c, m in zip(comps, mids):
            out[c.split("-", 1)[0]] += int(m)
    return out


def phase_metagenome_path(d: str, card: str):
    """Phase 17: the metagenome path at full width (the JAX package's
    metagenome configuration): `simulate_metagenome(..., chimeric=True,
    fastq=True, device="cuda")`, counters zeroed just before and read just
    after.  K1 and K2 must have launched, with 0 packed spills and 0
    checksum-fallback lanes; record counts must match; reads of more than one
    segment present; ref_base checked on 200 one-segment records; the species
    share of reference bases within 5 points of the abundance file; a traced
    same-seed rerun byte-identical (idle share, device ops per batch, host
    seconds of the species assignment); then NANOSIM_TPU_RECON=0 at 2,000
    reads must equal Route A's files, with K4 launched.  Returns (launches,
    the RECON=0 run's launches, reads/s, traced reads/s, the fixture)."""
    import dataclasses

    import torch

    from nanosim_tpu_torch.io.genome import MetagenomeSet
    from nanosim_tpu_torch.profiles import profile

    t0 = time.time()
    fx = make_meta_path_fixture(d)
    print(f"metagenome fixture ({len(META_SPECIES)} species x 2 x {META_CHROM} bp) in "
          f"{time.time() - t0:.1f}s", flush=True)
    prof = profile.load_profile(fx["prefix"], mode="metagenome", chimeric=True, fastq=True)
    n_al, n_un = (x[0] for x in profile.split_aligned_unaligned([N_META], prof.aligned_rate,
                                                                False))
    out1 = os.path.join(d, "meta", "run1", "sim")
    acc = [0, 0.0]
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with timed_species_assignment(acc):
        counts = _run_meta(fx, out1, CHI_BATCH, "cuda", chimeric=True)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_counters()
    print(f"metagenome path: {counts} in {dt:.2f}s -> {N_META / dt:.1f} reads/s on {card}; "
          f"{acc[0]} batches, assign_species_batch {acc[1]:.3f}s of the host's time "
          f"({1e3 * acc[1] / max(acc[0], 1):.2f} ms a batch); launches {launches}", flush=True)
    missing = [k for k in ("aligned", "unaligned") if launches[k] == 0]
    if missing:
        fail(f"{missing} kernels were not launched on the metagenome path: {launches}")
    if launches["packed_spills"] or launches["checksum_fallback_lanes"]:
        fail(f"metagenome path: {launches['packed_spills']} packed spills, "
             f"{launches['checksum_fallback_lanes']} checksum-fallback lanes")
    pre = out1 + "_sample0"
    names = read_names(pre + "_aligned_reads.fastq")
    nu = len(read_names(pre + "_unaligned_reads.fastq"))
    if (len(names), nu) != (counts["sample0"], n_un) or counts["sample0"] != n_al:
        fail(f"read counts {(len(names), nu)} != requested {(n_al, n_un)}: {counts}")
    n_chi = sum(1 for nm in names if "_chimeric_" in nm)
    if n_chi == 0:
        fail("no chimeric read on the metagenome path")
    bases = _segment_bases_by_species(names)
    total = sum(bases.values())
    share = {sp: 100 * b / total for sp, b in bases.items()}
    print(f"metagenome path: {n_chi} of {len(names)} aligned reads have more than one "
          f"segment; reference bases by species " + ", ".join(
              f"{sp} {share[sp]:.2f}% (file {a}%)" for sp, a in zip(META_SPECIES, META_ABUN)),
          flush=True)
    for sp, a in zip(META_SPECIES, META_ABUN):
        if abs(share[sp] - a) > 5:
            fail(f"{sp}: {share[sp]:.2f}% of the bases against {a}% in the abundance file")
    # ref_base on one-segment records: the names' chromosomes are <species>-<chrom>
    mset = MetagenomeSet.from_genome_list(fx["glist"], fx["dl"])
    g = dataclasses.replace(mset.packed, names=[
        f"{mset.species_names[sp]}-{nm}" for sp, nm in zip(mset.species_of_chrom,
                                                            mset.packed.names)])
    check_error_profile(pre + "_aligned_error_profile", g)
    print("metagenome path: ref_base checked on 200 one-segment records", flush=True)

    out2 = os.path.join(d, "meta", "run2", "sim")
    from torch.profiler import ProfilerActivity, profile as tprofile

    acc2 = [0, 0.0]
    t0 = time.time()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof_t, timed_species_assignment(acc2):
        _run_meta(fx, out2, CHI_BATCH, "cuda", chimeric=True)
        torch.cuda.synchronize()
    dt2 = time.time() - t0
    if _meta_shas(out1, ("sample0",)) != _meta_shas(out2, ("sample0",)):
        fail("metagenome path: second run with the same seed differs")
    print(f"metagenome path: second run byte-identical ({N_META / dt2:.1f} reads/s, traced; "
          f"assign_species_batch {acc2[1]:.3f}s)", flush=True)
    busy, n_ops = report_trace(prof_t, dt2)
    print(f"metagenome path: {n_ops / max(acc2[0], 1):.0f} device ops per batch "
          f"({acc2[0]} batches of {CHI_BATCH}, the unaligned pass included)", flush=True)

    outs, recon0 = {}, None
    with open(fx["abun"], "w") as f:
        f.write(f"Species\t{N_META_RECON0}\n" + "".join(
            f"{sp.replace('_', ' ')}\t{a}\n" for sp, a in zip(META_SPECIES, META_ABUN)))
    for recon in ("0", None):
        out = os.path.join(d, "meta", f"recon{recon or ''}", "sim")
        zero_counters()
        with recon_env(recon):
            t0 = time.time()
            _run_meta(fx, out, CHI_BATCH, "cuda", chimeric=True)
            torch.cuda.synchronize()
            dt3 = time.time() - t0
        got = read_counters()
        if got["checksum_fallback_lanes"] != 0:
            fail(f"{got['checksum_fallback_lanes']} lanes failed the host replay's checksum")
        if recon == "0":
            recon0 = got
            if any(got[k] == 0 for k in ("gather_u8", "aligned", "unaligned")):
                fail(f"a kernel was not launched on the metagenome NANOSIM_TPU_RECON=0 run: "
                     f"{got}")
        print(f"metagenome NANOSIM_TPU_RECON={recon or 'unset'}: {N_META_RECON0} reads in "
              f"{dt3:.2f}s -> {N_META_RECON0 / dt3:.1f} reads/s on {card}; launches {got}",
              flush=True)
        outs[recon] = _meta_shas(out, ("sample0",))
    if outs["0"] != outs[None]:
        fail(f"metagenome NANOSIM_TPU_RECON=0 files differ from Route A's: {outs}")
    print("metagenome NANOSIM_TPU_RECON=0: files byte-identical to Route A", flush=True)
    return launches, recon0, N_META / dt, N_META / dt2, fx


def make_meta_path_fixture(d: str) -> dict:
    """Phase 17's fixture: the JAX package's metagenome configuration with
    one sample of N_META reads."""
    return make_meta_fixture(os.path.join(d, "meta"), [[META_CHROM] * 2] * 3, 8000, 2200, 2000,
                             CHI_SEGMENT_MEAN, (N_META,), tuple((a,) for a in META_ABUN))


# --- multi-host runs (--num_hosts) ----------------------------------------------

N_MH = 4000  # genome at the main path's model
N_MH_META = 2000  # the chimeric metagenome of phase 17
MH_RANKS = 2
MH_RANK_TIMEOUT_S = 300  # a rank that has not exited by then fails the phase

# one rank: `python -m nanosim_tpu_torch simulate ...` (the port's CLI, called
# in this process), then the seconds of the call and the kernels' launch
# counters of this process (zero at its start)
RANK_SCRIPT = """
import json, sys, time
import torch
from chip_smoke import read_counters
from nanosim_tpu_torch.__main__ import main
sys.argv = ["nanosim_tpu_torch"] + sys.argv[1:]
t0 = time.time()
main()
torch.cuda.synchronize()
print("RANK " + json.dumps({"seconds": time.time() - t0, "launches": read_counters()}))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_ranks(d: str, label: str, argv, n_ranks: int) -> list:
    """Run `simulate <argv>` through the port's CLI as n_ranks processes on
    the card, one rank each, joined at a free local port (n_ranks=1: one
    single-host process).  Fails unless every rank exits 0 within
    MH_RANK_TIMEOUT_S (the others are then killed).  Returns each rank's
    {seconds, launches}."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    for h in range(n_ranks):
        extra = (["--num_hosts", str(n_ranks), "--host_id", str(h), "--coordinator",
                  coordinator] if n_ranks > 1 else [])
        log_path = os.path.join(d, f"{label.replace(' ', '_')}_rank{h}of{n_ranks}.log")
        logs.append(log_path)
        with open(log_path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, "simulate", *argv,
                                           *extra], cwd=REPO, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.time() + MH_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [h for h, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for h, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            text = f.read()
        if h in late:
            fail(f"{label}: rank {h} of {n_ranks} had not exited after {MH_RANK_TIMEOUT_S}s:\n"
                 f"{text[-3000:]}")
        if p.returncode != 0:
            fail(f"{label}: rank {h} of {n_ranks} exited {p.returncode}:\n{text[-3000:]}")
        rank = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        if not rank:
            fail(f"{label}: rank {h} printed no result:\n{text[-3000:]}")
        results.append(json.loads(rank[-1][5:]))
    return results


def _read_index(name: bytes) -> int:
    toks = name.replace(b";", b"_").split(b"_")
    for i, t in enumerate(toks):
        if t in (b"aligned", b"unaligned", b"perfect"):
            return int(toks[i + 1])
    fail(f"no read index in {name!r}")


def _fastq_by_index(paths) -> dict:
    """{read index: (name, bases, qualities)} over FASTQ files."""
    out = {}
    for path in paths:
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        for i in range(0, len(lines) - 1, 4):
            idx = _read_index(lines[i][1:])
            if idx in out:
                fail(f"read index {idx} twice in {paths}")
            out[idx] = (lines[i][1:], lines[i + 1], lines[i + 3])
    return out


def _error_rows_by_read(paths) -> dict:
    """{read name: [rows]} over error profiles (their headers skipped)."""
    out = {}
    for path in paths:
        with open(path, "rb") as f:
            for line in f:
                if line.startswith(b"Seq_name\t"):
                    continue
                out.setdefault(line.split(b"\t", 1)[0], []).append(line)
    return out


def _merged_equal_single(label: str, single: str, shards: list, suffixes) -> int:
    """The ranks' shards of each of `suffixes` together equal the single-host
    file: FASTQ records by read index (gapless 0..n-1), error-profile rows
    grouped by read.  Returns the aligned reads' count."""
    n = 0
    for suf in suffixes:
        parts = [f"{sh}{suf.format(t=f'_h{h}')}" for h, sh in enumerate(shards)]
        whole = single + suf.format(t="")
        if suf.endswith(".fastq"):
            a, b = _fastq_by_index([whole]), _fastq_by_index(parts)
            if a != b or sorted(b) != list(range(len(b))):
                fail(f"{label}: the ranks' {suf} shards differ from the single-host run "
                     f"({len(a)} against {len(b)} records)")
            if "_aligned_reads" in suf:
                n = len(b)
        else:
            if _error_rows_by_read([whole]) != _error_rows_by_read(parts):
                fail(f"{label}: the ranks' {suf} shards differ from the single-host run")
            with open(parts[0], "rb") as f:
                if not f.readline().startswith(b"Seq_name\t"):
                    fail(f"{label}: host 0's error profile has no header")
    return n


def _capture_walks(run) -> dict:
    """Run `run()` with the walk wrappers watched: {(kind, B, E): the inputs
    of the first launch at that shape}."""
    from nanosim_tpu_torch.ops import error_walk, walk_cuda

    seen = {}
    proxy = types.SimpleNamespace(**{k: getattr(walk_cuda, k) for k in dir(walk_cuda)
                                     if not k.startswith("__")})

    def watch(kind, fn):
        def launch(*args):
            seen.setdefault((kind, args[1].shape[0], int(args[-1])), args)
            return fn(*args)
        return launch

    proxy.aligned_steps = watch("aligned", walk_cuda.aligned_steps)
    proxy.unaligned_steps = watch("unaligned", walk_cuda.unaligned_steps)
    _capture_batch(run, [(error_walk, "walk_cuda", proxy)])
    return seen


def _shape_launches(k: dict, launches: dict) -> int:
    """The launches of walk row `k` at its own (B, E) among one run's
    counters."""
    kind = "aligned" if k["name"] == "aligned_walk" else "unaligned"
    return launches[f"{kind}_by_shape"].get(f"{k['B']}x{k['E']}", 0)


def _multihost_rows(label: str, seen: dict, ranks: list) -> list:
    """A kernel row for each walk shape of a multi-host run: the kernel
    against its plain version on the inputs of its first launch at that
    shape (captured from the emulated rank 0, which runs every rank's
    shards), with the distributed ranks' launches at that shape.  Fails
    unless the ranks launched exactly the captured shapes."""
    launched = set()
    for r in ranks:
        for kind in ("aligned", "unaligned"):
            launched |= {(kind, *map(int, key.split("x")))
                         for key in r["launches"][f"{kind}_by_shape"]}
    if launched != set(seen):
        fail(f"{label}: the ranks launched the walks at {sorted(launched)}, the emulated rank 0 "
             f"at {sorted(seen)}")
    rows = []
    for kind, B, E in sorted(seen):
        row = _walk_case(kind, seen[kind, B, E], "record", label)
        row["launches_by_rank"] = [_shape_launches(row, r["launches"]) for r in ranks]
        row["launches"] = sum(row["launches_by_rank"])
        rows.append(row)
    return rows


def _rank_kernels(label: str, ranks: list, kernels) -> None:
    for h, r in enumerate(ranks):
        got = r["launches"]
        missing = [k for k in kernels if got[k] == 0]
        if missing or got["checksum_fallback_lanes"]:
            fail(f"{label}: rank {h}: {missing} not launched or checksum-fallback lanes: {got}")


def phase_multihost(d: str, prefix: str, ref: str, meta_fx: dict, card: str) -> list:
    """Phase 19: two ranks as two processes on the one card, through the
    port's CLI (`--num_hosts 2 --host_id h --coordinator 127.0.0.1:<port>`,
    a gloo process group): genome at the main path's model (N_MH reads,
    batch 2,048, FASTQ) and the chimeric metagenome of phase 17 (N_MH_META
    reads, batch 512).  Each rank must exit 0 within its time limit and
    launch K1 and K2 with 0 checksum-fallback lanes; the ranks' shards
    together must equal a single-host run of the same seed and batch (also
    through the CLI, one process).  Then rank 0 emulated in this process
    (the CLI without a coordinator) must write the distributed rank 0's
    shards, and every walk shape it launches is held against its plain
    version, with the ranks' launches at that shape; at a small size, every
    shard of the emulated ranks on the card must equal the CPU's.  Prints
    the two-rank and the one-rank reads/s (each rank's seconds in the CLI
    call; two ranks share one card).  Returns the kernel rows."""
    from nanosim_tpu_torch import cli
    from nanosim_tpu_torch.sim.run import simulate_genome

    mh = os.path.join(d, "multihost")
    os.makedirs(mh)
    abun = os.path.join(mh, "abun.tsv")
    with open(abun, "w") as f:
        f.write(f"Species\t{N_MH_META}\n" + "".join(
            f"{sp.replace('_', ' ')}\t{a}\n" for sp, a in zip(META_SPECIES, META_ABUN)))
    jobs = (
        ("multi-host genome", N_MH, BATCH,
         ["genome", "-rg", ref, "-c", prefix, "-n", str(N_MH), "--fastq", "--seed", str(SEED),
          "--batch", str(BATCH)],
         ("_aligned_reads{t}.fastq", "_aligned_error_profile{t}", "_unaligned_reads{t}.fastq"),
         ""),
        ("multi-host metagenome --chimeric", N_MH_META, CHI_BATCH,
         ["metagenome", "-gl", meta_fx["glist"], "-a", abun, "-dl", meta_fx["dl"], "-c",
          meta_fx["prefix"], "--chimeric", "--fastq", "--seed", str(SEED), "--batch",
          str(CHI_BATCH)],
         ("_aligned_reads{t}.fastq", "_aligned_error_profile{t}"), "_sample0"))
    rows = []
    for label, n, batch, argv, suffixes, sample in jobs:
        tag = label.split()[1]
        single = _cli_ranks(mh, label, argv + ["-o", os.path.join(mh, f"{tag}_1")], 1)
        ranks = _cli_ranks(mh, label, argv + ["-o", os.path.join(mh, f"{tag}_2")], MH_RANKS)
        _rank_kernels(label + " (one rank)", single, ("aligned", "unaligned"))
        _rank_kernels(label, ranks, ("aligned", "unaligned"))
        got = _merged_equal_single(label, os.path.join(mh, f"{tag}_1{sample}"),
                                   [os.path.join(mh, f"{tag}_2{sample}")] * MH_RANKS, suffixes)
        if sample:  # host 0 alone runs the metagenome's unaligned pass
            u = f"{sample}_unaligned_reads.fastq"
            if sha(os.path.join(mh, f"{tag}_1{u}")) != sha(os.path.join(mh, f"{tag}_2{u}")):
                fail(f"{label}: host 0's unaligned reads differ from the single-host run's")
        one = n / single[0]["seconds"]
        two = n / max(r["seconds"] for r in ranks)
        secs = ", ".join(f"{r['seconds']:.2f}" for r in ranks)
        print(f"{label}: {got} aligned reads in the merged shards equal the single-host run "
              f"(batch {batch}); launches by rank {[r['launches'] for r in ranks]}, one rank "
              f"{single[0]['launches']}", flush=True)
        print(f"{label} ({n} reads, batch {batch}): {MH_RANKS} ranks {two:.1f} reads/s (the "
              f"ranks' seconds in the CLI call: {secs}), one rank {one:.1f} reads/s "
              f"({single[0]['seconds']:.2f}s) on {card}; two ranks share one card: this is not "
              f"a scaling number", flush=True)
        emulated = os.path.join(mh, f"{tag}_emulated")
        seen = _capture_walks(lambda: cli.main(argv + ["-o", emulated, "--num_hosts",
                                                       str(MH_RANKS), "--host_id", "0"]))
        for suf in suffixes:
            name = sample + suf.format(t="_h0")
            if sha(os.path.join(mh, f"{tag}_2{name}")) != sha(emulated + name):
                fail(f"{label}: the emulated rank 0's {name} differs from the distributed one's")
        print(f"{label}: rank 0 emulated in one process wrote the distributed rank 0's shards; "
              f"walk shapes {sorted(seen)}", flush=True)
        rows += _multihost_rows(label, seen, ranks)

    # the emulated ranks on the card against the CPU at a small size
    sprefix, sref = make_fixture(os.path.join(mh, "small"), 0.4, 700, 250, 300)
    sfx = make_meta_fixture(os.path.join(mh, "meta_small"), [[150000], [100000, 40000], [120000]],
                            700, 250, 300, 1.9, (150, 100), ((60, 20), (30, 50), (10, 30)))
    for label, run, files in (
            ("genome", lambda o, dev, h: simulate_genome(
                sref, sprefix, o, 200, fastq=True, seed=SEED, batch=64, n_hosts=MH_RANKS,
                host_id=h, device=dev),
             [f + "_h{h}" + e for f, e in (("_aligned_reads", ".fastq"),
                                            ("_aligned_error_profile", ""),
                                            ("_unaligned_reads", ".fastq"))]),
            ("metagenome --chimeric", lambda o, dev, h: _run_meta(
                sfx, o, 64, dev, chimeric=True, n_hosts=MH_RANKS, host_id=h),
             [f"_{s}{f}" + "_h{h}" + e for s in ("sample0", "sample1")
              for f, e in (("_aligned_reads", ".fastq"), ("_aligned_error_profile", ""))]
             + [f"_{s}_unaligned_reads.fastq" for s in ("sample0", "sample1")])):
        shas = {}
        for dev in ("cpu", "cuda"):
            o = os.path.join(mh, "small_runs", label.split()[0], dev, "sim")
            os.makedirs(os.path.dirname(o), exist_ok=True)
            for h in range(MH_RANKS):
                run(o, dev, h)
            shas[dev] = [sha(o + f.format(h=h)) for h in range(MH_RANKS) for f in files
                         if "{h}" in f or h == 0]
        if shas["cpu"] != shas["cuda"]:
            fail(f"small multi-host {label} run: the card's shards differ from the CPU's")
        print(f"small multi-host {label} run ({MH_RANKS} emulated ranks): every shard on the "
              f"card byte-identical to the CPU's", flush=True)
    return rows


# --- phase 21: the model-fitting commands (characterize, quantify, quantify_paf) ---

N_CHAR = 2000  # aligned reads the genome model is refitted on (and simulated from)
N_CHAR_UNALIGNED = 200
CHAR_RATE_TOLERANCE = 0.05  # the refit's error rates against the reads' own
CHAR_GENOME_FILES = (
    "_aligned_region.pkl", "_aligned_reads.pkl", "_ht_length.pkl", "_ht_ratio.pkl",
    "_unaligned_length.pkl", "_strandness_rate", "_reads_alignment_rate", "_match.hist",
    "_mis.hist", "_ins.hist", "_del.hist", "_error_rate.tsv", "_error_markov_model",
    "_first_match.hist", "_match_markov_model", "_model_profile",
    "_base_qualities_model_parameters.tsv")


def simulate_with_truth(d: str, ref: str, prefix: str, n: int, n_unaligned: int,
                        batch: int = BATCH, device: str = "cuda"):
    """Reads simulated on the card (aligned and unaligned, one FASTQ file)
    and the alignment SAM built from the simulator's own error log:
    (reads, SAM, error log)."""
    from nanosim_tpu_torch.io.fastx import mangle_name, read_fastx
    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures, profile
    from nanosim_tpu_torch.sim import output
    from nanosim_tpu_torch.sim.genome_mode import GenomeSimulator
    from nanosim_tpu_torch.sim.unaligned_mode import UnalignedBatchWriter, UnalignedSimulator

    os.makedirs(d, exist_ok=True)
    genome = PackedGenome.from_fasta(ref)
    prof = profile.load_profile(prefix, mode="genome", fastq=True)
    al, un, err = (os.path.join(d, s) for s in ("aligned.fastq", "unaligned.fastq", "errors"))
    fw, el = output.FastxWriter(al, True), output.ErrorLogWriter(err)
    GenomeSimulator(genome, prof, fastq=True, batch=batch, device=device).run(
        n, output.GenomeBatchWriter(fw, el), seed=SEED)
    fw.close()
    el.close()
    ufw = output.FastxWriter(un, True)
    UnalignedSimulator(genome, prof, fastq=True, batch=batch, device=device).run(
        n_unaligned, UnalignedBatchWriter(ufw), seed=SEED)
    ufw.close()
    records = list(read_fastx(al)) + list(read_fastx(un))
    errors = {}
    with open(err) as f:
        for line in f:
            nm, key, et, elen, rb, sb = line.rstrip("\n").split("\t")
            errors.setdefault(nm, []).append((int(key), et, int(elen), rb, sb))
    reads, sam = os.path.join(d, "reads.fastq"), os.path.join(d, "truth.sam")
    with open(reads, "w") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    raw = {mangle_name(name): name for name, _, _ in read_fastx(ref)}
    fixtures.build_sam_from_ground_truth(genome, records, errors, sam, raw)
    return reads, sam, err


def truth_error_rates(reads: str, err: str) -> dict:
    """The error rates of the reads' own error log, as the characterization
    writes them: mismatched, inserted and deleted bases over the reference
    bases the reads align to."""
    ref_bases = 0
    with open(reads) as f:
        for i, line in enumerate(f):
            if i % 4 == 0 and "_aligned_" in line:
                ref_bases += int(line.split("_")[-2])
    bases = {"mis": 0, "ins": 0, "del": 0}
    with open(err) as f:
        for line in f:
            fields = line.split("\t")
            bases[fields[2]] += int(fields[3])
    return {"Mismatch rate": bases["mis"] / ref_bases, "Insertion rate": bases["ins"] / ref_bases,
            "Deletion rate": bases["del"] / ref_bases}


def run_cli(label: str, argv, timeout: int = 600) -> float:
    """`python -m nanosim_tpu_torch <argv>` as a process of its own: it
    must exit 0; returns its seconds."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "nanosim_tpu_torch", *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    dt = time.time() - t0
    if res.returncode != 0:
        fail(f"{label}: exit {res.returncode}: {res.stderr[-3000:]}")
    print(f"{label}: exit 0 in {dt:.1f}s", flush=True)
    return dt


def phase_characterize(d: str, prefix: str, ref: str, card: str, full: bool = True,
                       device: str = "cuda"):
    """Phase 21: the model-fitting commands through the port's CLI, as
    processes of their own.  `full`: 2,000 reads simulated on the card with
    the main path's model, `characterize genome --fastq` on them (every
    model file written, its error rates within 5% of the reads' own), and
    2,000 reads simulated on the card from the refit (K1 and K2 launched, 0
    checksum-fallback lanes, ref_base checked).  Then, at a small size,
    every other command: transcriptome (intron retention, -q), metagenome
    (-c -q), quantify (-e trans, -e meta), detect_ir and quantify_paf; each
    refit loads with the port's load_profile for its mode."""
    import torch

    from nanosim_tpu_torch.io.genome import PackedGenome
    from nanosim_tpu_torch.profiles import fixtures, profile

    base = os.path.join(d, "characterize")
    if full:
        t0 = time.time()
        gd = os.path.join(base, "genome")
        reads, sam, err = simulate_with_truth(gd, ref, prefix, N_CHAR, N_CHAR_UNALIGNED)
        print(f"characterize genome: {N_CHAR} + {N_CHAR_UNALIGNED} reads simulated and their "
              f"SAM written in {time.time() - t0:.1f}s", flush=True)
        refit = os.path.join(gd, "refit")
        secs = run_cli("characterize genome --fastq", [
            "characterize", "genome", "--fastq", "-i", reads, "-rg", ref, "-ga", sam,
            "-o", refit])
        missing = [s for s in CHAR_GENOME_FILES if not os.path.exists(refit + s)]
        if missing:
            fail(f"characterize genome wrote no {missing}")
        want = truth_error_rates(reads, err)
        got = {}
        with open(refit + "_error_rate.tsv") as f:
            for line in f:
                key, value = line.rstrip("\n").split(":\t")
                got[key] = float(value)
        off = {k: got[k] / want[k] - 1 for k in want}
        print(f"characterize genome: {secs:.1f}s for {N_CHAR + N_CHAR_UNALIGNED} reads; error "
              "rates refit / reads' own: " + ", ".join(
                  f"{k} {got[k]:.5f} / {want[k]:.5f}" for k in want), flush=True)
        if any(abs(x) > CHAR_RATE_TOLERANCE for x in off.values()):
            fail(f"the refit's error rates are off by more than {CHAR_RATE_TOLERANCE:.0%}: {off}")
        profile.load_profile(refit, mode="genome", fastq=True)
        out = os.path.join(gd, "sim")
        zero_counters()
        t0 = time.time()
        counts = _run_sim(ref, refit, out, N_CHAR, BATCH, True, "cuda")
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = read_counters()
        print(f"simulate genome -c <refit>: {counts} in {dt:.2f}s -> {N_CHAR / dt:.1f} reads/s "
              f"on {card}; launches {launches}", flush=True)
        if launches["aligned"] == 0 or launches["unaligned"] == 0:
            fail(f"simulating from the refit launched no walk: {launches}")
        if launches["checksum_fallback_lanes"] != 0:
            fail(f"{launches['checksum_fallback_lanes']} lanes failed the host replay's checksum")
        names = read_names(out + "_aligned_reads.fastq")
        if len(names) != counts["aligned"]:
            fail(f"{len(names)} aligned records, {counts['aligned']} requested")
        check_error_profile(out + "_aligned_error_profile", PackedGenome.from_fasta(ref))
        print("simulate genome -c <refit>: ref_base checked", flush=True)

    # the small commands: a synthetic annotated transcriptome with spliced
    # alignments, and two species simulated on the card
    t0 = time.time()
    (genome_fa, trx_fa, annot, trx_reads, g_sam,
     t_sam) = fixtures.make_transcriptome_alignments(os.path.join(base, "trx"))
    refit = os.path.join(base, "trx", "refit")
    run_cli("characterize transcriptome (intron retention, -q)", [
        "characterize", "transcriptome", "-i", trx_reads, "-rg", genome_fa, "-rt", trx_fa,
        "-annot", annot, "-ga", g_sam, "-ta", t_sam, "-o", refit, "-q", "--fastq"])
    profile.load_profile(refit, mode="transcriptome", model_ir=True, fastq=True)
    if not os.path.exists(refit + "_transcriptome_quantification.tsv"):
        fail("characterize transcriptome -q wrote no quantification")

    md = os.path.join(base, "meta")
    os.makedirs(md)
    small_prefix = os.path.join(md, "model")
    fixtures.make_model_dir(small_prefix, mean_read_len=800, sd_read_len=250)
    combined, glist = os.path.join(md, "combined.fa"), os.path.join(md, "genome_list.tsv")
    with open(combined, "w") as comb, open(glist, "w") as gl:
        for sp, lens, seed in (("Alpha", [40000, 15000], 31), ("Beta coli", [30000], 32)):
            fa = os.path.join(md, sp.replace(" ", "_") + ".fa")
            fixtures.make_reference_fasta(fa, lens, seed=seed, name_prefix=f"s{seed}c")
            gl.write(f"{sp}\t{fa}\t{60 if sp == 'Alpha' else 40}\n")
            with open(fa) as f:
                for line in f:
                    comb.write(f">{sp.replace(' ', '_')}_{line[1:]}" if line[0] == ">" else line)
    meta_reads, meta_truth, _ = simulate_with_truth(md, combined, small_prefix, 300, 30, batch=64,
                                                    device=device)
    meta_sam = os.path.join(md, "chimeric.sam")
    fixtures.add_chimeric_pairs(meta_truth, meta_sam, 30)
    refit = os.path.join(md, "refit")
    run_cli("characterize metagenome -c -q", [
        "characterize", "metagenome", "-i", meta_reads, "-gl", glist, "-ga", meta_sam,
        "-o", refit, "-c", "-q", "--fastq"])
    profile.load_profile(refit, mode="metagenome", chimeric=True, fastq=True)

    qd = os.path.join(base, "quantify")
    os.makedirs(qd)
    run_cli("characterize quantify -e trans", [
        "characterize", "quantify", "-e", "trans", "-i", trx_reads, "-ta", t_sam,
        "-o", os.path.join(qd, "trans")])
    run_cli("characterize quantify -e meta", [
        "characterize", "quantify", "-e", "meta", "-i", meta_reads, "-gl", glist,
        "-ga", meta_sam, "-o", os.path.join(qd, "meta")])
    run_cli("characterize detect_ir", [
        "characterize", "detect_ir", "-annot", annot, "-ga", g_sam, "-ta", t_sam,
        "-o", os.path.join(qd, "ir")])
    for path in ("trans_quantification.tsv", "meta_quantification.tsv", "ir_IR_markov_model",
                 "ir_IR_info"):
        if not os.path.exists(os.path.join(qd, path)):
            fail(f"the quantify / detect_ir commands wrote no {path}")
    paf, abun = os.path.join(qd, "aln.paf"), os.path.join(qd, "abundance.tsv")
    with open(paf, "w") as f:
        f.write("r1\t500\t0\t480\t+\tT1\t1000\t5\t490\t450\t500\t60\n"
                "r2\t400\t0\t380\t+\tT1\t1000\t2\t400\t370\t400\t60\n"
                "r3\t300\t0\t290\t+\tT2\t800\t3\t300\t280\t300\t60\n")
    run_cli("quantify_paf", ["quantify_paf", "-i", paf, "-o", abun])
    with open(abun) as f:
        tpm = {row.split("\t")[0]: float(row.split("\t")[2]) for row in f.read().split("\n")[1:]
               if row}
    if abs(tpm["T1"] - 2e6 / 3) > 1e3 or abs(tpm["T2"] - 1e6 / 3) > 1e3:
        fail(f"quantify_paf: {tpm}, not two thirds and one third of a million")
    print(f"characterize: the small commands passed in {time.time() - t0:.1f}s (no sklearn or "
          "joblib needed)", flush=True)


def report_trace(prof, wall_s: float):
    """Device busy time (sum of kernel and copy self times on the one stream
    in use) against the run's wall time, and the top device consumers.
    Returns (busy seconds, device ops)."""
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
    return busy_s, sum(r[1] for r in rows)


def _path_launches(k: dict, launches: dict) -> int:
    """The launches of kernel row `k` among one path's counters."""
    name = k["name"]
    if name == "unaligned_walk":
        return launches["unaligned"]
    if name == "aligned_walk":
        return launches["aligned_by_budget"].get(k["E"], 0)
    if name == "gather_codes":
        return launches["gather"]
    if name.startswith("gather_u8"):  # per element width
        return launches["gather_u8_by_width"].get(k["elem_bytes"], 0)
    return launches["assemble"]


def _launches_by_name(k: dict, launches: dict) -> int:
    """The launches of kernel row `k`'s kernel among one path's counters, at
    every shape (K4: at its element width)."""
    name = k["name"]
    if name == "aligned_walk":
        return launches["aligned"]
    return _path_launches(k, launches)


def attach_launches(cases, by_path: dict, recon0_of: dict, trx_paths: dict, meta_of=None):
    """Give every kernel row of a path its launches on that path's run (and
    on the RECON=0 run beside it); fail for a recorded row whose kernel that
    run did not launch at its shape.  `meta_of` maps a path whose shapes
    another run shares to {key: (that run's label, its launches)}: the
    metagenome's Route A has the chimeric path's shapes, its RECON=0 run the
    chimeric circular path's, and the -med/-sd path the main path's."""
    for k in cases:
        if not k["role"]:
            continue
        k["launches"] = _path_launches(k, by_path[k["path"]])
        if k["path"] in recon0_of:  # the RECON=0 run beside it
            k["launches_recon0"] = _path_launches(k, recon0_of[k["path"]])
        if k["role"] == "record" and k["launches"] == 0:
            fail(f"{k['name']} was not launched on the {k['path']} path")
        for key, (label, got) in (meta_of or {}).get(k["path"], {}).items():
            k[key] = _path_launches(k, got)
            if k["role"] == "record" and k[key] == 0:
                fail(f"{k['name']} was not launched at its {k['path']} shape on the "
                     f"{label} path ({key})")
        if k["path"] in trx_paths:
            # every transcriptome path's launches of this kernel, at any shape
            k["launches_by_transcriptome_path"] = {
                label: _launches_by_name(k, got) for label, got in trx_paths.items()}


def attach_exact_conditional(rows, launches: dict):
    """The exact conditional's aligned pass (phase 20) launches K1 at the
    transcriptome path's shape and at no other: its launches go on that
    row."""
    (k,) = [k for k in rows if k["role"] == "record" and k["path"] == "transcriptome"
            and k["name"] == "aligned_walk"]
    k["launches_exact_conditional"] = _shape_launches(k, launches)
    if k["launches_exact_conditional"] != launches["aligned"] or launches["unaligned"]:
        fail(f"the exact conditional's aligned pass launched the walks at "
             f"{launches['aligned_by_shape']} and {launches['unaligned_by_shape']}, not only "
             f"K1 at B={k['B']} E={k['E']}")


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--quick", action="store_true",
                    help="a check of the newest slice only (builds, the small "
                         "characterization commands); without it every phase runs")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernels only (builds, then K1-K5 at every path's shapes against "
                         "their plain versions, timed), driving no path")
    ap.add_argument("--experiments", action="store_true",
                    help="the measuring kernels only (builds, the walk experiments K6 and K7 "
                         "and the windowed-gather experiment K8), driving no path")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(REPO, "nanosim_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository "
             "(nanosim_tpu_torch/ is missing)")
    sys.path.insert(0, REPO)
    t_start = time.time()
    card, kind, count = phase_card()
    phase_build()
    from nanosim_tpu_torch.profiles import error_model, fixtures

    tmp_root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        if args.quick:
            phase_characterize(d, None, None, card, full=False)
            print(json.dumps({"ok": True, "quick": True, "seconds": time.time() - t_start,
                              "device": {"platform": "gpu", "kind": kind, "count": count}}))
            return
        t0 = time.time()
        if args.experiments:
            prefix, ref = make_fixture(os.path.join(d, "bench"), GENOME_MB, 8000, 2200, 2000)
            error_model.write_chimeric_info(prefix + "_chimeric_info", CHI_SEGMENT_MEAN, 0.2)
            rows = phase_experiments(prefix, ref, card) + phase_gather_window(card)
            print(json.dumps({"kernels": [{key: v for key, v in k.items() if key != "role"}
                                          for k in rows]}))
            print(json.dumps({"ok": True, "experiments_only": True,
                              "seconds": time.time() - t_start,
                              "device": {"platform": "gpu", "kind": kind, "count": count}}))
            return
        if args.kernels:
            fx = make_trx_fixtures(os.path.join(d, "trx"), N_TRX, N_IR_TRX, IR_GENOME,
                                   long_exons=IR_LONG_EXONS)
            print(f"transcriptome fixture in {time.time() - t0:.1f}s", flush=True)
            rows = phase_trx_kernels(fx)
        prefix, ref = make_fixture(os.path.join(d, "bench"), GENOME_MB, 8000, 2200, 2000)
        error_model.write_chimeric_info(prefix + "_chimeric_info", CHI_SEGMENT_MEAN, 0.2)
        circ_ref = os.path.join(d, "bench", "circ.fa")
        fixtures.make_reference_fasta(circ_ref, [CIRC_LEN], seed=13, with_iupac=True)
        print(f"fixture ({GENOME_MB} Mb genome, {CIRC_LEN} bp circular chromosome) in "
              f"{time.time() - t0:.1f}s", flush=True)
        cases = (phase_kernels(prefix, ref) + phase_draw_kernels()
                 + phase_gather(prefix, circ_ref)
                 + phase_hp_kernels(prefix, circ_ref)
                 + phase_chimeric_kernels(prefix, ref, circ_ref))
        if args.kernels:
            print(json.dumps({"kernels": [{key: v for key, v in k.items() if key != "role"}
                                          for k in rows + cases]}))
            print(json.dumps({"ok": True, "kernels_only": True,
                              "seconds": time.time() - t_start,
                              "device": {"platform": "gpu", "kind": kind, "count": count}}))
            return
        experiments = phase_experiments(prefix, ref, card)
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
        chi_l, chrate1, chrate2 = phase_path(
            "chimeric", d, prefix, ref, N_CHI, card, "linear", ("aligned", "unaligned"),
            batch=CHI_BATCH, chimeric=True)
        chic_l, chcrate, _ = phase_path(
            "chimeric circular", d, prefix, circ_ref, N_CHI_CIRC, card, "circular",
            ("aligned", "unaligned", "gather_u8"), traced_rerun=False, batch=CHI_BATCH,
            chimeric=True)
        chi_recon0_l = phase_recon0(d, prefix, ref, card, n=N_CHI_RECON0, chimeric=True,
                                    batch=CHI_BATCH)
        chih_l, chhrate, _ = phase_path(
            "chimeric -hp", d, prefix, circ_ref, N_CHI_HP, card, "circular",
            ("aligned", "unaligned", "gather_u8"), kmer_bias=HP_K, traced_rerun=False,
            batch=CHI_BATCH, chimeric=True)
        trx_rows, trx_paths, trx_rates = run_trx_slice(d, card)
        cases += trx_rows
        experiments += phase_gather_window(card)
        phase_meta_cuda_vs_cpu(d)
        meta_l, meta_recon0_l, mrate1, mrate2, meta_fx = phase_metagenome_path(d, card)
        ln_l, lrate1, lrate2 = phase_path(
            "-med/-sd", d, prefix, ref, N_READS, card, "linear", ("aligned", "unaligned"),
            median_len=LN_MEDIAN, sd_len=LN_SD)
        t_mh = time.time()
        mh_rows = phase_multihost(d, prefix, ref, meta_fx, card)
        print(f"multi-host phase in {time.time() - t_mh:.1f}s", flush=True)
        t_ch = time.time()
        phase_characterize(d, prefix, ref, card)
        print(f"characterize phase in {time.time() - t_ch:.1f}s", flush=True)
    if chi_l["packed_spills"] != 0:
        fail(f"{chi_l['packed_spills']} chimeric batches spilled their packed walk lanes")
    by_path = {"main": main_l, "circular": circ_l, "-hp": hp_l, "chimeric": chi_l,
               "chimeric circular": chic_l, "chimeric -hp": chih_l, **trx_paths}
    recon0_of = {"circular": recon0_l, "-hp": hp_recon0_l, "chimeric circular": chi_recon0_l}
    meta_of = {"chimeric": {"launches_metagenome": ("metagenome", meta_l)},
               "chimeric circular": {"launches_metagenome_recon0": ("metagenome RECON=0",
                                                                   meta_recon0_l)},
               "main": {"launches_lognormal": ("-med/-sd", ln_l)}}
    attach_launches(cases, by_path, recon0_of, trx_paths, meta_of)
    attach_exact_conditional(cases, trx_paths["exact conditional"])
    cases += mh_rows + experiments
    print(f"main path reads/s: {rate1:.1f}, {rate2:.1f} traced; circular path reads/s: "
          f"{crate1:.1f}, {crate2:.1f} traced; -hp path reads/s: {hrate1:.1f}, {hrate2:.1f} "
          f"traced; -hp on the host-reconstruction route: {harate:.1f} reads/s, "
          f"{hpa_l['overflow_rescue_lanes']} rescue and {hpa_l['checksum_fallback_lanes']} "
          f"checksum-fallback lanes ({card})", flush=True)
    print(f"chimeric path reads/s (batch {CHI_BATCH}): {chrate1:.1f}, {chrate2:.1f} traced, "
          f"{chi_l['packed_spills']} packed spills; chimeric circular (device-materialized): "
          f"{chcrate:.1f}; chimeric -hp: {chhrate:.1f}; all phases in "
          f"{time.time() - t_start:.1f}s ({card})", flush=True)
    print("transcriptome paths reads/s ({}): {}".format(card, ", ".join(
        f"{label} {r1:.1f}" + (f" ({r2:.1f} traced)" if r2 else "")
        for label, (r1, r2) in trx_rates.items())), flush=True)
    print(f"metagenome path reads/s (batch {CHI_BATCH}, --chimeric): {mrate1:.1f}, "
          f"{mrate2:.1f} traced ({card})", flush=True)
    print(f"-med {LN_MEDIAN} -sd {LN_SD} path reads/s: {lrate1:.1f}, {lrate2:.1f} traced ({card})",
          flush=True)
    print(json.dumps({"kernel_cases": [k for k in cases if k["role"] != "record"]}))
    print(json.dumps({"kernels": [{key: v for key, v in k.items() if key != "role"}
                                  for k in cases if k["role"] == "record"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
