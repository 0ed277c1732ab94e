"""ctypes bridge to the C++ output formatters.

Two libraries, each compiled with g++ on first use into this package's own
build directory.  The writer, csrc/recon_emit.cpp, includes the shared
writer native/fastwriter.cpp where it lies in the repository (it is shared
with the JAX package and not copied) and adds this package's emitters of
Route A's reads; the other is this package's composer of the `-hp`
ground-truth log, csrc/prehp_log.cpp.  `get_lib` returns None if either
fails to compile; the simulators then refuse to run (the host reconstruction
and the `-hp` log need them).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

from .. import tracing

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "recon_emit.cpp")
_SHARED_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "fastwriter.cpp")
_LOG_SRC = os.path.join(_PKG_DIR, "csrc", "prehp_log.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "librecon_emit.so")
_LOG_LIB = os.path.join(_BUILD_DIR, "libprehp_log.so")

_lib = None
_log_lib = None
_tried = False

# threads of the C++ replays and emitters; the bytes do not depend on it
EMIT_THREADS = min(4, os.cpu_count() or 1)

_P = ctypes.POINTER
_I64P = _P(ctypes.c_int64)
# compose_prehp_log's parameters, in order (csrc/prehp_log.cpp)
_LOG_ARGTYPES = [
    ctypes.c_int64, _I64P, ctypes.c_int64,  # k, lanes, lanes in the batch
    ctypes.c_char_p, _I64P,  # names, name offsets
    _P(ctypes.c_uint32), ctypes.c_int64, _I64P, _I64P,  # events, words, offsets, counts
    _P(ctypes.c_uint8), ctypes.c_int64, _I64P, _I64P,  # middles, bytes, offsets, lengths
    _I64P, _I64P,  # chrom, pos
    _P(ctypes.c_uint8), ctypes.c_int64, _I64P, _I64P, _P(ctypes.c_uint8),
    ctypes.c_int64,  # genome flat, its length, offsets, lengths, circular, chromosomes
    _P(ctypes.c_char), ctypes.c_int64, _I64P, _I64P,  # out, capacity, written, logged
    ctypes.c_int32,  # threads
]


def _build(src: str, lib: str, *included: str) -> bool:
    """Compile `src` into `lib` unless `lib` is newer than it and than every
    file it includes."""
    try:
        if os.path.exists(lib) and all(os.path.getmtime(lib) >= os.path.getmtime(f)
                                       for f in (src, *included)):
            return True
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # per-process temporary: concurrent first uses (test workers) must
        # not interleave their outputs
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", src, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            print(os.path.basename(src), "build failed:", res.stderr[-500:], file=sys.stderr)
            return False
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        print(os.path.basename(src), "build error:", e, file=sys.stderr)
        return False


def get_lib():
    """The writer's library, after building and loading both libraries
    (None if either fails)."""
    global _lib, _log_lib, _tried
    if _lib is None and not _tried:
        _tried = True
        if _build(_SRC, _LIB, _SHARED_SRC) and _build(_LOG_SRC, _LOG_LIB):
            lib = ctypes.CDLL(_LIB)
            for name in ("replay_walk_batch", "emit_batch_recon", "emit_batch_flat",
                         "replay_unaligned_walk_batch", "emit_batch_recon_unaligned",
                         "emit_batch_recon_hp", "emit_chimeric_recon",
                         "emit_chimeric_batch", "emit_batch", "emit_trx_recon",
                         "recon_emit_aligned", "recon_emit_unaligned", "recon_emit_chimeric",
                         "recon_emit_qual_counts"):
                getattr(lib, name).restype = ctypes.c_int64
            log_lib = ctypes.CDLL(_LOG_LIB)
            log_lib.compose_prehp_log.argtypes = _LOG_ARGTYPES
            log_lib.compose_prehp_log.restype = ctypes.c_int64
            _lib, _log_lib = lib, log_lib
    return _lib


class PerfectReplayer:
    """Stand-in replayer for --perfect reads (simulator.py:1316-1345 `per`
    branch): no error walk ran, so every accepted lane must carry zero
    events (empty-prefix checksum 0).  `replay` verifies that and writes
    nothing; the reconstruction spec then degenerates to extraction +
    IUPAC resolution + strand."""

    available = True

    def replay(self, slots, lane_do, m_ref, n_events, checksums, ev_out,
               ev_off, part_ids=None):
        return (np.asarray(n_events) == 0) & (np.asarray(checksums) == 0)


class WalkReplayer:
    """Host-side replay of the aligned-read error walk (C++).

    Regenerates each accepted lane's event list from (seed, slot) with a
    bit-identical threefry stream and the same inverse-CDF tables the device
    uses, then verifies against the device's per-lane checksum.  Lanes that
    fail verification (possible only through cross-platform f32 arithmetic
    corner cases in the ECDF inversion) are reported so the caller can
    re-fetch their events from the device.
    """

    def __init__(self, profile, seed: int, stream: int, site_walk: int, e_guard: int):
        from ..ops import tables as dev_tables
        from ..profiles.ecdf import exact_breakpoints

        self.lib = get_lib()
        self.seed = seed
        self.stream = stream
        self.site_walk = site_walk
        self.e_guard = e_guard

        f32 = lambda a: np.ascontiguousarray(a, np.float32)
        i32 = lambda a: np.ascontiguousarray(a, np.int32)

        def ecdf_blob(t):
            breaks, vals, n_bk = exact_breakpoints(t)
            return (i32(t.bin_lo), f32(breaks), i32(vals), i32(n_bk),
                    breaks.shape[0], breaks.shape[1])

        self.fm = ecdf_blob(profile.first_match)
        self.mm = ecdf_blob(profile.match_markov)
        p = profile.mix_params
        n_max = 1024
        self.mix = f32(np.stack([
            dev_tables._pois_geom_cdf(p.mis[0], p.mis[2], p.mis[3], n_max),
            dev_tables._wei_geom_cdf(p.ins[0], p.ins[1], p.ins[2], p.ins[3], n_max),
            dev_tables._wei_geom_cdf(p.dele[0], p.dele[1], p.dele[2], p.dele[3], n_max),
        ]))
        self.mix_n = n_max
        self.trans = f32(np.cumsum(profile.trans_error, axis=1))

    @property
    def available(self) -> bool:
        return self.lib is not None

    def replay(self, slots, lane_do, m_ref, n_events, checksums, ev_out, ev_off,
               part_ids=None):
        """Fill ev_out (uint32 flat buffer) at ev_off word offsets for lanes
        with lane_do set; returns ok[B] bool (verified lanes).  part_ids
        (optional [B]) selects per-(slot, part) streams (chimeric
        segments)."""
        B = len(slots)
        ok = np.zeros(B, np.uint8)
        fm = self.fm
        mm = self.mm
        parts_ptr = (
            _ptr(np.ascontiguousarray(part_ids, np.int64), ctypes.c_int64)
            if part_ids is not None else None
        )
        self.lib.replay_walk_batch(
            ctypes.c_int64(self.seed), ctypes.c_int64(self.stream),
            ctypes.c_int64(self.site_walk), ctypes.c_int64(B),
            _ptr(np.ascontiguousarray(slots, np.int64), ctypes.c_int64),
            parts_ptr,
            _ptr(np.ascontiguousarray(lane_do, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(m_ref, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(n_events, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(checksums, np.uint32), ctypes.c_uint32),
            _ptr(fm[0], ctypes.c_int32), _ptr(fm[1], ctypes.c_float),
            _ptr(fm[2], ctypes.c_int32), _ptr(fm[3], ctypes.c_int32),
            ctypes.c_int64(fm[4]), ctypes.c_int64(fm[5]),
            _ptr(mm[0], ctypes.c_int32), _ptr(mm[1], ctypes.c_float),
            _ptr(mm[2], ctypes.c_int32), _ptr(mm[3], ctypes.c_int32),
            ctypes.c_int64(mm[4]), ctypes.c_int64(mm[5]),
            _ptr(self.mix, ctypes.c_float), ctypes.c_int64(self.mix_n),
            _ptr(self.trans, ctypes.c_float),
            _ptr(ev_out, ctypes.c_uint32),
            _ptr(np.ascontiguousarray(ev_off, np.int64), ctypes.c_int64),
            ctypes.c_int64(self.e_guard),
            _ptr(ok, ctypes.c_uint8),
            ctypes.c_int32(EMIT_THREADS),
        )
        return ok.astype(bool)


class UnalignedWalkReplayer:
    """Host-side replay of the UNALIGNED error walk (C++): per-step
    fixed-probability type draws + mixture lengths, verified against the
    device's per-lane checksum.  Same .replay() interface as WalkReplayer so
    CompactFetcher can use either."""

    def __init__(self, profile, seed: int, stream: int, site_walk: int, e_guard: int):
        from ..ops import tables as dev_tables

        self.lib = get_lib()
        self.seed = seed
        self.stream = stream
        self.site_walk = site_walk
        self.e_guard = e_guard
        p = profile.mix_params
        n_max = 1024
        self.mix = np.ascontiguousarray(np.stack([
            dev_tables._pois_geom_cdf(p.mis[0], p.mis[2], p.mis[3], n_max),
            dev_tables._wei_geom_cdf(p.ins[0], p.ins[1], p.ins[2], p.ins[3], n_max),
            dev_tables._wei_geom_cdf(p.dele[0], p.dele[1], p.dele[2], p.dele[3], n_max),
        ]), np.float32)
        self.mix_n = n_max

    @property
    def available(self) -> bool:
        return self.lib is not None

    def replay(self, slots, lane_do, m_ref, n_steps, checksums, ev_out, ev_off,
               part_ids=None):
        B = len(slots)
        ok = np.zeros(B, np.uint8)
        parts_ptr = (
            _ptr(np.ascontiguousarray(part_ids, np.int64), ctypes.c_int64)
            if part_ids is not None else None
        )
        self.lib.replay_unaligned_walk_batch(
            ctypes.c_int64(self.seed), ctypes.c_int64(self.stream),
            ctypes.c_int64(self.site_walk), ctypes.c_int64(B),
            _ptr(np.ascontiguousarray(slots, np.int64), ctypes.c_int64),
            parts_ptr,
            _ptr(np.ascontiguousarray(lane_do, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(m_ref, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(n_steps, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(checksums, np.uint32), ctypes.c_uint32),
            _ptr(self.mix, ctypes.c_float), ctypes.c_int64(self.mix_n),
            _ptr(ev_out, ctypes.c_uint32),
            _ptr(np.ascontiguousarray(ev_off, np.int64), ctypes.c_int64),
            ctypes.c_int64(self.e_guard),
            _ptr(ok, ctypes.c_uint8),
            ctypes.c_int32(EMIT_THREADS),
        )
        return ok.astype(bool)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _count_quals(fastq: bool, bases, steps) -> None:
    """Count a csrc/recon_emit.cpp emitter's out-counters: the quality bytes
    its lookup wrote, and the steps its walk took past a bucket's start."""
    if fastq:
        tracing.count("emit.qual.bases", bases.value)
        tracing.count("emit.qual.walk_steps", steps.value)


class NativeEmitter:
    """Batch formatter: accepted reads -> FASTA/FASTQ bytes + error-log bytes."""

    def __init__(self):
        self.lib = get_lib()
        self._log_lib = _log_lib
        self._fastx_buf = np.empty(8 << 20, np.uint8)
        self._err_buf = np.empty(8 << 20, np.uint8)
        self._mid_buf = np.empty(1 << 20, np.uint8)

    @property
    def available(self) -> bool:
        return self.lib is not None

    def prehp_log(self, cb, lanes, names: list, genome):
        """The pre-resize ground-truth log of a device-materialized `-hp`
        batch (csrc/prehp_log.cpp; sim/output.event_read_positions and
        _prehp_log_rows are its spec): the rows of `lanes` (indices into the
        compact batch `cb`, emission order, named by `names`), each lane's
        in reverse event order.

        Returns (a memoryview of the rows in the emitter's error-log buffer,
        valid until the next call on this emitter; the number of lanes that
        wrote a row)."""
        k = len(lanes)
        names_packed, name_off, _ = self._pack_names(names)
        i64 = lambda a: np.ascontiguousarray(a, np.int64)
        lanes = i64(lanes)
        ev_flat = np.ascontiguousarray(cb.ev_flat, np.uint32)
        prehp_flat = np.ascontiguousarray(cb.prehp_flat, np.uint8)
        ev_off, n_events, prehp_off, prehp_len, chrom, pos = (
            i64(a) for a in (cb.ev_off, cb.n_events, cb.prehp_off, cb.prehp_len, cb.chrom, cb.pos))
        flat = np.ascontiguousarray(genome.flat, np.uint8)
        g_offsets, g_lengths = i64(genome.offsets), i64(genome.lengths)
        g_circ = np.ascontiguousarray(genome.circular, np.uint8)
        written = ctypes.c_int64(0)
        logged = ctypes.c_int64(0)
        for _ in range(2):  # a buffer below the rows' bound grows once
            rc = self._log_lib.compose_prehp_log(
                k, _ptr(lanes, ctypes.c_int64), len(n_events),
                names_packed.ctypes.data_as(ctypes.c_char_p), _ptr(name_off, ctypes.c_int64),
                _ptr(ev_flat, ctypes.c_uint32), ev_flat.size, _ptr(ev_off, ctypes.c_int64),
                _ptr(n_events, ctypes.c_int64),
                _ptr(prehp_flat, ctypes.c_uint8), prehp_flat.size,
                _ptr(prehp_off, ctypes.c_int64), _ptr(prehp_len, ctypes.c_int64),
                _ptr(chrom, ctypes.c_int64), _ptr(pos, ctypes.c_int64),
                _ptr(flat, ctypes.c_uint8), flat.size, _ptr(g_offsets, ctypes.c_int64),
                _ptr(g_lengths, ctypes.c_int64), _ptr(g_circ, ctypes.c_uint8), len(g_lengths),
                _ptr(self._err_buf, ctypes.c_char), self._err_buf.size,
                ctypes.byref(written), ctypes.byref(logged), EMIT_THREADS,
            )
            if rc != 1:
                break
            self._err_buf = np.empty(int(written.value * 1.3) + 64, np.uint8)
        if rc != 0:
            raise RuntimeError(f"compose_prehp_log failed rc={rc}")
        return memoryview(self._err_buf)[: written.value], logged.value

    @tracing.traced("emit.format")
    def emit(
        self,
        reads: np.ndarray,  # [B, L] uint8 (C-contiguous)
        quals,  # [B, L] uint8 or None
        lanes: np.ndarray,  # [k] int64 lane indices, emission order
        names: list,  # k strings
        total_len: np.ndarray,  # [k]
        head: np.ndarray,  # [k]
        l_new: np.ndarray,  # [k]
        rev: np.ndarray,  # [k] bool
        ev_pos2x,  # [B, E] int32 or None
        ev_type,
        ev_len,
        n_events,  # [k] int64 (0 if no error log)
        g_off: np.ndarray,  # [k] genome flat offset of the read's chromosome
        g_len: np.ndarray,  # [k] chromosome length
        g_circ: np.ndarray,  # [k] uint8
        start_pos: np.ndarray,  # [k] local start position
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
    ):
        k = len(lanes)
        names_packed, packed_off, pos = self._pack_names(names)

        need_fastx = int(total_len.sum()) * (2 if fastq else 1) + pos * 2 + 16 * k + 64
        if self._fastx_buf.size < need_fastx:
            self._fastx_buf = np.empty(int(need_fastx * 1.3), np.uint8)
        max_total = int(total_len.max()) if k else 1
        if self._mid_buf.size < max_total:
            self._mid_buf = np.empty(max_total * 2, np.uint8)

        if write_errors:
            ev_len_np = ev_len
            # generous bound: per event name+48 + 2*len
            tot_ev_len = int(ev_len_np[lanes, :].sum()) if k else 0
            max_name = max((len(nm) for nm in names), default=0)
            need_err = int(n_events.sum()) * (max_name + 48) + 2 * tot_ev_len + 64
        else:
            need_err = 64
        if self._err_buf.size < need_err:
            self._err_buf = np.empty(int(need_err * 1.3), np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        B, L = reads.shape
        if ev_pos2x is None:
            ev_pos2x = np.zeros((B, 1), np.int32)
            ev_type = np.zeros((B, 1), np.int32)
            ev_len = np.zeros((B, 1), np.int32)
        e_stride = ev_pos2x.shape[1]

        args = [
            _ptr(reads, ctypes.c_uint8),
            ctypes.c_int64(L),
            _ptr(quals if quals is not None else reads, ctypes.c_uint8),
            ctypes.c_int64(k),
            _ptr(np.ascontiguousarray(lanes, np.int64), ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(packed_off, ctypes.c_int64),
            _ptr(np.ascontiguousarray(total_len, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(head, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(l_new, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(rev, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(ev_pos2x, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(ev_type, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(ev_len, np.int32), ctypes.c_int32),
            ctypes.c_int64(e_stride),
            _ptr(np.ascontiguousarray(n_events, np.int64), ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_len, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_circ, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(start_pos, np.int64), ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.c_int64(self._fastx_buf.size),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.c_int64(self._err_buf.size),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if write_errors else 0),
            _ptr(self._mid_buf, ctypes.c_char),
            ctypes.c_int64(self._mid_buf.size),
        ]
        rc = self.lib.emit_batch(*args)
        if rc != 0:
            # grow the overflowing buffer and retry once
            if rc == 1:
                self._fastx_buf = np.empty(self._fastx_buf.size * 2, np.uint8)
            else:
                self._err_buf = np.empty(self._err_buf.size * 2, np.uint8)
                self._mid_buf = np.empty(self._mid_buf.size * 2, np.uint8)
            return self.emit(
                reads, quals, lanes, names, total_len, head, l_new, rev,
                ev_pos2x, ev_type, ev_len, n_events, g_off, g_len, g_circ,
                start_pos, genome_flat, fastq, write_errors,
            )
        return (
            self._fastx_buf[: fw.value].tobytes(),
            self._err_buf[: ew.value].tobytes(),
        )

    @tracing.traced("emit.format")
    def emit_flat(
        self,
        cb,  # sim.compact.CompactBatch with reads (2-bit flat reads)
        lanes: np.ndarray,  # [k] int64 lane indices, emission order
        names: list,  # k strings
        g_off: np.ndarray,  # [k]
        g_len: np.ndarray,
        g_circ: np.ndarray,  # [k] uint8: the error log's ref bases wrap
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
    ):
        """Format a compacted batch (2-bit flat reads, FASTQ qualities, packed
        u32 events for the error log).

        Returns (fastx_mv, err_mv) memoryviews into internal buffers — valid
        until the next emit call on this emitter.
        """
        k = len(lanes)
        names_packed, name_off, _ = self._pack_names(names)
        lanes = np.ascontiguousarray(lanes, np.int64)

        total = np.ascontiguousarray(cb.total[lanes], np.int64)
        head = np.ascontiguousarray(cb.head[lanes], np.int64)
        l_new = np.ascontiguousarray(cb.l_new[lanes], np.int64)
        rev = np.ascontiguousarray(cb.rev[lanes], np.uint8)
        n_ev = np.ascontiguousarray(cb.n_events[lanes] if write_errors else np.zeros(k),
                                    np.int64)
        read_off = np.ascontiguousarray(cb.read_off[lanes], np.int64)
        ev_off = np.ascontiguousarray(cb.ev_off[lanes], np.int64)
        qual_off = np.ascontiguousarray(cb.qual_off[lanes], np.int64)
        start_pos = np.ascontiguousarray(cb.pos[lanes], np.int64)

        name_lens = np.diff(name_off)
        # exact upper-bound output offsets: ranges of reads format
        # independently in parallel, then compact
        ubf = np.zeros(k + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + total * (2 if fastq else 1) + 12)
        ube = np.zeros(k + 1, np.int64)
        if write_errors:
            # per-event: name + key(<=20) + type(3) + len(<=20) + 2*len + seps
            used = int((ev_off + n_ev).max()) if k else 0
            lens = ((cb.ev_flat[:used] >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64)
            csum = np.zeros(used + 1, np.int64)
            np.cumsum(lens, out=csum[1:])
            ev_len_sum = csum[ev_off + n_ev] - csum[ev_off]
            ube[1:] = np.cumsum(n_ev * (name_lens + 52) + 2 * ev_len_sum)

        if self._fastx_buf.size < ubf[k]:
            self._fastx_buf = np.empty(int(ubf[k] * 1.3) + 64, np.uint8)
        if self._err_buf.size < ube[k] + 64:
            self._err_buf = np.empty(int(ube[k] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        rc = self.lib.emit_batch_flat(
            _ptr(np.ascontiguousarray(cb.reads_flat), ctypes.c_uint8),
            _ptr(read_off, ctypes.c_int64),
            _ptr(np.ascontiguousarray(cb.quals_flat), ctypes.c_uint8),
            _ptr(qual_off, ctypes.c_int64),
            ctypes.c_int64(k),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(total, ctypes.c_int64),
            _ptr(head, ctypes.c_int64),
            _ptr(l_new, ctypes.c_int64),
            _ptr(rev, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(cb.ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(ev_off, ctypes.c_int64),
            _ptr(n_ev, ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_len, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_circ, np.uint8), ctypes.c_uint8),
            _ptr(start_pos, ctypes.c_int64),
            _ptr(ubf, ctypes.c_int64),
            _ptr(ube, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if write_errors else 0),
            ctypes.c_int32(EMIT_THREADS),
        )
        if rc != 0:
            raise RuntimeError(f"emit_batch_flat failed rc={rc}")
        return (
            memoryview(self._fastx_buf)[: fw.value],
            memoryview(self._err_buf)[: ew.value],
        )

    @tracing.traced("emit.format")
    def emit_recon(
        self,
        cb,  # meta-only sim.compact.CompactBatch (reads_flat is None)
        lanes: np.ndarray,
        names: list,
        g_off: np.ndarray,
        g_len: np.ndarray,
        g_circ: np.ndarray,  # unused (linear fast path only)
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
        qual_table=None,  # (breaks [5, K] f32, vals [5, K] i32), required for fastq
    ):
        """Format a meta-only batch: read bytes (and FASTQ qualities) are
        RECONSTRUCTED from (genome, replayed events, counter RNG) —
        sim/reconstruct.py is the spec, csrc/recon_emit.cpp's aligned_range
        the implementation.  Under a profiler a FASTQ batch counts
        `emit.qual.bases` and `emit.qual.walk_steps` (so do the unaligned and
        chimeric emitters)."""
        from ..ops import rng as rng_mod

        seed, stream, ht_cap = cb.recon
        k = len(lanes)
        names_packed, name_off, _ = self._pack_names(names)
        lanes = np.ascontiguousarray(lanes, np.int64)

        total = np.ascontiguousarray(cb.total[lanes], np.int64)
        head = np.ascontiguousarray(cb.head[lanes], np.int64)
        l_new = np.ascontiguousarray(cb.l_new[lanes], np.int64)
        rev = np.ascontiguousarray(cb.rev[lanes], np.uint8)
        slots = np.ascontiguousarray(np.asarray(cb.slots)[lanes], np.int64)
        n_ev = np.ascontiguousarray(cb.n_events[lanes], np.int64)
        n_ev_log = n_ev if write_errors else np.zeros(k, np.int64)
        ev_off = np.ascontiguousarray(cb.ev_off[lanes], np.int64)
        start_pos = np.ascontiguousarray(cb.pos[lanes], np.int64)

        if fastq:
            assert qual_table is not None, "fastq reconstruction needs the qual table"
            q_breaks = np.ascontiguousarray(qual_table[0], np.float32)
            q_vals = np.ascontiguousarray(qual_table[1], np.int32)
            qK = q_breaks.shape[1]
        else:
            q_breaks = np.zeros((1, 1), np.float32)
            q_vals = np.zeros((1, 1), np.int32)
            qK = 1

        name_lens = np.diff(name_off)
        ubf = np.zeros(k + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + total * (2 if fastq else 1) + 16)
        ube = np.zeros(k + 1, np.int64)
        if write_errors:
            used = int((ev_off + n_ev).max()) if k else 0
            lens = ((cb.ev_flat[:used] >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64)
            csum = np.zeros(used + 1, np.int64)
            np.cumsum(lens, out=csum[1:])
            ev_len_sum = csum[ev_off + n_ev] - csum[ev_off]
            ube[1:] = np.cumsum(n_ev * (name_lens + 52) + 2 * ev_len_sum)

        if self._fastx_buf.size < ubf[k]:
            self._fastx_buf = np.empty(int(ubf[k] * 1.3) + 64, np.uint8)
        if self._err_buf.size < ube[k] + 64:
            self._err_buf = np.empty(int(ube[k] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        qb, ws = ctypes.c_int64(0), ctypes.c_int64(0)
        from ..sim.compact import CHUNK

        rc = self.lib.recon_emit_aligned(
            ctypes.c_int64(seed), ctypes.c_int64(stream),
            ctypes.c_int64(rng_mod.SITE_IUPAC), ctypes.c_int64(rng_mod.SITE_MIS_BASE),
            ctypes.c_int64(rng_mod.SITE_HEAD_TAIL),
            ctypes.c_int64(ht_cap), ctypes.c_int64(CHUNK),
            ctypes.c_int64(k),
            _ptr(slots, ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(total, ctypes.c_int64),
            _ptr(head, ctypes.c_int64),
            _ptr(l_new, ctypes.c_int64),
            _ptr(rev, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(cb.ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(ev_off, ctypes.c_int64),
            _ptr(n_ev, ctypes.c_int64),
            _ptr(np.ascontiguousarray(n_ev_log, np.int64), ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_len, np.int64), ctypes.c_int64),
            _ptr(start_pos, ctypes.c_int64),
            _ptr(ubf, ctypes.c_int64),
            _ptr(ube, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.byref(ew),
            ctypes.c_int32(1 if write_errors else 0),
            ctypes.c_int32(EMIT_THREADS),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int64(rng_mod.SITE_QUAL),
            _ptr(q_breaks, ctypes.c_float),
            _ptr(q_vals, ctypes.c_int32),
            ctypes.c_int64(qK),
            ctypes.byref(qb), ctypes.byref(ws),
        )
        if rc != 0:
            raise RuntimeError(f"recon_emit_aligned failed rc={rc}")
        _count_quals(fastq, qb, ws)
        return (
            memoryview(self._fastx_buf)[: fw.value],
            memoryview(self._err_buf)[: ew.value],
        )

    @tracing.traced("emit.format")
    def emit_recon_hp(
        self,
        cb,  # meta-only CompactBatch (reads_flat None; ev_flat = RAW walk)
        lanes: np.ndarray,
        names: list,
        g_off: np.ndarray,
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
        k: int,
        hp_tab,  # (breaks [2*(M+1), N] f32, vals i32)
        hp_mis_rate: float,
        l_cap: int,
        qual_table=None,
        _grow_pad=None,
    ):
        """Format a meta-only -hp batch: suppression, pass-1 mutation, exact
        table resizing, assembly, qualities and the pre-resize ground-truth
        log all reconstruct in C++ (sim/reconstruct.reconstruct_hp_lane is
        the spec)."""
        from ..ops import rng as rng_mod

        seed, stream, ht_cap = cb.recon
        nl = len(lanes)
        names_packed, name_off, _ = self._pack_names(names)
        lanes = np.ascontiguousarray(lanes, np.int64)

        total = np.ascontiguousarray(cb.total[lanes], np.int64)  # pre-resize
        head = np.ascontiguousarray(cb.head[lanes], np.int64)
        tail = np.ascontiguousarray(cb.tail[lanes], np.int64)
        middle = np.ascontiguousarray(cb.middle_ref[lanes], np.int64)
        rev = np.ascontiguousarray(cb.rev[lanes], np.uint8)
        slots = np.ascontiguousarray(np.asarray(cb.slots)[lanes], np.int64)
        n_ev = np.ascontiguousarray(cb.n_events[lanes], np.int64)
        ev_off = np.ascontiguousarray(cb.ev_off[lanes], np.int64)
        start_pos = np.ascontiguousarray(cb.pos[lanes], np.int64)

        hp_breaks = np.ascontiguousarray(hp_tab[0], np.float32)
        hp_vals = np.ascontiguousarray(hp_tab[1], np.int32)
        tabM = hp_breaks.shape[0] // 2 - 1
        tabN = hp_breaks.shape[1]

        if fastq:
            assert qual_table is not None
            q_breaks = np.ascontiguousarray(qual_table[0], np.float32)
            q_vals = np.ascontiguousarray(qual_table[1], np.int32)
            qK = q_breaks.shape[1]
        else:
            q_breaks = np.zeros((5, 1), np.float32)
            q_vals = np.zeros((5, 1), np.int32)
            qK = 1

        name_lens = np.diff(name_off)
        # pre-resize totals + a growth pad bound the final record; the C++
        # range returns 1 when a lane outgrows its pad and we retry larger
        pad = np.maximum(256, total // 4) if _grow_pad is None else _grow_pad
        ubf = np.zeros(nl + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + (total + pad) * (2 if fastq else 1) + 16)
        ube = np.zeros(nl + 1, np.int64)
        if write_errors:
            used = int((ev_off + n_ev).max()) if nl else 0
            lens = ((cb.ev_flat[:used] >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64)
            csum = np.zeros(used + 1, np.int64)
            np.cumsum(lens, out=csum[1:])
            ev_len_sum = csum[ev_off + n_ev] - csum[ev_off]
            ube[1:] = np.cumsum(n_ev * (name_lens + 52) + 2 * ev_len_sum)

        if self._fastx_buf.size < ubf[nl]:
            self._fastx_buf = np.empty(int(ubf[nl] * 1.3) + 64, np.uint8)
        if self._err_buf.size < ube[nl] + 64:
            self._err_buf = np.empty(int(ube[nl] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        rc = self.lib.emit_batch_recon_hp(
            ctypes.c_int64(seed), ctypes.c_int64(stream),
            ctypes.c_int64(rng_mod.SITE_IUPAC), ctypes.c_int64(rng_mod.SITE_INS_BASE),
            ctypes.c_int64(rng_mod.SITE_HOMOPOLYMER),
            ctypes.c_int64(rng_mod.SITE_HP_QUAL), ctypes.c_int64(rng_mod.SITE_HP_MIS_BASE),
            ctypes.c_int64(rng_mod.SITE_HEAD_TAIL), ctypes.c_int64(rng_mod.SITE_QUAL),
            ctypes.c_int64(ht_cap), ctypes.c_int64(k), ctypes.c_int64(l_cap),
            ctypes.c_double(float(np.float32(hp_mis_rate))),
            ctypes.c_int64(nl),
            _ptr(slots, ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(middle, ctypes.c_int64),
            _ptr(head, ctypes.c_int64),
            _ptr(tail, ctypes.c_int64),
            _ptr(rev, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(cb.ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(ev_off, ctypes.c_int64),
            _ptr(n_ev, ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(start_pos, ctypes.c_int64),
            _ptr(ubf, ctypes.c_int64),
            _ptr(ube, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if write_errors else 0),
            _ptr(hp_breaks, ctypes.c_float),
            _ptr(hp_vals, ctypes.c_int32),
            ctypes.c_int64(tabM), ctypes.c_int64(tabN),
            _ptr(q_breaks, ctypes.c_float),
            _ptr(q_vals, ctypes.c_int32),
            ctypes.c_int64(qK),
            ctypes.c_int32(EMIT_THREADS),
        )
        if rc == 1:
            bigger = pad * 4
            return self.emit_recon_hp(
                cb, lanes, names, g_off, genome_flat, fastq,
                write_errors, k, hp_tab, hp_mis_rate, l_cap,
                qual_table=qual_table, _grow_pad=bigger,
            )
        if rc != 0:
            raise RuntimeError(f"emit_batch_recon_hp failed rc={rc}")
        return (
            memoryview(self._fastx_buf)[: fw.value],
            memoryview(self._err_buf)[: ew.value],
        )

    @tracing.traced("emit.format")
    def emit_recon_unaligned(
        self,
        cb,  # meta-only CompactBatch (reads_flat None; ev_flat replayed)
        lanes: np.ndarray,
        names: list,
        g_off: np.ndarray,  # [k] chromosome byte offsets
        genome_flat: np.ndarray,
        fastq: bool,
        qual_table=None,
    ):
        """Reconstruct + format unaligned reads (presentation-space edit
        semantics; sim/reconstruct.reconstruct_unaligned_lane is the spec)."""
        from ..ops import rng as rng_mod

        seed, stream, _ = cb.recon
        k = len(lanes)
        names_packed, name_off, _ = self._pack_names(names)
        lanes = np.ascontiguousarray(lanes, np.int64)

        l_new = np.ascontiguousarray(cb.l_new[lanes], np.int64)
        middle = np.ascontiguousarray(cb.middle_ref[lanes], np.int64)
        rev = np.ascontiguousarray(cb.rev[lanes], np.uint8)
        slots = np.ascontiguousarray(np.asarray(cb.slots)[lanes], np.int64)
        n_steps = np.ascontiguousarray(cb.n_events[lanes], np.int64)
        ev_off = np.ascontiguousarray(cb.ev_off[lanes], np.int64)
        start_pos = np.ascontiguousarray(cb.pos[lanes], np.int64)

        if fastq:
            assert qual_table is not None
            q_breaks = np.ascontiguousarray(qual_table[0], np.float32)
            q_vals = np.ascontiguousarray(qual_table[1], np.int32)
            qK = q_breaks.shape[1]
        else:
            q_breaks = np.zeros((5, 1), np.float32)
            q_vals = np.zeros((5, 1), np.int32)
            qK = 1

        name_lens = np.diff(name_off)
        ubf = np.zeros(k + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + l_new * (2 if fastq else 1) + 16)
        if self._fastx_buf.size < ubf[k]:
            self._fastx_buf = np.empty(int(ubf[k] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        qb, ws = ctypes.c_int64(0), ctypes.c_int64(0)
        rc = self.lib.recon_emit_unaligned(
            ctypes.c_int64(seed), ctypes.c_int64(stream),
            ctypes.c_int64(rng_mod.SITE_IUPAC), ctypes.c_int64(rng_mod.SITE_INS_BASE),
            ctypes.c_int64(rng_mod.SITE_QUAL), ctypes.c_int64(k),
            _ptr(slots, ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(l_new, ctypes.c_int64),
            _ptr(middle, ctypes.c_int64),
            _ptr(rev, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(cb.ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(ev_off, ctypes.c_int64),
            _ptr(n_steps, ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(start_pos, ctypes.c_int64),
            _ptr(ubf, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            ctypes.c_int32(1 if fastq else 0),
            _ptr(q_breaks, ctypes.c_float),
            _ptr(q_vals, ctypes.c_int32),
            ctypes.c_int64(qK),
            ctypes.c_int32(EMIT_THREADS),
            ctypes.byref(qb), ctypes.byref(ws),
        )
        if rc != 0:
            raise RuntimeError(f"recon_emit_unaligned failed rc={rc}")
        _count_quals(fastq, qb, ws)
        return memoryview(self._fastx_buf)[: fw.value]

    @tracing.traced("emit.format")
    def emit_chimeric_recon(
        self,
        *,
        seed: int,
        stream: int,
        ht_cap: int,
        S: int,
        slots: np.ndarray,  # [k]
        names: list,
        total: np.ndarray,
        head: np.ndarray,
        tail: np.ndarray,
        n_seg: np.ndarray,
        rev: np.ndarray,  # [k] uint8
        seg_part_off: np.ndarray,  # [k*S] flattened read-coord starts
        seg_lnew: np.ndarray,
        seg_mid: np.ndarray,
        seg_goff: np.ndarray,
        seg_spos: np.ndarray,
        seg_ev_flat: np.ndarray,  # u32
        seg_ev_off: np.ndarray,
        seg_n_ev: np.ndarray,
        gap_part_off: np.ndarray,  # [k*(S-1)]
        gap_lnew: np.ndarray,
        gap_mid: np.ndarray,
        gap_goff: np.ndarray,
        gap_spos: np.ndarray,
        gap_ev_flat: np.ndarray,
        gap_ev_off: np.ndarray,
        gap_n_steps: np.ndarray,
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
        qual_table=None,
    ):
        """Reconstruct + format chimeric reads (head|seg|gap|...|tail) from
        replayed part-keyed event streams."""
        from ..ops import rng as rng_mod

        k = len(slots)
        names_packed, name_off, _ = self._pack_names(names)
        i64 = lambda a: np.ascontiguousarray(a, np.int64)

        if fastq:
            assert qual_table is not None
            q_breaks = np.ascontiguousarray(qual_table[0], np.float32)
            q_vals = np.ascontiguousarray(qual_table[1], np.int32)
            qK = q_breaks.shape[1]
        else:
            q_breaks = np.zeros((5, 1), np.float32)
            q_vals = np.zeros((5, 1), np.int32)
            qK = 1

        name_lens = np.diff(name_off)
        ubf = np.zeros(k + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + total * (2 if fastq else 1) + 16)
        ube = np.zeros(k + 1, np.int64)
        if write_errors:
            # per-read upper bound: events' (name + 52 + 2*len)
            ev_len_sum = np.zeros(k, np.int64)
            n_ev_sum = np.zeros(k, np.int64)
            lens_all = ((seg_ev_flat >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64)
            csum = np.zeros(len(lens_all) + 1, np.int64)
            np.cumsum(lens_all, out=csum[1:])
            for r in range(k):
                for s in range(S):
                    rs = r * S + s
                    o, ne = int(seg_ev_off[rs]), int(seg_n_ev[rs])
                    ev_len_sum[r] += csum[o + ne] - csum[o]
                    n_ev_sum[r] += ne
            ube[1:] = np.cumsum(n_ev_sum * (name_lens + 52) + 2 * ev_len_sum)
        if self._fastx_buf.size < ubf[k]:
            self._fastx_buf = np.empty(int(ubf[k] * 1.3) + 64, np.uint8)
        if self._err_buf.size < ube[k] + 64:
            self._err_buf = np.empty(int(ube[k] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        qb, ws = ctypes.c_int64(0), ctypes.c_int64(0)
        rc = self.lib.recon_emit_chimeric(
            ctypes.c_int64(seed), ctypes.c_int64(stream),
            ctypes.c_int64(rng_mod.SITE_IUPAC), ctypes.c_int64(rng_mod.SITE_INS_BASE),
            ctypes.c_int64(rng_mod.SITE_HEAD_TAIL), ctypes.c_int64(rng_mod.SITE_QUAL),
            ctypes.c_int64(rng_mod.PART_SEGMENT_BASE), ctypes.c_int64(rng_mod.PART_GAP_BASE),
            ctypes.c_int64(ht_cap),
            ctypes.c_int64(k), ctypes.c_int64(S),
            _ptr(i64(slots), ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(i64(total), ctypes.c_int64),
            _ptr(i64(head), ctypes.c_int64),
            _ptr(i64(tail), ctypes.c_int64),
            _ptr(i64(n_seg), ctypes.c_int64),
            _ptr(np.ascontiguousarray(rev, np.uint8), ctypes.c_uint8),
            _ptr(i64(seg_part_off), ctypes.c_int64),
            _ptr(i64(seg_lnew), ctypes.c_int64),
            _ptr(i64(seg_mid), ctypes.c_int64),
            _ptr(i64(seg_goff), ctypes.c_int64),
            _ptr(i64(seg_spos), ctypes.c_int64),
            _ptr(np.ascontiguousarray(seg_ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(i64(seg_ev_off), ctypes.c_int64),
            _ptr(i64(seg_n_ev), ctypes.c_int64),
            _ptr(i64(gap_part_off), ctypes.c_int64),
            _ptr(i64(gap_lnew), ctypes.c_int64),
            _ptr(i64(gap_mid), ctypes.c_int64),
            _ptr(i64(gap_goff), ctypes.c_int64),
            _ptr(i64(gap_spos), ctypes.c_int64),
            _ptr(np.ascontiguousarray(gap_ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(i64(gap_ev_off), ctypes.c_int64),
            _ptr(i64(gap_n_steps), ctypes.c_int64),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(ubf, ctypes.c_int64),
            _ptr(ube, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if write_errors else 0),
            _ptr(q_breaks, ctypes.c_float),
            _ptr(q_vals, ctypes.c_int32),
            ctypes.c_int64(qK),
            ctypes.c_int32(EMIT_THREADS),
            ctypes.byref(qb), ctypes.byref(ws),
        )
        if rc != 0:
            raise RuntimeError(f"recon_emit_chimeric failed rc={rc}")
        _count_quals(fastq, qb, ws)
        return (
            memoryview(self._fastx_buf)[: fw.value],
            memoryview(self._err_buf)[: ew.value],
        )

    @tracing.traced("emit.format")
    def emit_trx_recon(
        self,
        *,
        seed: int,
        stream: int,
        ht_cap: int,
        slots: np.ndarray,  # [k]
        names: list,
        total: np.ndarray,
        head: np.ndarray,
        tail: np.ndarray,
        pa_len: np.ndarray,
        l_new: np.ndarray,
        middle_ref: np.ndarray,
        rev: np.ndarray,
        ev_flat: np.ndarray,  # u32 replayed walk events
        ev_off: np.ndarray,
        n_events: np.ndarray,
        src_a: np.ndarray,  # transcriptome flat bytes
        src_b: np.ndarray,  # IR interval-concat aux
        use_b: np.ndarray,  # [k] uint8
        src_off: np.ndarray,  # [k]
        fastq: bool,
        uracil: bool,
        write_errors: bool,
        qual_table=None,
    ):
        """Reconstruct + format transcriptome reads (head | middle | polyA |
        tail) from replayed event streams."""
        from ..ops import rng as rng_mod

        k = len(slots)
        names_packed, name_off, _ = self._pack_names(names)
        i64 = lambda a: np.ascontiguousarray(a, np.int64)

        if fastq:
            assert qual_table is not None
            q_breaks = np.ascontiguousarray(qual_table[0], np.float32)
            q_vals = np.ascontiguousarray(qual_table[1], np.int32)
            qK = q_breaks.shape[1]
        else:
            q_breaks = np.zeros((5, 1), np.float32)
            q_vals = np.zeros((5, 1), np.int32)
            qK = 1

        name_lens = np.diff(name_off)
        ubf = np.zeros(k + 1, np.int64)
        ubf[1:] = np.cumsum(name_lens + total * (2 if fastq else 1) + 16)
        ube = np.zeros(k + 1, np.int64)
        if write_errors:
            lens_all = ((np.asarray(ev_flat) >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64)
            csum = np.zeros(len(lens_all) + 1, np.int64)
            np.cumsum(lens_all, out=csum[1:])
            ev_len_sum = csum[np.asarray(ev_off) + np.asarray(n_events)] - csum[np.asarray(ev_off)]
            ube[1:] = np.cumsum(np.asarray(n_events) * (name_lens + 52) + 2 * ev_len_sum)
        if self._fastx_buf.size < ubf[k]:
            self._fastx_buf = np.empty(int(ubf[k] * 1.3) + 64, np.uint8)
        if self._err_buf.size < ube[k] + 64:
            self._err_buf = np.empty(int(ube[k] * 1.3) + 64, np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        rc = self.lib.emit_trx_recon(
            ctypes.c_int64(seed), ctypes.c_int64(stream),
            ctypes.c_int64(rng_mod.SITE_IUPAC), ctypes.c_int64(rng_mod.SITE_INS_BASE),
            ctypes.c_int64(rng_mod.SITE_HEAD_TAIL), ctypes.c_int64(rng_mod.SITE_QUAL),
            ctypes.c_int64(ht_cap), ctypes.c_int64(k),
            _ptr(i64(slots), ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(name_off, ctypes.c_int64),
            _ptr(i64(total), ctypes.c_int64),
            _ptr(i64(head), ctypes.c_int64),
            _ptr(i64(tail), ctypes.c_int64),
            _ptr(i64(pa_len), ctypes.c_int64),
            _ptr(i64(l_new), ctypes.c_int64),
            _ptr(i64(middle_ref), ctypes.c_int64),
            _ptr(np.ascontiguousarray(rev, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(ev_flat, np.uint32), ctypes.c_uint32),
            _ptr(i64(ev_off), ctypes.c_int64),
            _ptr(i64(n_events), ctypes.c_int64),
            _ptr(np.ascontiguousarray(src_a, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(src_b, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(use_b, np.uint8), ctypes.c_uint8),
            _ptr(i64(src_off), ctypes.c_int64),
            _ptr(ubf, ctypes.c_int64),
            _ptr(ube, ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if uracil else 0),
            ctypes.c_int32(1 if write_errors else 0),
            _ptr(q_breaks, ctypes.c_float),
            _ptr(q_vals, ctypes.c_int32),
            ctypes.c_int64(qK),
            ctypes.c_int32(EMIT_THREADS),
        )
        if rc != 0:
            raise RuntimeError(f"emit_trx_recon failed rc={rc}")
        return (
            memoryview(self._fastx_buf)[: fw.value],
            memoryview(self._err_buf)[: ew.value],
        )

    def _pack_names(self, names):
        k = len(names)
        packed_off = np.zeros(k + 1, np.int64)
        pos = 0
        chunks = []
        for i, nm in enumerate(names):
            b = nm.encode()
            packed_off[i] = pos
            chunks.append(b)
            pos += len(b)
        packed_off[k] = pos
        packed = np.frombuffer(b"".join(chunks), np.uint8) if chunks else np.zeros(1, np.uint8)
        return packed, packed_off, pos

    @tracing.traced("emit.format")
    def emit_chimeric(
        self,
        reads: np.ndarray,  # [B, L] uint8
        quals,  # [B, L] uint8 or None
        lanes: np.ndarray,  # [k] int64, emission order
        names: list,  # k strings
        total_len: np.ndarray,  # [k]
        rev: np.ndarray,  # [k] bool
        n_seg: np.ndarray,  # [k]
        seg_off: np.ndarray,  # [k, S] pre-reverse read-coord segment starts
        ev_row: np.ndarray,  # [k, S] row into the event arrays (seg*B + lane)
        n_events_rs: np.ndarray,  # [k, S]
        ev_pos2x: np.ndarray,  # [B*S, E] int32
        ev_type: np.ndarray,
        ev_len: np.ndarray,
        g_off: np.ndarray,  # [k, S]
        g_len: np.ndarray,
        g_circ: np.ndarray,  # [k, S] uint8
        start_pos: np.ndarray,  # [k, S]
        genome_flat: np.ndarray,
        fastq: bool,
        write_errors: bool,
    ):
        k = len(lanes)
        S = seg_off.shape[1] if k else 1
        names_packed, packed_off, name_bytes = self._pack_names(names)

        need_fastx = int(total_len.sum()) * (2 if fastq else 1) + name_bytes * 2 + 16 * k + 64
        if self._fastx_buf.size < need_fastx:
            self._fastx_buf = np.empty(int(need_fastx * 1.3), np.uint8)
        max_total = int(total_len.max()) if k else 1
        if self._mid_buf.size < max_total:
            self._mid_buf = np.empty(max_total * 2, np.uint8)
        if write_errors:
            rows = np.ascontiguousarray(ev_row, np.int64).reshape(-1)
            tot_ev_len = int(ev_len[rows, :].sum()) if k else 0
            max_name = max((len(nm) for nm in names), default=0)
            need_err = int(n_events_rs.sum()) * (max_name + 48) + 2 * tot_ev_len + 64
        else:
            need_err = 64
        if self._err_buf.size < need_err:
            self._err_buf = np.empty(int(need_err * 1.3), np.uint8)

        fw = ctypes.c_int64(0)
        ew = ctypes.c_int64(0)
        _, L = reads.shape
        e_stride = ev_pos2x.shape[1]
        args = [
            _ptr(reads, ctypes.c_uint8),
            ctypes.c_int64(L),
            _ptr(quals if quals is not None else reads, ctypes.c_uint8),
            ctypes.c_int64(k),
            _ptr(np.ascontiguousarray(lanes, np.int64), ctypes.c_int64),
            names_packed.ctypes.data_as(ctypes.c_char_p),
            _ptr(packed_off, ctypes.c_int64),
            _ptr(np.ascontiguousarray(total_len, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(rev, np.uint8), ctypes.c_uint8),
            ctypes.c_int64(S),
            _ptr(np.ascontiguousarray(n_seg, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(seg_off, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(ev_row, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(n_events_rs, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(ev_pos2x, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(ev_type, np.int32), ctypes.c_int32),
            _ptr(np.ascontiguousarray(ev_len, np.int32), ctypes.c_int32),
            ctypes.c_int64(e_stride),
            _ptr(genome_flat, ctypes.c_uint8),
            _ptr(np.ascontiguousarray(g_off, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_len, np.int64), ctypes.c_int64),
            _ptr(np.ascontiguousarray(g_circ, np.uint8), ctypes.c_uint8),
            _ptr(np.ascontiguousarray(start_pos, np.int64), ctypes.c_int64),
            _ptr(self._fastx_buf, ctypes.c_char),
            ctypes.c_int64(self._fastx_buf.size),
            ctypes.byref(fw),
            _ptr(self._err_buf, ctypes.c_char),
            ctypes.c_int64(self._err_buf.size),
            ctypes.byref(ew),
            ctypes.c_int32(1 if fastq else 0),
            ctypes.c_int32(1 if write_errors else 0),
            _ptr(self._mid_buf, ctypes.c_char),
            ctypes.c_int64(self._mid_buf.size),
        ]
        rc = self.lib.emit_chimeric_batch(*args)
        if rc != 0:
            if rc == 1:
                self._fastx_buf = np.empty(self._fastx_buf.size * 2, np.uint8)
            else:
                self._err_buf = np.empty(self._err_buf.size * 2, np.uint8)
                self._mid_buf = np.empty(self._mid_buf.size * 2, np.uint8)
            return self.emit_chimeric(
                reads, quals, lanes, names, total_len, rev, n_seg, seg_off,
                ev_row, n_events_rs, ev_pos2x, ev_type, ev_len, g_off, g_len,
                g_circ, start_pos, genome_flat, fastq, write_errors,
            )
        return (
            self._fastx_buf[: fw.value].tobytes(),
            self._err_buf[: ew.value].tobytes(),
        )
