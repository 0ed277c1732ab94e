"""Host-side output: FASTA/FASTQ emission, read naming, ground-truth error log.

Naming and file layout match the reference exactly:

* aligned reads -> `<out>_aligned_reads.fasta|fastq`, names
  `<chrom>_<pos>_aligned_<idx>_<F|R>_<head>_<middle>_<tail>`
  (simulator.py:1390-1402); unaligned reads `_unaligned_` with 0 head/tail
  (simulator.py:1534).
* every introduced error -> `<out>_aligned_error_profile` rows
  `Seq_name  Seq_pos  error_type  error_length  ref_base  seq_base`
  written per read in reverse position order (mutate_read,
  simulator.py:2006-2008; header at simulator.py:1634).

A batch comes back as one compacted buffer (sim/compact.py): metadata, and
the reads when the device ran the read-emitting program.  The host replays
each lane's walk, checks it against the device checksum, and (meta-only
program) reconstructs the read bytes.
"""

from __future__ import annotations

import sys

import numpy as np

class RunStats:
    """Process-wide capacity and verification counters: a workload that
    rescues every batch is silently slower, and a lane whose device walk
    disagrees with the host replay means the device walk is wrong — these
    make both attributable.  Printed by the run orchestrators' stage logs."""

    def __init__(self):
        self.reset()

    def reset(self):
        # lanes re-run through the full-budget rescue program (walk-budget /
        # width overflow)
        self.overflow_rescue_lanes = 0
        # lanes whose host walk replay failed the device checksum, so their
        # events were fetched from the device instead
        self.checksum_fallback_lanes = 0
        # chimeric batches whose active (slot, segment) pairs exceeded the
        # packed walk-lane capacity and were re-run unpacked
        self.packed_spills = 0

    def summary(self) -> str:
        return (f"capacity events: overflow_rescue_lanes={self.overflow_rescue_lanes} "
                f"checksum_fallback_lanes={self.checksum_fallback_lanes} "
                f"packed_spills={self.packed_spills}")

    def report(self, log=None) -> None:
        """Emit the counters when any fired (log: callable or None=stderr)."""
        if not (self.overflow_rescue_lanes or self.checksum_fallback_lanes
                or self.packed_spills):
            return
        if log is None:
            print("[nanosim-tpu-torch] " + self.summary(), file=sys.stderr)
        else:
            log(self.summary())


RUN_STATS = RunStats()


def report_progress(prev: int, now: int) -> None:
    """Batch-granular progress line at every 10k-read crossing.

    Mirrors the reference's per-read ticker (`check_print_progress`,
    simulator.py:52-56: at sequence_index % 10000 == 0 it prints
    `Number of reads simulated >> <index+1>`, carriage-return terminated) at
    the batch level: the batch assigned indices [prev, now), so one line per
    10k multiple the batch covered, each printing mark+1 for byte parity.
    """
    first = -(-prev // 10000) * 10000
    if first >= now:
        return
    import sys
    from time import strftime

    for mark in range(first, now, 10000):
        sys.stdout.write(
            strftime("%Y-%m-%d %H:%M:%S") + ": Number of reads simulated >> " + str(mark + 1) + "\r"
        )
    sys.stdout.flush()


class FastxWriter:
    """Buffered FASTA/FASTQ writer over uint8 token rows."""

    def __init__(self, path: str, fastq: bool, append: bool = False):
        self.f = open(path, "ab" if append else "wb")
        self.fastq = fastq
        self._buf = []
        self._buf_bytes = 0

    def write(self, name: str, seq: np.ndarray, quals=None):
        head = ("@" if self.fastq else ">") + name + "\n"
        self._buf.append(head.encode())
        self._buf.append(seq.tobytes())
        self._buf.append(b"\n")
        if self.fastq:
            self._buf.append(b"+\n")
            self._buf.append(quals.tobytes())
            self._buf.append(b"\n")
        self._buf_bytes += len(head) + len(seq) * (2 if self.fastq else 1) + 8
        if self._buf_bytes > 8 << 20:
            self.flush()

    def flush(self):
        if self._buf:
            self.f.write(b"".join(self._buf))
            self._buf = []
            self._buf_bytes = 0

    def close(self):
        self.flush()
        self.f.close()


class ErrorLogWriter:
    """Ground-truth error log, reference row format."""

    HEADER = "Seq_name\tSeq_pos\terror_type\terror_length\tref_base\tseq_base\n"

    def __init__(self, path: str, header: bool = False, append: bool = False):
        self.f = open(path, "ab" if append else "wb", buffering=1 << 20)
        if header and not append:
            self.f.write(self.HEADER.encode())

    def write_read_events(self, name, keys, types, lens, refs, seqs):
        # reverse position order, as mutate_read logs them
        out = self.f
        for i in range(len(keys) - 1, -1, -1):
            out.write(
                f"{name}\t{keys[i]}\t{types[i]}\t{lens[i]}\t{refs[i]}\t{seqs[i]}\n".encode()
            )

    def write_bytes(self, data: bytes):
        self.f.write(data)

    def close(self):
        self.f.close()


_ETYPE_NAMES = ("mis", "ins", "del")


def event_read_positions(ev_pos2x, ev_type, ev_len):
    """One lane's per-event (key, read-coordinate start, effective length).

    read_start(e) = ref_start(e) - (deleted bases before e) + (inserted bases
    before e); events arrive in ascending position order from the walk.
    Overwritten duplicate insertions (a successor insertion with the same
    position key) count as length 0.
    """
    ev_len = ev_len.copy()
    is_ins = ev_type == 1
    dead = np.zeros(len(ev_len), bool)
    dead[:-1] = is_ins[:-1] & is_ins[1:] & (ev_pos2x[1:] == ev_pos2x[:-1])
    ev_len[dead] = 0
    dlen = np.where(ev_type == 2, ev_len, 0)
    ilen = np.where(is_ins, ev_len, 0)
    key = (ev_pos2x + 1) // 2  # ceil of the reference's float key
    ref_start = np.where(is_ins, key, ev_pos2x // 2)
    rpos = ref_start - (np.cumsum(dlen) - dlen) + (np.cumsum(ilen) - ilen)
    return key, rpos, ev_len


def _prehp_log_rows(name, keys_v, types_v, lens_v, rpos_v, mid: str, g, chrom: int, spos: int):
    """Ground-truth log rows of one segment in ascending event order:
    zero-length (suppressed or overwritten) events are skipped, seq bases are
    cut from the pass-1 middle `mid`, ref bases from the genome (wrapping on a
    circular chromosome)."""
    goff = int(g.offsets[chrom])
    glen = int(g.lengths[chrom])
    circ = bool(g.circular[chrom])
    rows = []
    for k, t, ln, rp in zip(keys_v.tolist(), types_v.tolist(), lens_v.tolist(), rpos_v.tolist()):
        if ln == 0:
            continue
        if t == 1:
            ref = "-" * ln
            seq = mid[rp : rp + ln]
        else:
            st = spos + k
            if circ and st % glen + ln > glen:
                idxs = (np.arange(st, st + ln) % glen) + goff
                ref = g.flat[idxs].tobytes().decode()
            else:
                if circ:
                    st %= glen
                ref = g.flat[goff + st : goff + st + ln].tobytes().decode()
            seq = mid[rp : rp + ln] if t == 0 else "-" * ln
        rows.append(f"{name}\t{k}\t{_ETYPE_NAMES[t]}\t{ln}\t{ref}\t{seq}\n")
    return rows


class GenomeBatchWriter:
    """Accept/number/emit a genome-mode batch (aligned reads).

    Batches are CompactBatches.  From the meta-only program the read bytes
    (and FASTQ qualities) are reconstructed host-side from the genome, the
    replayed walk events and the counter RNG by the C++ emitter
    (sim/reconstruct.py is its numpy spec); from the read-emitting program
    they arrive 2-bit packed, and the emitter decodes and formats them.
    In homopolymer mode the reconstruction is the -hp emitter's, and the
    device-materialized route's ground-truth log is composed here from the
    pre-resize middles."""

    def __init__(self, fastx: FastxWriter, error_log=None):
        self.fastx = fastx
        self.error_log = error_log
        from ..io.native import NativeEmitter

        self._emitter = NativeEmitter()

    def write_batch(self, sim, out, accepted_so_far: int, quota: int) -> int:
        d = out.fetch()
        lanes = np.nonzero(d["valid"])[0][: quota - accepted_so_far]
        return self.write_run(sim, d, lanes, accepted_so_far)

    def write_run(self, sim, cb, lanes, accepted_so_far: int) -> int:
        """Emit already-fetched lanes (in the given order) starting at
        sequence number `accepted_so_far`."""
        if len(lanes) == 0:
            return 0
        return self._write_flat(sim, cb, lanes, accepted_so_far,
                                with_events=self.error_log is not None)

    def _lane_names(self, sim, cb, lanes, accepted_so_far: int):
        names = []
        gnames = sim.genome_host.names
        chrom = cb.chrom
        pos = cb.pos
        rev = cb.rev
        head = cb.head
        middle_ref = cb.middle_ref
        tail = cb.tail
        for rank, b in enumerate(lanes):
            idx = accepted_so_far + rank
            strand = "R" if rev[b] else "F"
            names.append(
                f"{gnames[chrom[b]]}_{pos[b]}_aligned_{idx}_{strand}"
                f"_{head[b]}_{middle_ref[b]}_{tail[b]}"
            )
        return names

    def _write_flat(self, sim, cb, lanes, accepted_so_far: int, with_events: bool) -> int:
        """Emit a compacted batch: 2-bit flat reads from the read-emitting
        program, or a meta-only batch whose read bytes are reconstructed
        host-side."""
        fin = getattr(cb, "finish", None)
        if fin is not None:
            fin()  # lazy walk replay (idempotent), in the emission worker
        g = sim.genome_host
        names = self._lane_names(sim, cb, lanes, accepted_so_far)
        lanes = np.asarray(lanes, np.int64)
        chrom = cb.chrom[lanes]
        hp = getattr(sim, "kmer_bias", None) is not None
        kw = {}
        if sim.fastq and cb.reads_flat is None:
            q = sim.tables.qual
            kw["qual_table"] = (q.breaks.cpu().numpy(), q.vals.cpu().numpy())
        if hp and cb.reads_flat is None:
            # meta-only -hp batch: suppression, pass-1 mutation, exact run
            # resizing and the pre-resize ground-truth log all replay
            # host-side (sim/reconstruct.reconstruct_hp_lane is the spec)
            fastx_mv, err_mv = self._emitter.emit_recon_hp(
                cb, lanes, names, g_off=g.offsets[chrom],
                genome_flat=g.flat, fastq=sim.fastq, write_errors=with_events,
                k=sim.kmer_bias,
                hp_tab=(sim.tables.hp_breaks.cpu().numpy(), sim.tables.hp_vals.cpu().numpy()),
                hp_mis_rate=sim.tables.hp_mis_rate, l_cap=sim.l_cap, **kw,
            )
        else:
            emit = self._emitter.emit_recon if cb.reads_flat is None else self._emitter.emit_flat
            # -hp rewrites homopolymer runs AFTER the logged pass-1 mutation,
            # so the log of a device-materialized -hp batch is cut from the
            # pre-resize middles instead (_hp_log_bytes)
            fastx_mv, err_mv = emit(
                cb, lanes, names,
                g_off=g.offsets[chrom], g_len=g.lengths[chrom],
                g_circ=np.ascontiguousarray(g.circular[chrom], np.uint8),
                genome_flat=g.flat, fastq=sim.fastq,
                write_errors=with_events and not hp, **kw,
            )
            if hp and with_events:
                err_mv = self._hp_log_bytes(sim, cb, lanes, names)
        io = getattr(self, "io_pool", None)
        if io is not None:
            # hand the composed bytes to the io stage (copies out of the
            # emitter's reused buffers; the file write then overlaps the next
            # emit)
            fdata = bytes(fastx_mv)
            edata = bytes(err_mv) if with_events else None

            def do_io(fdata=fdata, edata=edata):
                self.fastx.flush()
                self.fastx.f.write(fdata)
                if edata is not None:
                    self.error_log.write_bytes(edata)

            io.submit(do_io)
            return len(lanes)
        self.fastx.flush()
        self.fastx.f.write(fastx_mv)
        if with_events:
            self.error_log.write_bytes(err_mv)
        return len(lanes)

    def _hp_log_bytes(self, sim, cb, lanes, names) -> bytes:
        """Pre-hp ground-truth log of a device-materialized -hp batch: the
        device's events (suppressed ones carry zero length and are skipped),
        seq bases cut from the pass-1 middles, ref bases from the genome
        (wrapping on a circular chromosome); rows per read in reverse
        position order, as mutate_read logs them."""
        from .compact import decode_prehp_ascii

        g = sim.genome_host
        rows = []
        for name, b in zip(names, lanes):
            ne = int(cb.n_events[b])
            if ne == 0:
                continue
            o = int(cb.ev_off[b])
            w = cb.ev_flat[o : o + ne]
            keys_v, rpos_v, lens_v = event_read_positions(
                (w & np.uint32(0x1FFFF)).astype(np.int64),
                (w >> np.uint32(30)).astype(np.int64),
                ((w >> np.uint32(17)) & np.uint32(0x1FFF)).astype(np.int64),
            )
            mid = decode_prehp_ascii(cb, b).tobytes().decode()
            lane_rows = _prehp_log_rows(name, keys_v, (w >> np.uint32(30)), lens_v, rpos_v, mid,
                                        g, int(cb.chrom[b]), int(cb.pos[b]))
            rows.extend(reversed(lane_rows))
        return "".join(rows).encode()


class CompactHandle:
    """A dispatched batch plus its queued device-compaction program."""

    def __init__(self, fetcher, out, buf_dev, caps):
        self.fetcher = fetcher
        self.out = out
        self.buf_dev = buf_dev
        self.caps = caps

    def fetch(self):
        return self.fetcher._fetch(self)


class CompactFetcher:
    """Single-round-trip batch fetcher via device-side compaction.

    The device packs the batch's per-lane metadata and event checksums (and,
    for a read-emitting program, the valid lanes' 2-bit reads and FASTQ
    qualities) into one uint8 buffer (sim/compact.py): one device->host copy
    per batch.  The host REGENERATES each accepted lane's events with the
    walk replayer and verifies them against the device checksum, so the
    event stream stays on the device.  Without reads (with_reads=False, the
    host-reconstruction route) the read bytes are reconstructed host-side
    from the replayed events + genome + counter RNG (recon_info = (seed,
    stream, ht_cap)); that route needs the replayer.  With reads and no
    replayer, no events reach the host (the unaligned pass writes no error
    log).

    With with_prehp (homopolymer mode off the reconstruction route) the
    buffer also carries the device's own events, whose lengths the
    suppression zeroed, and the 2-bit pre-resize middles the ground-truth
    log is cut from; there is no replay on that route.

    A lane whose replay fails its checksum gets its events from the device
    instead (an exact second transfer); such lanes are counted in
    RUN_STATS.checksum_fallback_lanes, which on a healthy run stays 0: the
    device walk and the independent C++ replay agree event for event.

    The read and quality capacities start from profile estimates (est_bases
    per read) and lock to the first batch's need plus a margin; a batch that
    overflows them is repacked larger.  They shape the transfer only, never
    the output.
    """

    # first batch: generous margin (estimates only); then lock to the
    # observed need + LOCKED_MARGIN (batch sums concentrate hard)
    FIRST_MARGIN = 1.35
    LOCKED_MARGIN = 1.06

    def __init__(self, batch: int, est_events: float, replayer, recon_info=None,
                 lazy_replay: bool = False, with_reads: bool = False, fastq: bool = False,
                 est_bases: float = 0.0, with_prehp: bool = False):
        from . import compact as _c

        if replayer is not None and not replayer.available:
            raise RuntimeError("the walk replayer needs native/fastwriter.cpp built with g++")
        if replayer is None and not with_reads:
            raise RuntimeError("host reconstruction needs the native walk replayer")
        if with_prehp and (replayer is not None or not with_reads):
            raise ValueError("the pre-resize middles travel with the reads and the device's "
                             "own events, without a replayer")
        self.with_prehp = with_prehp
        self._c = _c
        self.replayer = replayer
        self.recon_info = recon_info
        self.with_reads = with_reads
        # reconstruction regenerates FASTQ qualities host-side too, so the
        # qual stream only crosses the link when the read bytes do
        self.transfer_quals = fastq and with_reads
        # lazy_replay: defer the host walk replay from the fetch (critical
        # path of the accept loop) to an idempotent cb.finish() the emission
        # worker calls — the replay's CPU then overlaps the next batch
        self.lazy_replay = lazy_replay
        self._locked = not with_reads  # meta-only buffers have nothing to size
        ch = _c.CHUNK
        self.nr_cap = (self._tier(int(batch * (est_bases / 4.0 / ch + 1) * self.FIRST_MARGIN))
                       if with_reads else 1)
        self.nq_cap = (self._tier(int(batch * (est_bases / ch + 1) * self.FIRST_MARGIN))
                       if self.transfer_quals else 1)
        self.np_cap = self.nr_cap if with_prehp else 0
        # event capacity (the rare fallback transfer; every batch with
        # with_prehp), in CHUNK-byte chunks
        self.ne_cap = self._tier(int(batch * (est_events * 4.0 / ch + 1) * self.FIRST_MARGIN))

    @staticmethod
    def _tier(n: int) -> int:
        """Round capacities up to 256-chunk steps."""
        return max(256, -(-n // 256) * 256)

    def _dispatch(self, out, force_events: bool = False):
        force_events = force_events or self.with_prehp
        caps = (self.nr_cap, self.ne_cap if force_events else 1, self.nq_cap, self.np_cap)
        buf = self._c.compact_pack(
            out.valid, out.total_len, out.head, out.tail, out.middle_ref,
            out.l_new, out.chrom, out.local_pos, out.is_reversed, out.n_events,
            out.capacity_overflow, out.ev_pos2x, out.ev_type, out.ev_len,
            out.m_ref_init, ne_cap=caps[1], with_events=force_events,
            with_checksum=self.replayer is not None and not force_events,
            read=out.read if self.with_reads else None,
            quals=out.quals if self.transfer_quals else None,
            nr_cap=caps[0], nq_cap=caps[2],
            prehp=out.read_prehp if self.with_prehp else None, np_cap=caps[3],
        )
        return buf, caps

    def dispatch(self, out) -> CompactHandle:
        buf, caps = self._dispatch(out)
        return CompactHandle(self, out, buf, caps)

    def _decode(self, buf_dev, B, caps, with_events):
        return self._c.decode_compact(
            buf_dev.cpu().numpy(), B, caps[0], caps[1], caps[2], fastq=self.transfer_quals,
            with_events=with_events or self.with_prehp, with_reads=self.with_reads,
            np_cap=caps[3])

    def _fetch(self, h: CompactHandle):
        B = h.out.valid.shape[0]
        cb, ok = self._decode(h.buf_dev, B, h.caps, with_events=False)
        if not ok:
            need_r, need_e, need_q, need_p = cb
            self.nr_cap = max(self.nr_cap, self._tier(int(need_r * 1.1) + 1))
            self.nq_cap = max(self.nq_cap, self._tier(int(need_q * 1.1) + 1))
            if self.with_prehp:
                self.ne_cap = max(self.ne_cap, self._tier(int(need_e * 1.15) + 1))
                self.np_cap = max(self.np_cap, self._tier(int(need_p * 1.1) + 1))
            self._locked = True
            buf_dev, caps = self._dispatch(h.out)
            cb, ok = self._decode(buf_dev, B, caps, with_events=False)
            if not ok:
                raise RuntimeError("compaction overflow after a capacity bump")
        elif not self._locked:
            # shrink to the first batch's need: the full capacity crosses
            # the link, so slack is wasted bandwidth
            need_r, _, need_q, need_p = cb.needs
            if self.with_reads:
                self.nr_cap = self._tier(int(need_r * self.LOCKED_MARGIN) + 1)
            if self.transfer_quals:
                self.nq_cap = self._tier(int(need_q * self.LOCKED_MARGIN) + 1)
            if self.with_prehp:
                self.np_cap = self._tier(int(need_p * self.LOCKED_MARGIN) + 1)
            self._locked = True
        cb.slots = getattr(h, "slots", None)
        if not self.with_reads:
            cb.recon = self.recon_info
        if self.replayer is None:
            return cb
        if self.lazy_replay:
            done = []

            def finish(fetcher=self, handle=h, batch=cb):
                if not done:
                    fetcher._replay_events(handle, batch)
                    done.append(True)

            cb.finish = finish
        else:
            self._replay_events(h, cb)
        return cb

    def _replay_events(self, h: CompactHandle, cb):
        """Regenerate event lists host-side; fall back to an exact device
        fetch for any lane failing checksum verification."""
        _c = self._c
        B = len(cb.valid)
        v = cb.valid & ~cb.cap_over
        ev_bytes = np.where(v, 4 * cb.n_events, 0)
        ch = -(-ev_bytes // _c.CHUNK)
        off_words = (np.cumsum(ch) - ch) * (_c.CHUNK // 4)
        total_words = int(ch.sum()) * (_c.CHUNK // 4)
        ev_out = np.zeros(max(total_words, 1), np.uint32)
        okl = self.replayer.replay(
            h.slots, v.astype(np.uint8), cb.m_ref, cb.n_events,
            cb.ev_checksum, ev_out, off_words,
        )
        bad = v & ~okl
        if not bad.any():
            cb.ev_flat = ev_out
            cb.ev_off = off_words
            return
        RUN_STATS.checksum_fallback_lanes += int(bad.sum())
        # rare exact fallback: pull the device's own event stream
        for _ in range(3):
            buf_dev, caps = self._dispatch(h.out, force_events=True)
            cb2, ok = self._decode(buf_dev, B, caps, with_events=True)
            if ok:
                cb.ev_flat = cb2.ev_flat
                cb.ev_off = cb2.ev_off
                return
            self.ne_cap = max(self.ne_cap, self._tier(int(cb2[1] * 1.15) + 1))
        raise RuntimeError("event fallback transfer kept overflowing")


class _OrderedIO:
    """Single-thread ordered file-write stage (the second pipeline stage
    behind the emit worker): composing the batch's bytes and writing them to
    the filesystem then overlap batch-to-batch."""

    def __init__(self, depth: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self.exc = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                if self.exc is None:
                    fn()
            except BaseException as e:
                self.exc = e
            finally:
                self._q.task_done()

    def submit(self, fn):
        if self.exc is not None:
            raise self.exc
        self._q.put(fn)

    def drain(self):
        self._q.join()
        if self.exc is not None:
            raise self.exc

    def close(self):
        self.drain()
        self._q.put(None)
        self._t.join()


class AsyncBatchWriter:
    """Pipelined wrapper around a batch writer.

    `write_batch` fetches the batch (device->host transfer) and counts the
    accepted lanes synchronously — the accept loop needs the count to track
    its quota — but hands the expensive formatting + file IO to a single
    worker thread (the C++ emitter and file writes run outside the GIL, so
    they overlap the next batch's transfers).  Queue depth is bounded so
    host memory stays flat; writes happen in submission order, keeping the
    output byte-identical to the synchronous path.

    A second `_OrderedIO` stage takes the file writes off the emit worker
    (writers that support it submit their composed bytes to `io_pool`), so
    walk replay + emission overlap the previous batch's first-touch page
    faults — the dominant host cost on memory-throttled VMs.
    """

    def __init__(self, inner, depth: int = 2):
        import queue
        import threading

        self.inner = inner
        self.error_log = getattr(inner, "error_log", None)
        self._q = queue.Queue(maxsize=depth)
        self._exc = None
        self._io = _OrderedIO()
        if hasattr(inner, "_write_flat"):
            inner.io_pool = self._io
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def enqueue_task(self, fn):
        """Run `fn` AFTER all previously queued writes have reached the
        FILES (resume-state checkpoints must not outrun them): enqueue a
        forwarding task so it lands on the io stage behind this batch's
        writes."""
        self._q.put(("task", lambda: self._io.submit(fn)))

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if self._exc is None:
                    if item[0] == "task":
                        item[1]()
                    else:
                        _, sim, d, lanes, start = item
                        self.inner.write_run(sim, d, lanes, start)
            except BaseException as e:  # surfaced on the producer side
                self._exc = e
            finally:
                self._q.task_done()

    def write_batch(self, sim, out, accepted_so_far: int, quota: int) -> int:
        if self._exc is not None:
            raise self._exc
        d = out.fetch()
        lanes = np.nonzero(d["valid"])[0][: quota - accepted_so_far]
        if len(lanes):
            self._q.put(("run", sim, d, lanes, accepted_so_far))
        return len(lanes)

    def write_run(self, sim, d, lanes, accepted_so_far: int) -> int:
        if self._exc is not None:
            raise self._exc
        if len(lanes):
            self._q.put(("run", sim, d, lanes, accepted_so_far))
        return len(lanes)

    def drain(self):
        self._q.join()
        self._io.drain()
        if self._exc is not None:
            raise self._exc

    def close(self):
        self.drain()
        self._q.put(None)
        self._t.join()
        self._io.close()
        if getattr(self.inner, "io_pool", None) is self._io:
            self.inner.io_pool = None


class ChimericBatchWriter:
    """Accept/number/emit a chimeric batch (genome mode).

    Names: ';'-joined per-segment `<chrom>_<pos>` components, `_chimeric`
    marker when > 1 segment, middle lengths joined with ';'
    (simulator.py:1390-1402).

    The metagenome parts of this writer (species-prefixed components,
    `gap_<len>` components, the base-level species-quota feedback) come with
    the metagenome mode and have no hook here yet.
    """

    def __init__(self, fastx: FastxWriter, error_log=None):
        self.fastx = fastx
        self.error_log = error_log
        from ..io.native import NativeEmitter

        self._emitter = NativeEmitter()
        if not self._emitter.available:
            raise RuntimeError("the chimeric writer needs native/fastwriter.cpp built with g++")

    @staticmethod
    def _name(g_names, idx: int, ns: int, chrom, pos, rev, head, mids, tail) -> str:
        comps = [f"{g_names[chrom[s]]}_{pos[s]}" for s in range(ns)]
        name = ";".join(comps) + f"_aligned_{idx}"
        if ns > 1:
            name += "_chimeric"
        name += "_R" if rev else "_F"
        return name + f"_{head}_{';'.join(str(mids[s]) for s in range(ns))}_{tail}"

    def _decode_meta(self, sim, h):
        from .chimeric_mode import decode_chimeric_meta

        S = sim.s_max
        d = decode_chimeric_meta(h.meta_dev.cpu().numpy(), S)
        if d["spill"].any():
            # packed lane capacity exceeded (vanishingly rare): identical
            # per-slot results via the unpacked program
            RUN_STATS.packed_spills += 1
            d = decode_chimeric_meta(sim.chimeric_meta_unpacked(h.slots, h.seed), S)
        return d

    def prepare_recon_chimeric(self, sim, h, accepted_so_far: int, quota: int):
        """Decode a meta-only chimeric batch and select its accepted lanes —
        the cheap sequential head of a batch.  The expensive replay+emit
        (`_write_recon_chimeric` with `prepared=`) can then run AFTER the
        next batch has been assigned and dispatched, overlapping host
        emission with device compute."""
        d = self._decode_meta(sim, h)
        lanes = np.nonzero(d["valid"])[0][: quota - accepted_so_far]
        return {"d": d, "lanes": lanes, "start": accepted_so_far}

    def _write_recon_chimeric(self, sim, h, accepted_so_far: int, quota: int,
                              lanes=None, start=None, prepared=None) -> int:
        """Host-reconstruct + emit a meta-only chimeric batch (genome mode):
        part-keyed C++ walk replays (checksum-verified) + C++ splicing of
        head | segments | gaps | tail."""
        from ..ops import rng as rng_mod

        S = sim.s_max
        G = max(S - 1, 1)
        if prepared is not None:
            d = prepared["d"]
            lanes = prepared["lanes"]
            start = prepared["start"]
        else:
            d = self._decode_meta(sim, h)
        if lanes is None:
            lanes = np.nonzero(d["valid"])[0][: quota - accepted_so_far]
            start = accepted_so_far
        if len(lanes) == 0:
            return 0
        k = len(lanes)
        slots = np.asarray(h.slots)
        g = sim.genome_host

        names = [
            self._name(g.names, start + rank, int(d["n_seg"][b]), d["chrom"][b], d["pos"][b],
                       d["rev"][b], d["head"][b], d["seg_mref"][b], d["tail"][b])
            for rank, b in enumerate(lanes)
        ]

        n_seg_l = d["n_seg"][lanes]
        seg_do = np.arange(S)[None, :] < n_seg_l[:, None]
        nev_flat = np.where(seg_do, d["n_events"][lanes], 0).reshape(-1)
        off_flat = np.concatenate([[0], np.cumsum(nev_flat)])[:-1]
        ev_out = np.zeros(max(int(nev_flat.sum()), 1), np.uint32)
        ok = sim._seg_replayer.replay(
            np.repeat(slots[lanes], S), seg_do.reshape(-1).astype(np.uint8),
            d["seg_mref_init"][lanes].reshape(-1), nev_flat,
            d["seg_cksum"][lanes].reshape(-1).astype(np.uint32),
            ev_out, off_flat,
            part_ids=np.tile(np.arange(S, dtype=np.int64) + rng_mod.PART_SEGMENT_BASE, k),
        )
        if not bool((ok | ~seg_do.reshape(-1)).all()):
            raise RuntimeError(
                "chimeric segment walk replay failed checksum verification; "
                "set NANOSIM_TPU_RECON=0 to fall back to device materialization"
            )

        gap_do = np.arange(G)[None, :] < (n_seg_l - 1)[:, None]
        gsteps = np.where(gap_do, d["gap_n_steps"][lanes], 0).reshape(-1)
        goff_flat = np.concatenate([[0], np.cumsum(gsteps)])[:-1]
        gev_out = np.zeros(max(int(gsteps.sum()), 1), np.uint32)
        gok = sim._gap_replayer.replay(
            np.repeat(slots[lanes], G), gap_do.reshape(-1).astype(np.uint8),
            d["gap_mref_init"][lanes].reshape(-1), gsteps,
            d["gap_cksum"][lanes].reshape(-1).astype(np.uint32),
            gev_out, goff_flat,
            part_ids=np.tile(np.arange(G, dtype=np.int64) + rng_mod.PART_GAP_BASE, k),
        )
        if not bool((gok | ~gap_do.reshape(-1)).all()):
            raise RuntimeError(
                "chimeric gap walk replay failed checksum verification; "
                "set NANOSIM_TPU_RECON=0 to fall back to device materialization"
            )

        with_events = self.error_log is not None
        qt = None
        if sim.fastq:
            qd = sim.tables.qual
            qt = (qd.breaks.cpu().numpy(), qd.vals.cpu().numpy())

        fastx_mv, err_mv = self._emitter.emit_chimeric_recon(
            seed=h.seed, stream=rng_mod.STREAM_ALIGNED, ht_cap=sim.ht_cap, S=S,
            slots=slots[lanes], names=names,
            total=d["total"][lanes], head=d["head"][lanes], tail=d["tail"][lanes],
            n_seg=n_seg_l, rev=d["rev"][lanes].astype(np.uint8),
            seg_part_off=d["seg_off"][lanes].reshape(-1),
            seg_lnew=d["seg_lnew"][lanes].reshape(-1),
            seg_mid=d["seg_mref"][lanes].reshape(-1),
            seg_goff=g.offsets[d["chrom"][lanes].reshape(-1)],
            seg_spos=d["pos"][lanes].reshape(-1),
            seg_ev_flat=ev_out, seg_ev_off=off_flat, seg_n_ev=nev_flat,
            gap_part_off=(d["seg_off"][lanes][:, :G]
                          + d["seg_lnew"][lanes][:, :G]).reshape(-1),
            gap_lnew=d["gap_len"][lanes].reshape(-1),
            gap_mid=d["gap_middle"][lanes].reshape(-1),
            gap_goff=g.offsets[np.clip(d["gap_chrom"][lanes].reshape(-1), 0,
                                       len(g.offsets) - 1)],
            gap_spos=d["gap_pos"][lanes].reshape(-1),
            gap_ev_flat=gev_out, gap_ev_off=goff_flat, gap_n_steps=gsteps,
            genome_flat=g.flat, fastq=sim.fastq, write_errors=with_events,
            qual_table=qt,
        )
        self.fastx.flush()
        self.fastx.f.write(fastx_mv)
        if with_events:
            self.error_log.write_bytes(err_mv)
        return k

    def write_batch(self, sim, out, accepted_so_far: int, quota: int,
                    lanes=None, start=None, prepared=None) -> int:
        from .chimeric_mode import ChimericReconHandle

        if isinstance(out, ChimericReconHandle):
            return self._write_recon_chimeric(sim, out, accepted_so_far, quota,
                                              lanes, start, prepared=prepared)
        # a device-materialized batch: only what the emitters read crosses
        # the link — the accepted lanes' reads up to the longest total, and
        # the event rows of their active segments up to the longest event list
        import torch

        if lanes is None:
            lanes = np.nonzero(out.valid.cpu().numpy())[0][: quota - accepted_so_far]
        if start is not None:
            accepted_so_far = start
        if len(lanes) == 0:
            return 0
        dev = out.valid.device
        lane_t = torch.as_tensor(np.asarray(lanes, np.int64), device=dev)

        def host(x):
            return x[lane_t].cpu().numpy()

        total = host(out.total_len)
        head = host(out.head)
        tail = host(out.tail)
        n_seg = host(out.n_seg)
        seg_mref = host(out.seg_middle_ref)
        seg_off = host(out.seg_offset)
        chrom = host(out.chrom)
        pos = host(out.local_pos)
        rev = host(out.is_reversed)
        n_events = host(out.n_events)
        max_total = max(int(total.max()), 1)
        reads = out.read[lane_t, :max_total].cpu().numpy()
        quals = out.quals[lane_t, :max_total].cpu().numpy() if sim.fastq else None
        hp_mode = getattr(sim, "kmer_bias", None) is not None

        g = sim.genome_host
        B = out.valid.shape[0]
        k, S = seg_mref.shape
        with_events = self.error_log is not None
        names = [
            self._name(g.names, accepted_so_far + r, int(n_seg[r]), chrom[r], pos[r], rev[r],
                       head[r], seg_mref[r], tail[r])
            for r in range(k)
        ]

        # compact event rows: one per (accepted lane, active segment)
        seg_do = np.arange(S)[None, :] < n_seg[:, None]
        ev_rows = np.zeros((k, S), np.int64)
        ev_rows[seg_do] = np.arange(int(seg_do.sum()))
        if with_events:
            rows_dev = (np.arange(S, dtype=np.int64)[None, :] * B
                        + np.asarray(lanes, np.int64)[:, None])[seg_do]
            rows_t = torch.as_tensor(rows_dev, device=dev)
            max_ne = max(int(n_events[seg_do].max()) if seg_do.any() else 0, 1)
            ev_pos2x = out.ev_pos2x[rows_t, :max_ne].cpu().numpy()
            ev_type = out.ev_type[rows_t, :max_ne].cpu().numpy()
            ev_len = out.ev_len[rows_t, :max_ne].cpu().numpy()
        else:
            ev_pos2x = ev_type = ev_len = np.zeros((1, 1), np.int32)

        if not hp_mode:
            # C++ batch formatter (records + per-segment error log)
            fastx_bytes, err_bytes = self._emitter.emit_chimeric(
                reads=reads,
                quals=quals,
                lanes=np.arange(k, dtype=np.int64),
                names=names,
                total_len=total,
                rev=rev,
                n_seg=n_seg,
                seg_off=seg_off,
                ev_row=ev_rows,
                n_events_rs=(n_events if with_events else np.zeros((k, S), np.int64)),
                ev_pos2x=ev_pos2x,
                ev_type=ev_type,
                ev_len=ev_len,
                g_off=g.offsets[chrom],
                g_len=g.lengths[chrom],
                g_circ=np.ascontiguousarray(g.circular[chrom], np.uint8),
                start_pos=pos,
                genome_flat=g.flat,
                fastq=sim.fastq,
                write_errors=with_events,
            )
            self.fastx.flush()
            self.fastx.f.write(fastx_bytes)
            if with_events:
                self.error_log.write_bytes(err_bytes)
            return k

        # -hp rewrites homopolymer runs AFTER the logged pass-1 mutation, so
        # the log is cut from the pre-resize segment buffers, event by event
        for r in range(k):
            self.fastx.write(names[r], reads[r, : total[r]],
                             quals[r, : total[r]] if sim.fastq else None)
        if with_events:
            prehp = out.seg_read_prehp[rows_t].cpu().numpy()
            self.error_log.write_bytes(self._hp_log_bytes(
                g, names, n_seg, n_events, ev_rows, ev_pos2x, ev_type, ev_len, prehp, chrom, pos))
        return k

    @staticmethod
    def _hp_log_bytes(g, names, n_seg, n_events, ev_rows, ev_pos2x, ev_type, ev_len, prehp,
                      chrom, pos) -> bytes:
        """The -hp ground-truth log of a device-materialized batch: per read
        and active segment, the rows of `_prehp_log_rows` from the segment's
        events and its pass-1 bytes (`ev_rows[r, s]` is the segment's row in
        the compact event and `prehp` arrays)."""
        rows = []
        for r, name in enumerate(names):
            for s in range(int(n_seg[r])):
                ne = int(n_events[r, s])
                if ne == 0:
                    continue
                row = ev_rows[r, s]
                ty = ev_type[row, :ne].astype(np.int64)
                keys_v, rpos_v, lens_v = event_read_positions(
                    ev_pos2x[row, :ne].astype(np.int64), ty, ev_len[row, :ne].astype(np.int64))
                mid = prehp[row].tobytes().decode("latin-1")
                seg_rows = _prehp_log_rows(name, keys_v, ty, lens_v, rpos_v, mid, g,
                                           int(chrom[r, s]), int(pos[r, s]))
                rows.extend(reversed(seg_rows))
        return "".join(rows).encode("latin-1")
