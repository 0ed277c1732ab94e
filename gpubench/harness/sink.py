"""Where the writers' bytes go instead of the disk.

The writers' file objects (`FastxWriter.f`, `ErrorLogWriter.f`) are replaced
by sinks: every byte is formatted and handed over as on disk, the sink
counts it and keeps the records that the run will check, and nothing
reaches the disk, whose speed is the host's and not the program's, and
whose size would grow with every gain.

A record to keep is asked for before the program writes it (`Capture.want`,
from the emitter's call, which knows the read's name, its length and where
in the batch it lies).  The read's FASTQ record is found at the offset its
predecessors' lengths give; its log rows, whose sizes the call does not
know, are searched for from an estimate.
"""

from __future__ import annotations

import re


class Capture:
    """The records a run keeps, by pass and read index."""

    def __init__(self):
        self.kept = {}  # (pass, idx) -> {"record": bytes, "log": bytes}
        self._fastx = []  # (pass, idx, name, offset estimate) awaiting the FASTQ write
        self._log = []  # (pass, idx, name, fraction of the batch's log before the read)

    def want(self, pass_name: str, idx: int, name: str, fastx_offset: int, log_fraction: float,
             with_log: bool):
        self.kept[pass_name, idx] = {"record": None, "log": b"" if with_log else None}
        self._fastx.append((pass_name, idx, name, fastx_offset))
        if with_log:
            self._log.append((pass_name, idx, name, log_fraction))

    def drop(self, pass_name: str, idx: int):
        self.kept.pop((pass_name, idx), None)
        self._fastx = [w for w in self._fastx if w[:2] != (pass_name, idx)]
        self._log = [w for w in self._log if w[:2] != (pass_name, idx)]

    def on_fastx(self, mv):
        left = []
        for pass_name, idx, name, off in self._fastx:
            rec = _record_at(mv, name, off)
            if rec is None:
                left.append((pass_name, idx, name, off))
            elif (pass_name, idx) in self.kept:
                self.kept[pass_name, idx]["record"] = rec
        self._fastx = left

    def on_log(self, mv):
        left = []
        for pass_name, idx, name, frac in self._log:
            rows = _rows_of(mv, name, frac)
            if rows is None:
                left.append((pass_name, idx, name, frac))
            elif (pass_name, idx) in self.kept:
                self.kept[pass_name, idx]["log"] = rows
        self._log = left

    def reset(self):
        self.kept = {}
        self._fastx = []
        self._log = []


BLOCK_MAX = 4 << 20  # more bytes than one read's log rows take
_RECORD = re.compile(rb"[@>][^\n]*\n[^\n]*\n(?:\+\n[^\n]*\n)?")


def _record_at(mv, name: str, off: int):
    """The FASTA/FASTQ record of `name` in mv: at `off`, or anywhere."""
    head = name.encode() + b"\n"
    n = len(mv)
    if 0 <= off < n and bytes(mv[off + 1:off + 1 + len(head)]) == head:
        start = off
    else:
        m = re.compile(rb"(?:^|(?<=\n))[@>]" + re.escape(head)).search(mv)
        if m is None:
            return None
        start = m.start()
    m = _RECORD.match(mv, start)
    return None if m is None else bytes(mv[m.start():m.end()])


def _rows_of(mv, name: str, frac: float):
    """The block of log rows of `name` in mv, searched from about `frac` of
    the way in (then from the start), or None.  A search that starts inside
    the block finds one of its later rows: the block's first row is then
    the first match from a point before the block."""
    first = re.compile(rb"(?:^|(?<=\n))" + re.escape(name.encode() + b"\t"))
    n = len(mv)
    m = None
    for lo in (max(0, int(n * (frac - 0.08))), 0):
        m = first.search(mv, lo)
        if m is not None:
            break
    if m is None:
        return None
    m = first.search(mv, max(0, m.start() - BLOCK_MAX))
    block = re.compile(rb"(?:" + re.escape(name.encode() + b"\t") + rb"[^\n]*\n)+")
    b = block.match(mv, m.start())
    return bytes(mv[b.start():b.end()])


class Sink:
    """A file object that counts the bytes written to it and shows them to
    the capture."""

    def __init__(self, capture: Capture, kind: str):
        self.capture = capture
        self.kind = kind  # "fastx" or "log"
        self.bytes = 0

    def write(self, data):
        mv = memoryview(data).cast("B")
        self.bytes += len(mv)
        if self.kind == "fastx":
            if self.capture._fastx:
                self.capture.on_fastx(mv)
        elif self.capture._log:
            self.capture.on_log(mv)
        return len(mv)

    def flush(self):
        pass

    def close(self):
        pass
