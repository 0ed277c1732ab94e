"""sink.py's sink, finding the kept records by literal searches.

`sink.Sink` hands each write to `Capture.on_fastx` / `on_log`, which find a
kept read's log rows (and a record that is not at its expected offset) with
regular expressions that begin `(?:^|(?<=\\n))`.  The engine tries such a
pattern at every byte, about 45 ns a byte: 150-220 ms for each kept read in
a batch of 30 MB of log rows, all of it holding the interpreter, so that a
program with a second thread stops there too.  `LiteralSink` makes the same
searches for the line that begins with the name (a literal pattern, `\\n`
and the name, which the engine scans for at under a nanosecond a byte) and
keeps the same bytes in the same `Capture`.
"""

from __future__ import annotations

import re

from .sink import _RECORD, BLOCK_MAX, Sink


def _line_at(mv, key: bytes, lo: int) -> int:
    """The first position >= lo at which a line of mv begins with key
    (position 0 only where lo is 0), or -1."""
    if lo == 0 and bytes(mv[:len(key)]) == key:
        return 0
    m = re.compile(re.escape(b"\n" + key)).search(mv, max(lo - 1, 0))
    return -1 if m is None else m.start() + 1


def record_at(mv, name: str, off: int):
    """sink._record_at: the FASTA/FASTQ record of `name` in mv, at `off`
    or anywhere."""
    head = name.encode() + b"\n"
    if 0 <= off < len(mv) and bytes(mv[off + 1:off + 1 + len(head)]) == head:
        start = off
    else:
        found = [p for p in (_line_at(mv, b"@" + head, 0), _line_at(mv, b">" + head, 0))
                 if p >= 0]
        if not found:
            return None
        start = min(found)
    m = _RECORD.match(mv, start)
    return None if m is None else bytes(mv[m.start():m.end()])


def rows_of(mv, name: str, frac: float):
    """sink._rows_of: the block of log rows of `name` in mv, searched from
    about `frac` of the way in (then from the start), or None."""
    key = name.encode() + b"\t"
    at = -1
    for lo in (max(0, int(len(mv) * (frac - 0.08))), 0):
        at = _line_at(mv, key, lo)
        if at >= 0:
            break
    if at < 0:
        return None
    # a search that starts inside the block finds one of its later rows
    at = _line_at(mv, key, max(0, at - BLOCK_MAX))
    b = re.compile(rb"(?:" + re.escape(key) + rb"[^\n]*\n)+").match(mv, at)
    return None if b is None else bytes(mv[b.start():b.end()])


def _take(capture, waiting, mv, find, field: str) -> list:
    """Capture.on_fastx / on_log: fill the kept records found in mv; the
    rest wait for a later write."""
    left = []
    for pass_name, idx, name, hint in waiting:
        got = find(mv, name, hint)
        if got is None:
            left.append((pass_name, idx, name, hint))
        elif (pass_name, idx) in capture.kept:
            capture.kept[pass_name, idx][field] = got
    return left


class LiteralSink(Sink):
    """A `sink.Sink` whose capture searches are literal."""

    def write(self, data):
        mv = memoryview(data).cast("B")
        self.bytes += len(mv)
        c = self.capture
        if self.kind == "fastx":
            if c._fastx:
                c._fastx = _take(c, c._fastx, mv, record_at, "record")
        elif c._log:
            c._log = _take(c, c._log, mv, rows_of, "log")
        return len(mv)
