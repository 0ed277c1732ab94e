"""Spans and counts that the benchmark takes around its calls into the
program's layers, on objects it created itself.

A span is (name, start, end, depth) on the host's monotonic clock, kept in
memory.  Its self time is its length less the spans nested inside it.
"""

from __future__ import annotations

import functools
import time


class Spans:
    def __init__(self):
        self.rows = []  # (name, start_s, end_s, depth)
        self.counts = {}
        self._depth = 0

    def wrap(self, name: str, fn):
        """fn, recording a span around each call."""

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            self._depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                self.rows.append((name, t0, time.perf_counter(), self._depth))

        return timed

    def count(self, name: str, n: int = 1):
        self.counts[name] = self.counts.get(name, 0) + n

    def self_seconds(self, t0: float = float("-inf"), t1: float = float("inf")) -> dict:
        """Self time by span name, of the spans that start in [t0, t1)."""
        rows = sorted((r for r in self.rows if t0 <= r[1] < t1), key=lambda r: (r[1], r[3]))
        total = {}
        stack = []  # open (name, end, depth) enclosing the current row
        for name, s, e, d in rows:
            while stack and stack[-1][1] <= s:
                stack.pop()
            total[name] = total.get(name, 0.0) + (e - s)
            if stack:
                parent = stack[-1][0]
                total[parent] -= e - s
            stack.append((name, e, d))
        return total

    def reset(self):
        self.rows = []
        self.counts = {}
