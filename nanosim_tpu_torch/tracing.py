"""Spans and counters inside the program, on only while a torch profiler
session runs.

    with tracing.span("emit", batch=slot_start):
        ...
    tracing.count("batches.fetched")

With the profiler off, `span` returns one shared null context and `count`
returns at once: no clock is read and nothing is allocated.  With it on, a
span records a row ``(name, start_s, end_s, depth, batch)`` on
`time.perf_counter()` in the process-wide `RECORDER` (depth: the spans open
around it in its thread; batch: the first slot of the batch it serves) and
opens `torch.profiler.record_function(name)`, so that the profiler's own
trace holds the span and links each kernel launched inside it to it
(`export_chrome_trace` shows which stage launched which device op).  The
recorder starts afresh at the first span or count of a new profiler
session, so after a session it holds that session's rows and counts.

A span's self time is its length less the spans nested inside it in its
thread.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
import torch.autograd.profiler as _prof

_clock = time.perf_counter

if hasattr(_prof, "_is_profiler_enabled"):
    def profiling() -> bool:
        """Whether a torch profiler session runs (a flag torch keeps for
        fast checks, set by every profiler's start and cleared by its stop)."""
        return _prof._is_profiler_enabled
else:
    profiling = torch._C._autograd._profiler_enabled


class Recorder:
    """The rows, counts and self seconds of the current profiler session."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self):
        self.rows = []  # (name, start_s, end_s, depth, batch)
        self.counts = {}
        self._self = {}
        self.live = False  # False until the session's first span or count

    def self_seconds(self) -> dict:
        """Self seconds by span name."""
        with self._lock:
            return dict(self._self)

    def _open(self):
        """The calling thread's stack of open spans, after starting afresh
        if this is a new session's first span or count."""
        if not self.live:
            with self._lock:
                if not self.live:
                    self.reset()
                    self.live = True
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


RECORDER = Recorder()
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "batch", "stack", "rf", "t0", "inner")

    def __init__(self, name, batch):
        self.name = name
        self.batch = batch

    def __enter__(self):
        self.stack = RECORDER._open()
        self.stack.append(self)
        self.inner = 0.0
        self.rf = _prof.record_function(self.name)
        self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        self.rf.__exit__(*exc)
        stack = self.stack
        stack.pop()
        length = t1 - self.t0
        if stack:
            stack[-1].inner += length
        batch = self.batch
        if hasattr(batch, "__len__"):
            batch = batch[0] if len(batch) else None
        if batch is not None:
            batch = int(batch)
        rec = RECORDER
        with rec._lock:
            rec.rows.append((self.name, self.t0, t1, len(stack), batch))
            rec._self[self.name] = rec._self.get(self.name, 0.0) + length - self.inner
        return False


def span(name: str, batch=None):
    """A span around the block; `batch` is the batch's first slot, or its
    slot array (whose first entry is taken once the span ends)."""
    if not profiling():
        RECORDER.live = False
        return _NULL
    return _Span(name, batch)


def count(name: str, n: int = 1) -> None:
    if not profiling():
        RECORDER.live = False
        return
    RECORDER._open()
    with RECORDER._lock:
        RECORDER.counts[name] = RECORDER.counts.get(name, 0) + n


def traced(name: str):
    """Decorator: the function's every call inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap
