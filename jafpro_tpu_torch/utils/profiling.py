"""Timing and tracing helpers (port of ``jafpro_tpu/utils/profiling.py``):
a step timer that waits for the card's queued work, a ``torch.profiler``
trace for TensorBoard or ``chrome://tracing``, and the program's spans.

A span (``span(name)``) marks one piece of the program's work: its name,
its start and end on ``time.time_ns()`` (the clock the profiler stamps its
host events with), its own id and its parent's (the innermost span open on
the same thread), the thread, the ``item`` it works on (the served group
or the training iteration; a span without one takes its parent's) and an
optional count ``n`` (bytes copied, clips). With ``device=True`` it also
records a pair of CUDA events on the current stream; their elapsed time,
``stream_ms``, is resolved only when the spans are read, so recording adds
no synchronize. "Stream ms" is the time between a span's two events on the
stream: it includes any time the stream waited for the host inside the
span, and is not the card's busy time. Without a card it is the host's.

Spans are recorded only while a ``torch.profiler`` runs (an operator's
``trace``, the benchmark's traced runs), on every thread, each also as a
``record_function`` range of its name (the profiler keeps the ranges of
the thread that started it), and are kept in memory (at most ``MAX_SPANS``; later
ones are dropped and counted) until ``spans()`` reads them. At any other
time ``span()`` returns a shared no-op context after one attribute read:
no CUDA event, no ``record_function``, nothing allocated. A caller that
needs its spans' times whatever the profiler does (``cli.serve``'s stats,
``VideoGenerator.time_stages``) passes ``keep``, a list each ended span is
appended to; such a span is recorded too only while the profiler runs.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 20


@contextlib.contextmanager
def step_timer(sync=True) -> Iterator[dict]:
    """``with step_timer() as t: ...`` -> ``t["seconds"]`` afterwards; with
    ``sync`` (and a card) it waits for the work queued on the card
    (``torch.cuda.synchronize``: the current device's, or ``sync``'s when
    it is a device) before it reads the clock."""
    out = {}
    t0 = time.perf_counter()
    yield out
    if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(None if sync is True else sync)
    out["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the host and, where there is a card, its device activity
    with ``torch.profiler`` into ``log_dir`` (TensorBoard's trace handler:
    one ``*.pt.trace.json`` per run). The program's spans are recorded
    meanwhile (``spans``)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class _Recorder:
    """The process's bounded buffer of ended spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ended: List["Span"] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.open = threading.local()     # .stack: this thread's open spans

    def stack(self) -> list:
        s = getattr(self.open, "stack", None)
        if s is None:
            s = self.open.stack = []
        return s

    def add(self, span: "Span") -> None:
        with self.lock:
            if len(self.ended) < MAX_SPANS:
                self.ended.append(span)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class Span:
    """One span; ``span()`` makes it, ``record()`` reads it once ended."""

    __slots__ = ("name", "id", "parent", "thread", "item", "n", "start_ns",
                 "end_ns", "device", "_events", "_ms", "_keep", "_range",
                 "_recorded")

    def __init__(self, name: str, device: bool, item, n, keep, recorded):
        self.name, self.device, self.item, self.n = name, device, item, n
        self._keep, self._recorded = keep, recorded
        self._events = self._ms = self._range = None
        self.id = next(_RECORDER.ids)

    def __enter__(self) -> "Span":
        stack = _RECORDER.stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        if self.item is None and up is not None:
            self.item = up.item
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        if self._recorded:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.time_ns()
        _RECORDER.stack().pop()
        if self._recorded:
            _RECORDER.add(self)
        if self._keep is not None:
            self._keep.append(self)
            self._keep = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def stream_ms(self) -> Optional[float]:
        """A device span's stream ms (waiting here for its end event; the
        host's ms without a card); None for a host span."""
        if self._ms is None and self.device:
            if self._events is None:
                self._ms = self.host_ms
            else:
                start, end = self._events
                end.synchronize()
                self._ms = float(start.elapsed_time(end))
                self._events = None
        return self._ms

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "item": self.item, "n": self.n,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": self.host_ms, "stream_ms": self.stream_ms}


class _Off:
    """The shared no-op span: ``with span(...) as s`` gives it, and it
    is false, so ``if s: s.n = ...`` skips the count."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False


_OFF = _Off()


def span(name: str, *, device: bool = False, item=None,
         n: Optional[int] = None, keep: Optional[list] = None):
    """A context that records the span ``name`` while the profiler runs
    (module docstring); with ``keep`` it is timed in any case and
    appended to ``keep`` when it ends."""
    if not (_autograd_profiler._is_profiler_enabled or keep is not None):
        return _OFF
    return Span(name, device, item, n, keep,
                _autograd_profiler._is_profiler_enabled)


def spans(since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> List[dict]:
    """The recorded spans that started at or after ``since_ns`` and ended
    at or before ``until_ns`` (``time.time_ns()``), by start, as dicts of
    ``Span.record``; device spans wait for their end events here."""
    with _RECORDER.lock:
        got = [s for s in _RECORDER.ended
               if (since_ns is None or s.start_ns >= since_ns)
               and (until_ns is None or s.end_ns <= until_ns)]
    return [s.record() for s in sorted(got, key=lambda s: s.start_ns)]


def dropped() -> int:
    """Spans not kept because the buffer held ``MAX_SPANS``."""
    return _RECORDER.dropped
