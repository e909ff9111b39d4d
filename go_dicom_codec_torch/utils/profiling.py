"""Spans and counters of the codecs, the one-off event log, and the torch
profiler hook.

The recorder (``StageTimer``) is off by default: ``span()`` then returns
one shared no-op and ``count()`` returns at once, after one read of
``GLOBAL_TIMER``. ``enable_global_timer()`` installs a fresh recorder.
From then on each ``span`` records its name, thread, parent span and call
id (the id of the outermost span open on its thread), ``t0``/``t1`` on
``time.perf_counter`` and ``cpu0``/``cpu1`` on ``time.thread_time``, into
a buffer of its own thread; nothing is written out until ``drain()``.
Setting ``GLOBAL_TIMER`` to None turns recording off again; a span open at
that moment still lands in its recorder's buffer when it closes.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

# the fields of a drained span, in the order a buffer keeps them
FIELDS = ("name", "tid", "id", "parent", "call", "t0", "t1", "cpu0", "cpu1",
          "attrs")


class _NoSpan:
    """What ``span()`` returns while no recorder is installed."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Thread:
    """One thread's open spans and closed records."""

    __slots__ = ("tid", "stack", "records")

    def __init__(self) -> None:
        self.tid = threading.get_ident()
        self.stack: list = []
        self.records: list = []


class _Span:
    __slots__ = ("_rec", "_thread", "name", "attrs", "id", "parent", "call",
                 "t0", "cpu0")

    def __init__(self, rec: "StageTimer", name: str, attrs: dict) -> None:
        self._rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> "_Span":
        th = self._thread = self._rec._this_thread()
        up = th.stack[-1] if th.stack else None
        self.id = next(self._rec._ids)
        self.parent = up.id if up is not None else None
        self.call = up.call if up is not None else self.id
        th.stack.append(self)
        self.cpu0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        cpu1 = time.thread_time()
        th = self._thread
        th.stack.pop()
        th.records.append((self.name, th.tid, self.id, self.parent,
                           self.call, self.t0, t1, self.cpu0, cpu1,
                           self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span has started."""
        self.attrs.update(attrs)


class StageTimer:
    """The recorder: counters shared by every thread, under a lock, and
    the spans of each thread in a buffer of its own."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._threads: List[_Thread] = []
        self._ids = itertools.count(1)   # next() on it is atomic

    def _this_thread(self) -> _Thread:
        th = getattr(self._local, "th", None)
        if th is None:
            th = self._local.th = _Thread()
            with self._lock:
                self._threads.append(th)
        return th

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

    def drain(self) -> dict:
        """The spans closed so far, taken out of the buffers (a dict of
        ``FIELDS`` each, in the order each thread closed them), and the
        counters. Threads may go on recording meanwhile: what they close
        after a buffer is read stays for the next drain."""
        with self._lock:
            threads = list(self._threads)
        spans = []
        for th in threads:
            n = len(th.records)
            spans.extend(dict(zip(FIELDS, r)) for r in th.records[:n])
            del th.records[:n]
        with self._lock:
            counters = dict(self.counts)
        return {"spans": spans, "counters": counters}


# the process's recorder; None (the default) records nothing
GLOBAL_TIMER: Optional[StageTimer] = None


def enable_global_timer() -> StageTimer:
    """Install a fresh recorder and return it."""
    global GLOBAL_TIMER
    GLOBAL_TIMER = StageTimer()
    return GLOBAL_TIMER


def span(name: str, **attrs):
    """A context manager that records one span while a recorder is
    installed, and the shared ``NO_SPAN`` otherwise. Its ``set(**attrs)``
    adds attributes once they are known."""
    rec = GLOBAL_TIMER
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a recorder is installed."""
    rec = GLOBAL_TIMER
    if rec is not None:
        rec.count(name, n)


def log_event(name: str, payload: dict) -> None:
    """Record a one-off decision/observation: counts one under ``name``
    when a recorder is installed, and keeps the last payload per name for
    inspection (EVENTS)."""
    EVENTS[name] = dict(payload)
    count(name)


EVENTS: Dict[str, dict] = {}


@contextlib.contextmanager
def torch_trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace, with the card's kernels when CUDA
    is available, as a Chrome trace in ``log_dir`` (TensorBoard's
    ``*.pt.trace.json``, viewable in Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        try:
            yield
        finally:
            if cuda:   # the work in flight ends inside the trace
                torch.cuda.synchronize()
