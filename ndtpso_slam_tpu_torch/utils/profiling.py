"""Rate meter around the scan callback, spans, and profiler traces.

Port of ``ndtpso_slam_tpu/utils/profiling.py``: :class:`RateMeter` keeps the
reference's average publish rate and instantaneous matching rate
(``ndtpso_slam_node.cpp:183-184,232-240``); :func:`trace` wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler``.

Spans.  :func:`span` marks one phase of the program at a layer boundary
(``node.scan`` > ``step.load``, ``step.align`` > ``solve.bind``,
``solve.pack``, ``k1.launch`` / ``k2.launch``, ``step.rescore``; then
``step.map_update`` (the map's update and build), ``step.raster``,
``node.pose_fetch``, ``node.export``; ``batch.call`` > ``solve.bind``,
``solve.pack``, ``k2.launch``).  Recording is on while a ``torch.profiler``
session runs, or inside :func:`recording`; a span then enters a
``user_annotation`` of its name in the profiler's trace (when a profiler
runs) and appends a record (name, request id, parent, thread, start, end)
to a bounded buffer in memory, which the profiler cannot lose (ROADMAP T1).
Off, a span is one check of the profiler's state that returns a shared
no-op context: no clock read, no allocation (0.5-0.6 µs a ``with`` on an
H100's host).  A span never
reads a device tensor, synchronizes or launches device work.  A root span
(``node.scan``: the node's step; ``batch.call``: a count of the process's
``solve_batch`` calls) names a request id that its spans inherit.

The spans' clock is the exported Chrome trace's: start and end are in the
µs of its ``ts``, unix time less ``baseTimeNanoseconds``, which libkineto
(``ChromeTraceBaseTime``) and torch 2.13's exporter
(``torch/profiler/_chrome_trace_export.py:_trimester_base_ns``) both take as
the unix time floored to 7,889,238-second intervals.  Device operations of
the same trace share that clock.  Against each span's ``user_annotation``
(torch 2.11.0+cu128 on an NVIDIA H100's host, 2 x 60 spans), the start
reads 3-40 µs earlier (median 18 µs, and up to 134 µs in a process's first
profiler session: the span opens before the annotation does) and the end
1-6 µs later; with torch 2.13 on a CPU the median of both gaps is 1-2 µs.

Use::

    with profiling.trace("traces"):     # Chrome trace + spans.jsonl
        node.process_scan(...)

    with profiling.recording():         # spans alone, no profiler
        node.process_scan(...)
    records = profiling.spans()

:func:`trace` writes the spans of its block beside the Chrome trace, one
JSON record per line, and says on standard error how many of them the
Chrome trace lost.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from collections import Counter
from typing import List, NamedTuple, Optional

import torch

_profiler_on = torch._C._autograd._profiler_enabled
_annotation_enter = torch._C._autograd._record_function_with_args_enter
_annotation_exit = torch._C._autograd._record_function_with_args_exit

CAPACITY = 1 << 20  # records the buffer holds
TRACE_BASE_PERIOD_S = 7_889_238  # libkineto's ChromeTraceBaseTime interval


class RateMeter:
    """Average and instantaneous rate of a repeated operation."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.last_elapsed: float = 0.0
        self.count: int = 0

    def tick(self):
        """Context manager timing one iteration."""
        return _Tick(self)

    @property
    def matching_rate_hz(self) -> float:
        """Instantaneous rate of the last iteration (``1/elapsed``)."""
        return 1.0 / self.last_elapsed if self.last_elapsed > 0 else 0.0

    @property
    def average_rate_hz(self) -> float:
        """Cumulative average rate since the first iteration."""
        if self.start_time is None or self.count == 0:
            return 0.0
        total = time.monotonic() - self.start_time
        return self.count / total if total > 0 else 0.0


class _Tick:
    def __init__(self, meter: RateMeter):
        self._m = meter

    def __enter__(self):
        now = time.monotonic()
        if self._m.start_time is None:
            self._m.start_time = now
        self._t0 = now
        return self

    def __exit__(self, *exc):
        self._m.last_elapsed = time.monotonic() - self._t0
        self._m.count += 1


# -------------------------------------------------------------------- spans


class Span(NamedTuple):
    """One recorded span; ``parent`` indexes the list :func:`spans` returns
    (-1 for a root), ``request`` is its root's request id (-1 if none),
    ``thread`` the OS thread id (the trace's ``tid``), ``start_us`` and
    ``end_us`` on the Chrome trace's clock (``end_us`` None while open)."""

    name: str
    request: int
    parent: int
    thread: int
    start_us: float
    end_us: Optional[float]


class SpanRecorder:
    """A bounded buffer of spans: a full buffer drops new records and counts
    them in ``dropped``."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self.forced = 0  # open recording() blocks
        self.records: list = []  # [name, request, parent, thread, start ns, end ns]
        self._lock = threading.Lock()
        self._local = threading.local()

    def _thread(self):
        """This thread's open spans [(index, request)] and OS thread id, the
        id read once: ``get_native_id`` is a system call (9 µs on an H100's
        host)."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack, local.tid

    def open(self, name: str, request: Optional[int], start_ns: int):
        """Append an open record; returns (the record or None if dropped,
        the thread's stack, which the caller pops on close)."""
        stack, tid = self._thread()
        parent, inherited = stack[-1] if stack else (-1, -1)
        request = inherited if request is None else request
        with self._lock:
            if len(self.records) < self.capacity:
                index = len(self.records)
                rec = [name, request, parent, tid, start_ns, None]
                self.records.append(rec)
            else:
                index, rec = -1, None
                self.dropped += 1
        stack.append((index, request))
        return rec, stack

    def clear(self) -> None:
        with self._lock:
            self.records = []
            self.dropped = 0

    def spans(self, since: int = 0) -> List[Span]:
        """The records from index ``since`` on, their parents indexing the
        list returned (-1 for a parent before ``since``)."""
        base = _trace_base_ns()
        us = lambda ns: (ns - base) / 1e3
        return [Span(n, r, p - since if p >= since else -1, t, us(s),
                     None if e is None else us(e))
                for n, r, p, t, s, e in self.records[since:]]


RECORDER = SpanRecorder()


def _trace_base_ns() -> int:
    """The ``baseTimeNanoseconds`` of a Chrome trace exported now."""
    return (int(time.time()) // TRACE_BASE_PERIOD_S) * TRACE_BASE_PERIOD_S * 1_000_000_000


class _Span:
    __slots__ = ("_name", "_request", "_rec", "_stack", "_annotation")

    def __init__(self, name: str, request: Optional[int]):
        self._name = name
        self._request = request

    def __enter__(self):
        start = time.time_ns()
        self._annotation = _annotation_enter(self._name) if _profiler_on() else None
        self._rec, self._stack = RECORDER.open(self._name, self._request, start)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        if self._annotation is not None:
            _annotation_exit(self._annotation)
        end = time.time_ns()
        if self._rec is not None:
            self._rec[5] = end
        return False


_OFF = contextlib.nullcontext()


def span(name: str, request: Optional[int] = None):
    """A context manager around one phase named ``name`` (module docstring);
    ``request`` gives a root span its request id.  While recording is off,
    the one shared no-op context."""
    if _profiler_on() or RECORDER.forced:
        return _Span(name, request)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans in the block without a profiler."""
    RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        RECORDER.forced -= 1


def spans() -> List[Span]:
    """Every span the buffer holds, oldest first."""
    return RECORDER.spans()


def clear() -> None:
    """Empty the buffer and its count of dropped records."""
    RECORDER.clear()


def _lost_spans(held: List[Span], chrome_trace_path: str) -> int:
    """How many of the closed spans ``held`` have no ``user_annotation`` of
    their name in a Chrome trace, counted by name."""
    with open(chrome_trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    found = Counter(e.get("name") for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    want = Counter(s.name for s in held if s.end_us is not None)
    return sum(max(0, n - found[name]) for name, n in want.items())


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a GPU is present) and write a Chrome trace (view it in
    Perfetto or chrome://tracing) under ``logdir`` on exit, and beside it
    the block's spans (``<trace>.spans.jsonl``: one JSON record of
    :class:`Span` per line, on the trace's clock).  Prints on standard
    error how many of the block's spans the Chrome trace lost (ROADMAP T1).
    Yields ``logdir``; the default is ``ndtpso_trace`` in the temporary
    directory (``/tmp/ndtpso_trace`` unless ``TMPDIR`` says otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "ndtpso_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    first = len(RECORDER.records)
    try:
        with prof:
            yield logdir
    finally:
        stem = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}")
        prof.export_chrome_trace(stem + ".json")
        held = RECORDER.spans(since=min(first, len(RECORDER.records)))
        with open(stem + ".spans.jsonl", "w") as f:
            for s in held:
                f.write(json.dumps(s._asdict()) + "\n")
        print(f"[ndtpso] trace: the Chrome trace lost {_lost_spans(held, stem + '.json')} of "
              f"{len(held)} spans", file=sys.stderr)
