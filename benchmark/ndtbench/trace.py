"""The traced window: torch.profiler over a few steps or calls, read back.

torch.profiler loses records, whole windows of them, somewhere 25-118 s
into a process (ROADMAP §3, T1).  So the windows are short and come right
after set-up, and each is checked against the program's own launch counter:
the kernel of the cell (K1 or K2) must appear in the trace exactly as often
as its wrapper counted launches in the window.  A window that lost records
is taken again.  The device's numbers come from a window that records the
device alone; a second window, which records the host's operations too,
labels the idle gaps.

The trace is exported as a Chrome trace into the temporary directory, read,
and deleted.  A :class:`View` holds what the per-layer readers
(``metrics/*.py``) read: the device operations (kernels, copies and sets)
with their times, the window's length, the busy time (the union of the
device operations' intervals) and the shapes the bounds need.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class View:
    kind: str  # "node" or "batch"
    units: int  # scans or calls in the window
    window_s: float  # the device-only traced window, host clock
    plain_s: float  # the same window untraced just before, host clock
    busy_s: float
    kernels: List[Tuple[str, float, float]]  # (name, start us, duration us)
    device_ops: List[Tuple[str, float, float]]  # kernels, copies and sets
    shape: dict  # batch, n_pts, population, iterations
    tries: int  # windows taken
    breakdown: dict


def _union(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi), and
    the gaps between them, [(start, end)]."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += max(0.0, e - max(s, cur))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


def _host_labels(host, times):
    """For each of the sorted ``times``, the innermost host operation running
    then (host operations of one thread nest), or None."""
    order = sorted(host, key=lambda h: (h[1], -h[2]))
    stack, out, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] <= order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def read_trace(path: str) -> Tuple[list, list, Optional[Tuple[float, float]]]:
    """(device operations (name, start us, end us, category), the host
    operations of the window's thread (name, start us, end us), the
    window) of a Chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    window, tid = None, None
    for e in events:
        if e.get("cat") in HOST_CATS and e.get("name") == WINDOW:
            window = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            tid = e.get("tid")
    dev, host = [], []
    for e in events:
        cat, s = e.get("cat"), float(e.get("ts", 0.0))
        end = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", ""), s, end, cat))
        elif cat in HOST_CATS and e.get("tid") == tid and e.get("name") != WINDOW:
            host.append((e.get("name", ""), s, end))
    return dev, host, window


def _top(d: dict, top: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(dev) -> list:
    """The device operations that took most time, [[name, seconds]]."""
    by_op = defaultdict(float)
    for name, s, e, _ in dev:
        by_op[name] += (e - s) * 1e-6
    return _top(by_op)


def idle_gaps(dev, host, window) -> list:
    """The idle gaps of ``window`` summed by what the host was doing at each
    gap's midpoint, [[label, seconds]]."""
    lo, hi = window
    _, gaps = _union([(s, e) for _, s, e, _ in dev], lo, hi)
    by_host = defaultdict(float)
    labels = _host_labels(host, [(s + e) / 2 for s, e in gaps])
    for (s, e), label in zip(gaps, labels):
        by_host[label or "python (no operation)"] += (e - s) * 1e-6
    return _top(by_host)


def _take(window, counter, kernel, acts, annotate: bool, tries: int):
    """Windows under torch.profiler with ``acts`` until one holds exactly as
    many kernels that ``kernel(name)`` picks as ``counter()`` counted
    launches in it: (device operations, host operations, units, the window
    (start, end) us on the trace's clock, or None without ``annotate``, the
    window's host seconds, windows taken)."""
    import torch
    from torch.profiler import profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    last = None
    for attempt in range(1, tries + 1):
        sync()
        before = counter()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if annotate:
                with record_function(WINDOW):
                    units = window()
                    sync()
            else:
                units = window()
                sync()
            host_s = time.perf_counter() - t0
        launched = counter() - before
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            dev, host, span = read_trace(path)
        finally:
            os.remove(path)
        own = sum(1 for name, *_ in dev if kernel(name))
        last = (own, launched)
        if own == launched and (span is not None or not annotate):
            return dev, host, units, span, host_s, attempt
    raise RuntimeError(f"the profiler kept {last[0]} of {last[1]} launches of the cell's kernel "
                       f"in each of {tries} windows (ROADMAP T1)")


def traced(window: Callable[[], int], counter: Callable[[], int], kernel: Callable[[str], bool],
           kind: str, shape: dict, tries: int = 6) -> View:
    """``window()`` (it returns how many scans or calls it made) once
    untraced, timed by the host clock from one synchronisation to the next,
    then in two traced windows, each taken again until it holds every
    launch of the cell's kernel (:func:`_take`).  The first records the
    device alone: the kernels and the busy time come from it.  Tracing
    slows the host (CUPTI's cost per launch; the second window also records
    the host's operations), so the idle share sets the busy time against
    the untraced window; the second window only labels the idle gaps of the
    breakdown by what the host was doing."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    window()
    sync()
    plain_s = time.perf_counter() - t0
    dev_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    dev, _, units, _, window_s, tries_dev = _take(window, counter, kernel, dev_acts, False, tries)
    lo = min((s for _, s, _, _ in dev), default=0.0)
    hi = max((e for _, _, e, _ in dev), default=0.0)
    busy, _ = _union([(s, e) for _, s, e, _ in dev], lo, hi)
    full = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    h_dev, host, _, span, _, tries_host = _take(window, counter, kernel, full, True, tries)
    return View(kind=kind, units=units, window_s=window_s, plain_s=plain_s, busy_s=busy * 1e-6,
                kernels=[(n, s, e - s) for n, s, e, c in dev if c == "kernel"],
                device_ops=[(n, s, e - s) for n, s, e, _ in dev], shape=shape,
                tries=tries_dev + tries_host,
                breakdown={"device_ops": device_ops(dev),
                           "idle_gaps": idle_gaps(h_dev, host, span)})


def idle_pct(ctx):
    """The share of the untraced window in which no device operation
    (kernel, copy or set) runs, in percent: one less the device-only
    trace's busy time over the untraced window's length (the same scans or
    calls); None without device operations."""
    t = ctx.trace
    if t is None or not t.device_ops or t.plain_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.plain_s)
