"""The program's own spans over the traced window, read for the per-layer
metrics of the host's phases.

The program records spans in memory while a profiler runs
(``ndtpso_slam_tpu_torch/utils/profiling.py``), on the Chrome trace's
clock, so they line up with the device operations of the traced window
(``trace.View.device_ops``) as they are.  The window's spans are the trees
whose root span (``node.scan`` for the node, ``batch.call`` for the batch
matcher) overlaps the device-only window, from its first device operation's
start to its last one's end: the host-traced window and any window taken
again lie outside it.  A span's self time is its duration less the part of
it its child spans cover.  So the node's phases (each scan's leaf spans'
self times, ``k1.launch``'s, and the self time of ``node.scan`` and
``step.align``) add up to the mean ``node.scan``.

The device-only window runs under CUPTI, which adds its cost to each launch
on the host; both sides of a comparison carry it.  A program without the
span recorder gives no spans, and every reader then returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

ROOTS = {"node": "node.scan", "solve_batch": "batch.call"}


def recorded() -> list:
    """The spans the program recorded in this process (``profiling.spans()``),
    or [] where the program has no span recorder.  Imported here, at read
    time: loading a reader loads nothing of the program."""
    from ndtpso_slam_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def _union(intervals, lo, hi) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    covered, cur = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, lo, cur), min(e, hi)
        if e > s:
            covered += e - s
            cur = e
    return covered


class Window:
    """The spans of one traced window: ``roots`` (indices of the root spans
    named ``root`` that overlap ``[lo, hi]`` us) and every span under them,
    with each span's self time in us."""

    def __init__(self, spans: Sequence, root: str, lo: float, hi: float):
        root_of: Dict[int, int] = {}
        for i, s in enumerate(spans):
            if s.end_us is None:
                continue
            if s.parent < 0:
                root_of[i] = i
            elif s.parent in root_of:
                root_of[i] = root_of[s.parent]
        self.roots = [i for i, r in root_of.items() if i == r and spans[i].name == root
                      and spans[i].start_us < hi and spans[i].end_us > lo]
        kept = set(self.roots)
        members = [i for i, r in root_of.items() if r in kept]
        children = defaultdict(list)
        for i in members:
            if spans[i].parent >= 0:
                children[spans[i].parent].append(i)
        self.spans = spans
        self.self_us = {}
        for i in members:
            s = spans[i]
            inner = [(spans[c].start_us, spans[c].end_us) for c in children[i]]
            self.self_us[i] = (s.end_us - s.start_us) - _union(inner, s.start_us, s.end_us)

    def of(self, names: Sequence[str]) -> List[int]:
        return [i for i in self.self_us if self.spans[i].name in names]


def window(ctx, spans: Optional[Sequence] = None) -> Optional[Window]:
    """The spans of the device-only traced window of ``ctx`` (``spans``:
    the program's, :func:`recorded`, by default), or None without a device
    window or without a root span in it."""
    t = ctx.trace
    root = ROOTS.get(ctx.kind)
    if t is None or root is None or not t.device_ops:
        return None
    lo = min(s for _, s, _ in t.device_ops)
    hi = max(s + d for _, s, d in t.device_ops)
    w = Window(recorded() if spans is None else spans, root, lo, hi)
    return w if w.roots else None


def self_ms_per_root(ctx, names: Sequence[str], spans=None) -> Optional[float]:
    """The self time of the spans named ``names`` summed over the window, in
    ms, per root span (scan or call); None where no such span ran."""
    w = window(ctx, spans)
    found = w.of(names) if w else []
    if not found:
        return None
    return sum(w.self_us[i] for i in found) / len(w.roots) / 1e3


def self_us_per_span(ctx, name: str, spans=None) -> Optional[float]:
    """The mean self time of the spans named ``name`` in the window, in us."""
    w = window(ctx, spans)
    found = w.of((name,)) if w else []
    if not found:
        return None
    return sum(w.self_us[i] for i in found) / len(found)


def root_ms(ctx, spans=None) -> Optional[float]:
    """The mean duration of the window's root spans, in ms."""
    w = window(ctx, spans)
    if w is None:
        return None
    return sum(w.spans[i].end_us - w.spans[i].start_us for i in w.roots) / len(w.roots) / 1e3
