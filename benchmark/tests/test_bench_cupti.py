"""The card's busy time (``ndtbench/cupti.py``) from activity records as
CUPTI lays them out, read through a stand-in for the library, over the
window and within each step between marks, and the readers of the node's
metrics: each reads only in the runs it belongs to."""

import ctypes
import struct
import threading
import types

import numpy as np
import pytest

import bench_small  # noqa: F401  (puts the benchmark on sys.path)
from ndtbench import cell, cupti
from ndtbench.harness import Context

RUNTIME = 5  # a record of another kind, which the clock leaves out


class FakeCupti:
    """CUPTI's activity calls over one buffer of records, with the host's
    timestamp fixed at ``now``."""

    def __init__(self, records, now):
        size = 32
        self.raw = ctypes.create_string_buffer(size * len(records))
        for i, (kind, start, end) in enumerate(records):
            struct.pack_into("<I12xQQ", self.raw, i * size, kind, start, end)
        self.base, self.size, self.valid, self.now = (ctypes.addressof(self.raw), size,
                                                      size * len(records), now)

    def cuptiActivityGetNextRecord(self, buf, valid, ref):
        rec = ref._obj
        nxt = buf if rec.value is None else rec.value + self.size
        if nxt >= buf + valid:
            return 12  # CUPTI_ERROR_MAX_LIMIT_REACHED
        rec.value = nxt
        return 0

    def cuptiGetTimestamp(self, ref):
        ref._obj.value = self.now
        return 0

    def __getattr__(self, name):
        return lambda *args: 0


def clock_over(records, lo, hi, dropped=0):
    lib = FakeCupti(records, hi)
    clock = object.__new__(cupti.DeviceClock)
    clock.lib, clock._buffers, clock.dropped, clock._lock = lib, {}, dropped, threading.Lock()
    clock._full, clock._lo, clock.marks = [(lib.base, lib.valid)], lo, []
    return clock


def test_union_is_the_covered_length():
    rng = np.random.default_rng(5)
    for _ in range(100):
        s = rng.integers(0, 1000, 30)
        e = s + rng.integers(0, 120, 30)
        covered = np.zeros(1200, bool)
        for a, b in zip(s, e):
            covered[a:b] = True
        assert cupti.union_ns(s, e) == int(covered.sum())


def test_clock_reads_kernels_copies_and_sets():
    clock = clock_over([(cupti.CONCURRENT_KERNEL, 100, 150), (cupti.MEMCPY, 140, 160),
                        (RUNTIME, 0, 10**12), (cupti.MEMSET, 200, 205),
                        (cupti.CONCURRENT_KERNEL, 300, 310)], lo=90, hi=400)
    clock.stop(lambda: None)
    assert clock.busy_s == pytest.approx(75e-9, rel=1e-12)
    assert (clock.kernels, clock.ops) == (2, 4)


def test_clock_leaves_out_an_untimed_record():
    clock = clock_over([(cupti.CONCURRENT_KERNEL, 100, 150), (cupti.CONCURRENT_KERNEL, 0, 0),
                        (cupti.CONCURRENT_KERNEL, 300, 310)], lo=90, hi=400)
    clock.stop(lambda: None)
    assert clock.busy_s == pytest.approx(60e-9, rel=1e-12)
    assert (clock.kernels, clock.ops, clock.left_out) == (3, 3, 1)


K = cupti.CONCURRENT_KERNEL
N = cupti.LEFT_OUT_MAX + 1


@pytest.mark.parametrize("records,dropped", [
    ([(K, 100, 50)] * N, 0),  # each ends before it starts
    ([(K, 100, 400 + 2 * cupti.SKEW_NS)] * N, 0),  # after the window
    ([(K, 0, 0)] * N, 0),  # none timed
    ([(K, 100, 150)], 3)])  # records lost
def test_clock_refuses_what_it_cannot_read(records, dropped):
    with pytest.raises(RuntimeError):
        clock_over(records, lo=90, hi=400, dropped=dropped).stop(lambda: None)


def _ctx(trace, card_busy_s):
    return Context(kind="node", units=400, per_unit=1, durations=[0.005] * 370 + [0.01] * 30,
                   window_s=2.0, setup_s=9.0, trace=trace, card_busy_s=card_busy_s)


@pytest.mark.parametrize("name,untraced,traced", [
    ("card_ms_per_scan", 0.9, None),
    ("node.scans_per_s", None, 200.0),
    ("node.step_p95_ms", None, pytest.approx(10.0))])
def test_node_readers_read_only_their_runs(name, untraced, traced):
    read = cell.reader(name)
    assert read(_ctx(None, 0.36)) == untraced
    assert read(_ctx(types.SimpleNamespace(), None)) == traced


# ------------------------------------------------- the card's time per step


def test_busy_between_splits_a_crossing_record():
    clock = clock_over([(K, 100, 150), (K, 140, 160), (K, 210, 220), (K, 300, 310)],
                       lo=90, hi=400)
    clock.stop(lambda: None)
    marks = [90, 145, 200, 250, 305, 400]
    busy = clock.busy_between(marks)
    # [100, 160) splits at 145; nothing runs in [250, 305) but [300, 305).
    assert busy.tolist() == pytest.approx([45e-9, 15e-9, 10e-9, 5e-9, 5e-9], rel=1e-12)
    assert busy.sum() == pytest.approx(clock.busy_s, rel=1e-12)
    # The records across 145 and 305 hold 70 of the 80 ns busy.
    assert clock.crossing_share(marks) == pytest.approx(70 / 80)
    assert clock.crossing_share([90, 200, 250, 400]) == 0.0


def test_busy_between_reads_an_empty_step_as_zero():
    clock = clock_over([(K, 100, 150)], lo=90, hi=400)
    clock.stop(lambda: None)
    assert clock.busy_between([90, 95, 160, 170, 400]).tolist() == pytest.approx(
        [0.0, 50e-9, 0.0, 0.0], rel=1e-12, abs=0)
    empty = clock_over([(RUNTIME, 0, 10)], lo=90, hi=400)
    empty.stop(lambda: None)
    assert empty.busy_between([90, 200, 400]).tolist() == [0.0, 0.0]
    assert empty.crossing_share([90, 200, 400]) == 0.0


def test_busy_between_wants_marks_in_order():
    clock = clock_over([(K, 100, 150)], lo=90, hi=400)
    clock.stop(lambda: None)
    with pytest.raises(ValueError, match="in order"):
        clock.busy_between([90, 200, 150, 400])


def test_busy_between_is_the_covered_length():
    rng = np.random.default_rng(6)
    for _ in range(50):
        s = rng.integers(0, 1000, 30)
        e = s + rng.integers(0, 120, 30)
        marks = np.sort(rng.integers(0, 1200, 8))
        covered = np.zeros(1200, bool)
        for a, b in zip(s, e):
            covered[a:b] = True
        assert cupti.covered_ns(s, e, marks).tolist() == [int(covered[:m].sum()) for m in marks]


def test_marks_end_with_the_window():
    clock = clock_over([(K, 100, 150)], lo=90, hi=400)
    for now in (95, 160):
        clock.lib.now = now
        clock.mark()
    clock.lib.now = 400
    clock.stop(lambda: None)
    assert clock.marks == [95, 160, 400]
    unmarked = clock_over([(K, 100, 150)], lo=90, hi=400)
    unmarked.stop(lambda: None)
    assert unmarked.marks == []


def _kidnap_ctx(step_busy_s, kidnaps, timed_from=100, trace=None, accepted=None):
    durations = [0.005] * 50
    for t in kidnaps:
        if 0 <= t - timed_from < 50:
            durations[t - timed_from] = 0.1 + 1e-3 * (t - timed_from)
    return Context(kind="node", units=50, per_unit=1, durations=durations, window_s=1.0,
                   setup_s=9.0, trace=trace, card_busy_s=0.05,
                   events={"kidnaps": kidnaps, "timed_from": timed_from,
                           "accepted": kidnaps if accepted is None else accepted},
                   step_busy_s=step_busy_s)


def test_card_ms_per_kidnap_is_the_median_of_relocalized_kidnap_steps():
    read = cell.reader("card_ms_per_kidnap")
    busy = [0.5e-3] * 50
    for i, b in ((9, 10e-3), (19, 12e-3), (29, 11e-3), (39, 0.6e-3), (49, 30e-3)):
        busy[i] = b
    # Step 95 lies before the window: it is not read.
    ctx = _kidnap_ctx(busy, [95, 109, 119, 129, 139, 149])
    assert read(ctx) == pytest.approx(11.0)
    assert read(_kidnap_ctx(busy, [109, 119])) == pytest.approx(11.0)
    # Kidnap steps at which no relocalization was accepted (139: the align
    # rode the jump out) and accepted steps that are no kidnap (110) are not
    # read.
    kidnaps = [109, 119, 129, 139, 149]
    assert read(_kidnap_ctx(busy, kidnaps, accepted=[109, 110, 119, 129, 149])) == pytest.approx(
        11.5)
    assert read(_kidnap_ctx(busy, kidnaps, accepted=[110])) is None
    # Off the card (no time per step), or no kidnap in the window: nothing.
    assert read(_kidnap_ctx(None, [109, 119])) is None
    assert read(_kidnap_ctx(busy, [])) is None
    assert read(_kidnap_ctx(busy, [95, 150])) is None
    assert read(_ctx(None, 0.36)) is None


def test_recovery_step_p95_reads_relocalized_kidnap_steps_of_the_plain_window():
    read = cell.reader("recovery.step_p95_ms")
    kidnaps = [95, 109, 119, 129, 139, 149]
    ctx = _kidnap_ctx(None, kidnaps, trace=types.SimpleNamespace())
    want = np.percentile([100 + 9, 100 + 19, 100 + 29, 100 + 39, 100 + 49], 95)
    assert read(ctx) == pytest.approx(want)
    # Kidnap steps without an accepted relocalization are not read.
    ctx = _kidnap_ctx(None, kidnaps, trace=types.SimpleNamespace(), accepted=[119, 139])
    assert read(ctx) == pytest.approx(np.percentile([119, 139], 95))
    assert read(_kidnap_ctx(None, kidnaps)) is None  # an untraced run
    assert read(_kidnap_ctx(None, [], trace=types.SimpleNamespace())) is None
    assert read(_ctx(types.SimpleNamespace(), None)) is None  # the patrol: no events
