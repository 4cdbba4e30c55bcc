"""The card's busy time (``ndtbench/cupti.py``) from activity records as
CUPTI lays them out, read through a stand-in for the library, and the
readers of the node's metrics: each reads only in the runs it belongs to."""

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
    clock._full, clock._lo = [(lib.base, lib.valid)], lo
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
