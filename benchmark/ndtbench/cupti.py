"""The card's busy time over a whole window, from CUPTI's activity records.

torch.profiler cannot hold a whole window of the node: twenty seconds make
about a million device records, more than its Chrome trace can carry, and
it loses records 25-118 s into a process (ROADMAP §3, T1).  So the node's
untraced run records the device alone through CUPTI's activity API and
keeps of each kernel, copy and set only its start and end.  The library is
the one PyTorch loaded, else the one PyTorch ships beside it, else the CUDA
toolkit's.  Nothing is written to disk.

CUPTI's activity records for concurrent kernels (``CUpti_ActivityKernel4``
to ``9``), copies (``Memcpy4``, ``5``) and sets (``Memset4``) hold the
record's kind in their first 4 bytes and its start and end, in ns, at bytes
16 and 24.  Each record is checked to lie inside the window on CUPTI's own
clock, so a library whose layout differs fails loudly instead of reading
wrong (allowing for the two clocks' skew).  CUPTI gives no time for an
operation it could not time (both times 0, one in a million here): such
records are left out and counted, and more than one in 10^4 fails the
window, as does a record CUPTI dropped.

A run that tells its steps apart takes a :meth:`DeviceClock.mark` on
CUPTI's clock before each step; :meth:`DeviceClock.busy_between` then gives
the card's busy time within each step, and
:meth:`DeviceClock.crossing_share` the share of the busy time in records
that run across a mark, which such a split gives to two steps.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading
from typing import List, Optional

import numpy as np

MEMCPY, MEMSET, CONCURRENT_KERNEL = 1, 2, 10  # CUpti_ActivityKind
KINDS = (CONCURRENT_KERNEL, MEMCPY, MEMSET)
START, END = 16, 24  # byte offsets of start and end in those records
BUFFER_BYTES = 16 << 20
FLUSH_FORCED = 1  # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED
# The device's times are CUPTI's conversion of the card's clock to the
# host's; a record may stand this far outside the window it lies in.
SKEW_NS = 1_000_000
# Records left out (untimed, or outside the window) that a window bears:
# a layout this reader does not know puts nearly every record there.
LEFT_OUT_MAX, LEFT_OUT_SHARE = 10, 1e-4

_REQUEST = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t))
_COMPLETE = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                             ctypes.c_size_t, ctypes.c_size_t)


def _library_path() -> str:
    with open("/proc/self/maps") as f:
        loaded = [line.split()[-1] for line in f if "libcupti" in line]
    if loaded:
        return loaded[0]
    found = []
    for entry in sys.path:
        found += sorted(glob.glob(os.path.join(entry, "nvidia", "cuda_cupti", "lib",
                                               "libcupti.so*")))
    found += sorted(glob.glob("/usr/local/cuda/extras/CUPTI/lib64/libcupti.so*"))
    if not found:
        raise RuntimeError("no CUPTI library: neither PyTorch's nor the CUDA toolkit's")
    return found[0]


class DeviceClock:
    """Records every kernel, copy and set of the device between
    :meth:`start` and :meth:`stop`; :attr:`busy_s` is then the length of
    the union of their intervals inside the window, :attr:`kernels` and
    :attr:`ops` their counts, :attr:`left_out` the records without a time
    in it; :attr:`marks` the times :meth:`mark` took in the window, and the
    window's end where it took any.  One per process: CUPTI's buffer
    callbacks are the process's."""

    _lib = None

    def __init__(self):
        if DeviceClock._lib is None:
            lib = ctypes.CDLL(_library_path())
            lib.cuptiActivityGetNextRecord.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                                       ctypes.POINTER(ctypes.c_void_p)]
            lib.cuptiActivityGetNumDroppedRecords.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_size_t)]
            lib.cuptiGetTimestamp.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
            lib.cuptiActivityEnable.argtypes = [ctypes.c_int]
            lib.cuptiActivityDisable.argtypes = [ctypes.c_int]
            DeviceClock._lib = lib
        self.lib = DeviceClock._lib
        self._buffers = {}  # address -> the buffer that owns it
        self._full = []  # (address, valid bytes)
        self.dropped = 0
        # CUPTI completes buffers from its own thread as well as in a flush.
        self._lock = threading.Lock()
        self.busy_s: Optional[float] = None
        self.kernels = self.ops = self.left_out = 0
        self.marks: List[int] = []
        # The window's timed records, clipped to it, once stop() has read them.
        self._starts = self._ends = np.zeros(0, np.int64)
        # Kept on the object: CUPTI calls them until the process ends.
        self._request_cb = _REQUEST(self._request)
        self._complete_cb = _COMPLETE(self._complete)
        self._call("cuptiActivityRegisterCallbacks", self._request_cb, self._complete_cb)

    def _call(self, name, *args):
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} returned CUPTI error {rc}")

    def _request(self, buf, size, max_records):
        raw = ctypes.create_string_buffer(BUFFER_BYTES + 8)
        address = (ctypes.addressof(raw) + 7) & ~7
        self._buffers[address] = raw
        buf[0] = address
        size[0] = BUFFER_BYTES
        max_records[0] = 0

    def _complete(self, context, stream, buf, size, valid):
        dropped = ctypes.c_size_t(0)
        if self.lib.cuptiActivityGetNumDroppedRecords(context, stream,
                                                      ctypes.byref(dropped)) != 0:
            dropped.value = 0
        with self._lock:
            if buf:
                self._full.append((buf, valid))
            self.dropped += dropped.value

    def _now(self) -> int:
        t = ctypes.c_uint64(0)
        self._call("cuptiGetTimestamp", ctypes.byref(t))
        return t.value

    def start(self, sync):
        """Begin the window once the device has drained (``sync()``)."""
        sync()
        for kind in KINDS:
            self._call("cuptiActivityEnable", kind)
        self.marks = []
        self._lo = self._now()

    def mark(self):
        """Take a mark on CUPTI's clock: the host's time now, before the
        step that follows launches anything."""
        self.marks.append(self._now())

    def stop(self, sync):
        """End the window once the device has drained, read the records and
        free them."""
        sync()
        hi = self._now()
        if self.marks:
            self.marks.append(hi)  # the last step ends with the window
        for kind in KINDS:
            self._call("cuptiActivityDisable", kind)
        self._call("cuptiActivityFlushAll", FLUSH_FORCED)
        with self._lock:
            full, self._full = self._full, []
        starts, ends, kernels = [], [], 0
        record = ctypes.c_void_p(None)
        next_record = self.lib.cuptiActivityGetNextRecord
        for address, valid in full:
            record.value = None
            while next_record(address, valid, ctypes.byref(record)) == 0:
                a = record.value
                kind = ctypes.c_uint32.from_address(a).value
                if kind in KINDS:
                    starts.append(ctypes.c_uint64.from_address(a + START).value)
                    ends.append(ctypes.c_uint64.from_address(a + END).value)
                    kernels += kind == CONCURRENT_KERNEL
            self._buffers.pop(address, None)
        if self.dropped:
            raise RuntimeError(f"CUPTI dropped {self.dropped} activity records")
        s = np.asarray(starts, dtype=np.int64)
        e = np.asarray(ends, dtype=np.int64)
        # CUPTI writes 0 for both times of an operation it could not time;
        # such a record, or one outside the window, is left out and counted.
        timed = (s > 0) & (e >= s) & (s >= self._lo - SKEW_NS) & (e <= hi + SKEW_NS)
        self.left_out = int(len(s) - timed.sum())
        if self.left_out > max(LEFT_OUT_MAX, LEFT_OUT_SHARE * len(s)):
            raise RuntimeError(f"{self.left_out} of {len(s)} CUPTI records have no time inside "
                               "the window: the record layout is not the one this reader knows")
        self._starts, self._ends = np.clip(s[timed], self._lo, hi), np.clip(e[timed], self._lo, hi)
        self.busy_s = union_ns(self._starts, self._ends) * 1e-9
        self.kernels, self.ops = kernels, len(timed)

    def busy_between(self, marks) -> np.ndarray:
        """Seconds the card was busy from each of ``marks`` (ns on CUPTI's
        clock, in order) to the next: the union of the window's records
        clipped to each interval, so a record that crosses a mark counts in
        both intervals, in each for its own part."""
        m = np.asarray(marks, np.int64)
        if np.any(np.diff(m) < 0):
            raise ValueError("marks must be in order")
        return np.diff(covered_ns(self._starts, self._ends, m)) * 1e-9

    def crossing_share(self, marks) -> float:
        """The share of the window's busy time in records that run across
        one of ``marks`` (in order): what :meth:`busy_between` splits
        between two intervals."""
        m = np.asarray(marks, np.int64)
        s, e = self._starts, self._ends
        after = np.searchsorted(m, s, side="right")  # the first mark after each start
        crosses = after < len(m)
        crosses[crosses] = m[after[crosses]] < e[crosses]
        busy = union_ns(s, e)
        return union_ns(s[crosses], e[crosses]) / busy if busy else 0.0


def merged(starts: np.ndarray, ends: np.ndarray):
    """The union of the intervals [starts, ends) as sorted disjoint
    intervals (starts, ends)."""
    if not len(starts):
        return starts[:0], ends[:0]
    order = np.argsort(starts, kind="stable")
    s, reach = starts[order], np.maximum.accumulate(ends[order])
    # A piece begins where an interval starts past every earlier end.
    first = np.flatnonzero(np.concatenate(([True], s[1:] > reach[:-1])))
    last = np.concatenate((first[1:], [len(s)])) - 1
    return s[first], reach[last]


def covered_ns(starts: np.ndarray, ends: np.ndarray, times: np.ndarray) -> np.ndarray:
    """For each of ``times``, the length of the union of the intervals
    [starts, ends) that lies before it."""
    s, e = merged(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    if not len(s):
        return np.zeros(len(times), np.int64)
    before = np.concatenate(([0], np.cumsum(e - s)))  # the pieces before piece k, covered
    k = np.searchsorted(s, times, side="right")  # pieces that start by each time
    last = np.maximum(k - 1, 0)
    inside = np.clip(times - s[last], 0, e[last] - s[last])
    return np.where(k > 0, before[last] + inside, 0)


def union_ns(starts: np.ndarray, ends: np.ndarray) -> int:
    """Length of the union of the intervals [starts, ends)."""
    s, e = merged(starts, ends)
    return int(np.sum(e - s))
