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
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys
import threading
from typing import Optional

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
    in it.  One per process: CUPTI's buffer callbacks
    are the process's."""

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
        self._lo = self._now()

    def stop(self, sync):
        """End the window once the device has drained, read the records and
        free them."""
        sync()
        hi = self._now()
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
        s, e = s[timed], e[timed]
        self.busy_s = union_ns(np.clip(s, self._lo, hi), np.clip(e, self._lo, hi)) * 1e-9
        self.kernels, self.ops = kernels, len(timed)


def union_ns(starts: np.ndarray, ends: np.ndarray) -> int:
    """Length of the union of the intervals [starts, ends)."""
    if not len(starts):
        return 0
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    # Each interval adds what it reaches beyond every earlier one.
    prev = np.concatenate(([s[0]], reach[:-1]))
    return int(np.sum(reach - np.maximum(s, prev)))
