"""Rate meter around the scan callback, and profiler traces.

Port of ``ndtpso_slam_tpu/utils/profiling.py``: :class:`RateMeter` keeps the
reference's average publish rate and instantaneous matching rate
(``ndtpso_slam_node.cpp:183-184,232-240``); :func:`trace` wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler``.  No entry
point calls :func:`trace`; ``chip_smoke.py`` counts launches with the
kernel wrappers' ``LAUNCHES`` counters, not with the profiler.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional


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


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a GPU is present) and write a Chrome trace (view it in
    Perfetto or chrome://tracing) under ``logdir`` on exit.  Yields
    ``logdir``; the default is ``ndtpso_trace`` in the temporary directory
    (``/tmp/ndtpso_trace`` unless ``TMPDIR`` says otherwise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "ndtpso_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield logdir
    finally:
        name = f"trace-{os.getpid()}-{time.time_ns()}.json"
        prof.export_chrome_trace(os.path.join(logdir, name))
