"""Rate meter around the scan callback.

Port of ``RateMeter`` in ``ndtpso_slam_tpu/utils/profiling.py``: the
reference's average publish rate and instantaneous matching rate
(``ndtpso_slam_node.cpp:183-184,232-240``).
"""

from __future__ import annotations

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
