"""Range-read iteration limiter (src/server/range_read_limiter.h:29-100).

The port's copy of pegasus_tpu/engine/range_read_limiter.py: the same
budgets, so both packages cut a partial batch at the same row.

Caps how much work one multi_get / sortkey_count / scan RPC may do:
iteration count, accumulated bytes, and wall time (time is checked every
`time_check_period` iterations like the reference's 10-checks-per-scan).
Exceeded limits make the server return a partial batch with an INCOMPLETE /
continue signal instead of stalling the read thread pool.
"""

import time


class RangeReadLimiter:
    def __init__(self, max_iteration_count: int = 1000,
                 max_iteration_size: int = 4 << 20,
                 max_duration_ms: int = 5000,
                 time_check_period: int = 100):
        self.max_count = max_iteration_count
        self.max_size = max_iteration_size
        self.max_duration_ms = max_duration_ms
        self.period = max(1, time_check_period)
        self._count = 0
        self._size = 0
        self._t0 = time.monotonic()
        self.stopped_by = None  # None | "count" | "size" | "time"

    def add_count(self, n: int = 1) -> None:
        self._count += n

    def add_size(self, nbytes: int) -> None:
        self._size += nbytes

    def valid(self) -> bool:
        if self.max_count > 0 and self._count >= self.max_count:
            self.stopped_by = "count"
            return False
        if self.max_size > 0 and self._size >= self.max_size:
            self.stopped_by = "size"
            return False
        if (self.max_duration_ms > 0 and self._count % self.period == 0
                and (time.monotonic() - self._t0) * 1000 >= self.max_duration_ms):
            self.stopped_by = "time"
            return False
        return True

    @property
    def iterated(self) -> int:
        return self._count
