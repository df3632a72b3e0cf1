"""Hotkey detection: per-replica READ/WRITE collectors with the
coarse->fine state machine.

The port's copy of pegasus_tpu/engine/hotkey_collector.py.

Mirror of src/server/hotkey_collector.{h,cpp} (+hotkey_collector_state.h):
STOPPED -> COARSE (bucket histogram over hash of hash_key) -> FINE
(per-key queues within the winning bucket) -> FINISHED (hotkey published).
An outlier bucket/key is declared by the 68-95-99.7 rule: a bucket whose
count exceeds mean + 3*stddev of the others (hotkey_collector.cpp's
variance analysis). Driven by the `detect_hotkey` remote command from the
shell/collector (reference on_detect_hotkey, pegasus_server_impl.cpp:2976).
"""

import threading
import time
from collections import Counter as PyCounter

BUCKETS = 37  # prime bucket count, like the reference's FIND_BUCKET macro
MAX_DETECT_SECONDS = 150  # reference FLAGS_max_seconds_to_detect_hotkey

STOPPED = "STOPPED"
COARSE = "COARSE_DETECTING"
FINE = "FINE_DETECTING"
FINISHED = "FINISHED"


def _bucket(hash_key: bytes) -> int:
    h = 2166136261
    for b in hash_key:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % BUCKETS


class HotkeyCollector:
    """One collector per (replica, READ|WRITE) kind."""

    def __init__(self, kind: str, coarse_threshold: int = 100,
                 fine_threshold: int = 50,
                 max_seconds: float = MAX_DETECT_SECONDS):
        self.kind = kind
        self.state = STOPPED
        self.coarse_threshold = coarse_threshold
        self.fine_threshold = fine_threshold
        self.max_seconds = max_seconds
        self._deadline = 0.0
        self._lock = threading.Lock()
        self._buckets = [0] * BUCKETS
        self._hot_bucket = -1
        self._fine = PyCounter()
        self.result = None

    # ------------------------------------------------------------- control

    def start(self) -> str:
        with self._lock:
            self._buckets = [0] * BUCKETS
            self._fine.clear()
            self._hot_bucket = -1
            self.result = None
            self.state = COARSE
            # a detection that never converges self-terminates (reference
            # terminate_if_timeout, FLAGS_max_seconds_to_detect_hotkey)
            self._deadline = time.monotonic() + self.max_seconds
            return f"{self.kind} hotkey detection started (coarse)"

    def stop(self) -> str:
        with self._lock:
            self.state = STOPPED
            return f"{self.kind} hotkey detection stopped"

    def query(self) -> str:
        with self._lock:
            if self.state == FINISHED and self.result is not None:
                return (f"{self.kind} hotkey: {self.result!r}")
            if (self.state in (COARSE, FINE)
                    and time.monotonic() >= self._deadline):
                self.state = STOPPED
                return (f"{self.kind} detection state: {STOPPED} "
                        "(timed out without an outlier)")
            return f"{self.kind} detection state: {self.state}"

    # -------------------------------------------------------------- capture

    def capture(self, hash_key: bytes, weight: int = 1) -> None:
        if self.state == STOPPED or self.state == FINISHED:
            return
        if time.monotonic() >= self._deadline:
            with self._lock:
                if self.state in (COARSE, FINE):
                    self.state = STOPPED
            return
        with self._lock:
            if self.state == COARSE:
                b = _bucket(hash_key)
                self._buckets[b] += weight
                total = sum(self._buckets)
                if total >= self.coarse_threshold:
                    hot = self._outlier_index(self._buckets)
                    if hot >= 0:
                        self._hot_bucket = hot
                        self.state = FINE
                        self._fine.clear()
                    else:
                        self._buckets = [0] * BUCKETS  # analyse next window
            elif self.state == FINE:
                if _bucket(hash_key) != self._hot_bucket:
                    return
                self._fine[bytes(hash_key)] += weight
                if sum(self._fine.values()) >= self.fine_threshold:
                    counts = list(self._fine.values())
                    keys = list(self._fine.keys())
                    hot = self._outlier_index(counts)
                    if hot >= 0:
                        self.result = keys[hot]
                        self.state = FINISHED
                    else:
                        self._fine.clear()

    @staticmethod
    def _outlier_index(counts) -> int:
        """68-95-99.7 rule: index whose count > mean + 3*stddev of the REST
        (hotkey_collector.cpp variance analysis); -1 if none."""
        n = len(counts)
        if n < 2:
            return 0 if n == 1 and counts[0] > 0 else -1
        best = max(range(n), key=lambda i: counts[i])
        rest = [c for i, c in enumerate(counts) if i != best]
        mean = sum(rest) / len(rest)
        var = sum((c - mean) ** 2 for c in rest) / len(rest)
        threshold = mean + 3 * (var ** 0.5)
        return best if counts[best] > threshold and counts[best] > 0 else -1
