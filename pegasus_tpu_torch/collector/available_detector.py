"""Availability canary: continuous end-to-end probe of a cluster.

Port of pegasus_tpu/collector/available_detector.py (upstream
available_detector and result_writer): write a timestamped probe row,
read it back, across all partitions of a detect table; track
minute/hour/day success ratios and persist recent results into the
detect table itself (the result_writer role) so external monitors can
read availability out of the store it measures.
"""

import threading
import time

from ..client import MetaResolver, PegasusClient, PegasusError
from ..rpc.transport import RpcError
from ..runtime.perf_counters import counters
from ..runtime.tasking import spawn_thread


class AvailableDetector:
    def __init__(self, meta_addrs, table_name: str = "test",
                 interval_seconds: float = 1.0):
        self.meta_addrs = list(meta_addrs)
        self.table_name = table_name
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread = spawn_thread(self._loop, daemon=True, start=False)
        self._lock = threading.Lock()
        self._window = []  # (ts, ok)
        self.client = None

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _ensure_client(self):
        if self.client is None:
            self.client = PegasusClient(
                MetaResolver(self.meta_addrs, self.table_name))
        return self.client

    def probe_once(self) -> bool:
        """One write+read round-trip across a rotating partition hash."""
        ts = int(time.time() * 1000)
        hk = b"detect_available_p%d" % (ts % 64)
        sk = b"ts"
        val = str(ts).encode()
        try:
            cli = self._ensure_client()
            cli.set(hk, sk, val)
            ok = cli.get(hk, sk) == val
        except (PegasusError, RpcError, OSError):
            # RpcError covers "table does not exist (yet)" from the meta
            # resolver — a canary whose table lags its own boot must count
            # failures, not die (its loop thread has no other guard)
            ok = False
            self.client = None  # rebuild routing next round
        with self._lock:
            self._window.append((time.time(), ok))
            cutoff = time.time() - 86400
            while self._window and self._window[0][0] < cutoff:
                self._window.pop(0)
        counters.rate("detector.probe_total").increment()
        if not ok:
            counters.rate("detector.probe_fail").increment()
        # persist the result into the probe table (result_writer role)
        if ok:
            try:
                cli.set(b"detect_available_result", b"last",
                        b"%d:%d" % (ts, 1))
            except (PegasusError, OSError):
                pass
        return ok

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.probe_once()
            except Exception as e:  # the canary must outlive ANY error
                print(f"[detector] probe error: {e!r}", flush=True)

    def availability(self, seconds: float) -> float:
        """Success ratio over the trailing window (minute/hour/day views)."""
        cutoff = time.time() - seconds
        with self._lock:
            rows = [ok for ts, ok in self._window if ts >= cutoff]
        if not rows:
            return 1.0
        return sum(rows) / len(rows)

    def report(self) -> dict:
        with self._lock:
            samples = len(self._window)
        return {
            "minute": self.availability(60),
            "hour": self.availability(3600),
            "day": self.availability(86400),
            # no-data reads as 1.0 (benefit of the doubt, reference
            # behavior); consumers needing proof of life check samples
            "samples": samples,
        }
