"""Device-health watchdog: is the card alive, and if not, in which stage
did it wedge?

Port of pegasus_tpu/ops/device_watchdog.py. The probe is a tiny torch op
on the watched device that synchronises (`x + 1` on eight int32 and a
read back; the reference's jit round-trip). It is not a Pallas kernel and
has no hand-written kernel: one elementwise op is all it needs. The probe
runs in a daemon thread under a timeout, so a wedged device hangs the
probe thread, not the caller; a hung probe thread is abandoned, never
joined again.

State:

  last_ok          wall time of the last successful probe
  last_error       the last failure's text
  wedged_at_stage  the innermost open tracing span (runtime/tracing.py)
                   once fail_threshold CONSECUTIVE probes failed ("idle"
                   when nothing was in flight)

Counters: compact.watchdog.probe_count / probe_failures (rates),
compact.watchdog.probe_us (percentile), compact.watchdog.wedged (0/1).

One watchdog per device (watchdog_for): the manual-compact service probes
the watchdog of its engine's device around every device compaction and
arms its background loop, which re-probes every interval_s.
"""

import threading
import time

import torch

from ..runtime.perf_counters import counters
from ..runtime.tracing import COMPACT_TRACER
from .compact import resolve_device


def _default_probe(device) -> bool:
    """x + 1 on the device, synchronised; blocks iff the device is
    wedged, raises if it is gone."""
    x = torch.zeros(8, dtype=torch.int32, device=device)
    y = x + 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return int(y[0].item()) == 1


class DeviceHealthWatchdog:
    def __init__(self, device=None, probe_timeout_s: float = 10.0,
                 interval_s: float = 5.0, probe_fn=None,
                 tracer=COMPACT_TRACER, fail_threshold: int = 2):
        self.device = resolve_device(device)
        self.probe_timeout_s = probe_timeout_s
        self.interval_s = interval_s
        self.probe_fn = probe_fn or (lambda: _default_probe(self.device))
        self.tracer = tracer
        # one slow-but-healthy kernel can starve a probe past its timeout
        # (device work serialises): only consecutive failures flip the
        # wedged state
        self.fail_threshold = fail_threshold
        self._lock = threading.Lock()
        self._probe_thread = None   #: guarded_by self._lock
        self._consec_failures = 0   #: guarded_by self._lock
        self.last_ok = None
        self.last_error = None
        self.wedged_at_stage = None
        self._stop = threading.Event()
        self._loop_thread = None    #: guarded_by self._lock

    def probe(self, timeout_s: float = None) -> bool:
        """One liveness round-trip under a timeout. False = failed, wedged,
        or the previous probe never came back (no stacking of hung
        threads)."""
        timeout = self.probe_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            hung = (self._probe_thread is not None
                    and self._probe_thread.is_alive())
            if not hung:
                self._probe_thread = None
        counters.rate("compact.watchdog.probe_count").increment()
        if hung:
            self._mark_failed("previous probe still hung")
            return False
        result = {}

        def run():
            try:
                result["ok"] = bool(self.probe_fn())
            except Exception as e:  # noqa: BLE001 - a probe error IS the signal
                result["error"] = repr(e)

        t = threading.Thread(target=run, daemon=True, name="device-probe")
        with self._lock:
            self._probe_thread = t
        t0 = time.perf_counter()
        t.start()
        t.join(timeout)
        counters.percentile("compact.watchdog.probe_us").set(
            int((time.perf_counter() - t0) * 1e6))
        if t.is_alive():
            # wedged inside the device runtime: leave the daemon thread
            self._mark_failed(f"probe timed out after {timeout}s")
            return False
        with self._lock:
            self._probe_thread = None
        if result.get("ok"):
            with self._lock:
                self.last_ok = time.time()
                self.last_error = None
                self.wedged_at_stage = None
                self._consec_failures = 0
            counters.number("compact.watchdog.wedged").set(0)
            return True
        self._mark_failed(result.get("error", "probe returned falsy"))
        return False

    def _mark_failed(self, error: str) -> None:
        inner = self.tracer.innermost_open()
        with self._lock:
            self.last_error = error
            self._consec_failures += 1
            wedged = self._consec_failures >= self.fail_threshold
            if wedged:
                self.wedged_at_stage = inner[0] if inner else "idle"
        counters.rate("compact.watchdog.probe_failures").increment()
        if wedged:
            counters.number("compact.watchdog.wedged").set(1)

    def state(self) -> dict:
        with self._lock:
            out = {"device": str(self.device), "last_ok": self.last_ok,
                   "last_error": self.last_error,
                   "wedged_at_stage": self.wedged_at_stage}
        out["open_stages"] = {str(tid): stages for tid, stages
                              in self.tracer.open_stages().items()}
        return out

    def start(self) -> "DeviceHealthWatchdog":
        """Arm the background probe loop (idempotent)."""
        with self._lock:
            if self._loop_thread is not None and self._loop_thread.is_alive():
                return self
            self._stop.clear()
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="device-watchdog")
            self._loop_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                print(f"[device-watchdog] probe crashed: {e!r}", flush=True)


_WATCHDOGS = {}   # str(device) -> DeviceHealthWatchdog
_WATCHDOGS_LOCK = threading.Lock()


def health_watchdog() -> DeviceHealthWatchdog:
    """The watchdog the device-health command reports: the first one this
    process armed (a node's manual compactions arm their engine device's),
    else the default device's."""
    with _WATCHDOGS_LOCK:
        for wd in _WATCHDOGS.values():
            if wd._loop_thread is not None:
                return wd
    return watchdog_for()


def watchdog_for(device=None) -> DeviceHealthWatchdog:
    """The process-wide watchdog of one device (None = cuda)."""
    dev = resolve_device(device)
    with _WATCHDOGS_LOCK:
        wd = _WATCHDOGS.get(str(dev))
        if wd is None:
            wd = _WATCHDOGS[str(dev)] = DeviceHealthWatchdog(dev)
        return wd

