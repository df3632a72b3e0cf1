"""Per-table write throttling (the port's copy of
pegasus_tpu/engine/throttling.py; reference: rDSN throttling_controller
consumed through the `replica.write_throttling[_by_size]` app-envs; the
pegasus surface is the env keys plus the delay/reject perf counters the
collector aggregates, src/server/info_collector.h:73-81).

Env value grammar (the reference's parse_from_env):

    "20000*delay*100"                   delay 100ms once >20000 units/s
    "20000*delay*100,30000*reject*10"   ...and reject (after a 10ms pause)
                                        once >30000 units/s
    "30000"                             bare number: reject above it

Units are requests for `replica.write_throttling`, request-body bytes for
`replica.write_throttling_by_size`. Accounting is a per-second tumbling
window, like the reference's token-refresh-per-second controller.

``DebtThrottle`` is compaction-debt-driven admission control.
The env throttles above bound *rates* an operator configured; the debt
throttle bounds the *engine's* backlog — as L0 debt approaches the hard
ceiling where the engine-local trigger compacts inline on the writer
thread (the stall cliff), writes pick up a graduated, metric-visible
delay so the cliff becomes a measured slope instead of an accident.
"""

import threading
import time


class ThrottleReject(Exception):
    """Raised when the reject threshold fires (mapped to ERR_BUSY)."""


class ThrottlingController:
    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.delay_units = 0
        self.delay_ms = 0
        self.reject_units = 0
        self.reject_delay_ms = 0
        self.env_value = ""
        self._window_start = 0
        self._window_units = 0
        # the counters the reference publishes per replica
        self.delayed_count = 0
        self.rejected_count = 0

    def parse_from_env(self, value: str) -> bool:
        """Apply an env string; empty disables. -> False on a malformed
        value (the old setting stays, like the reference's validator)."""
        value = (value or "").strip()
        delay_units = delay_ms = reject_units = reject_delay_ms = 0
        if value:
            try:
                for tok in value.split(","):
                    parts = tok.strip().split("*")
                    if len(parts) == 1:
                        reject_units, reject_delay_ms = int(parts[0]), 0
                    elif len(parts) == 3 and parts[1] == "delay":
                        delay_units, delay_ms = int(parts[0]), int(parts[2])
                    elif len(parts) == 3 and parts[1] == "reject":
                        reject_units = int(parts[0])
                        reject_delay_ms = int(parts[2])
                    else:
                        return False
                    if min(delay_units, delay_ms,
                           reject_units, reject_delay_ms) < 0:
                        return False
            except ValueError:
                return False
        with self._lock:
            self.env_value = value
            self.enabled = bool(value)
            self.delay_units, self.delay_ms = delay_units, delay_ms
            self.reject_units = reject_units
            self.reject_delay_ms = reject_delay_ms
        return True

    def consume(self, units: int = 1) -> None:
        """Charge one request. Sleeps for a delay-throttle; raises
        ThrottleReject for a reject-throttle (after its pause)."""
        if not self.enabled:
            return
        with self._lock:
            now = int(time.monotonic())
            if now != self._window_start:
                self._window_start = now
                self._window_units = 0
            self._window_units += units
            total = self._window_units
            reject = self.reject_units and total > self.reject_units
            delay = self.delay_units and total > self.delay_units
            if reject:
                self.rejected_count += 1
                pause = self.reject_delay_ms / 1000.0
            elif delay:
                self.delayed_count += 1
                pause = self.delay_ms / 1000.0
        if reject:
            if pause:
                time.sleep(pause)
            raise ThrottleReject(
                f"write throttled: {total} units/s > {self.reject_units}")
        if delay and pause:
            time.sleep(pause)


class DebtThrottle:
    """Compaction-debt admission control: charge every write
    against the engine's L0-debt ratio (debt files / hard ceiling, a
    lock-free racy read — see LsmEngine.compact_debt_ratio) and apply
    graduated backpressure BEFORE the engine hits the stall cliff where
    the ceiling trigger compacts inline on the writer thread:

      ratio < SOFT                 free
      SOFT <= ratio                delay scaling linearly up to MAX_MS
                                   at the ceiling

    SOFT and MAX_MS are the reference's defaults; the port has no
    cluster compaction scheduler yet, so no scheduler token changes the
    slope and no setting rejects. Counters:
    engine.throttle.debt_delay_count rate + the
    engine.throttle.debt_delay_ms percentile, plus the monotone
    engine.throttle.debt_delay_ms_total rate whose .total() is the
    process-global delay-ms sum."""

    SOFT = 0.5       # ratio where the delay starts
    MAX_MS = 50.0    # delay at the ceiling edge

    def __init__(self, engine):
        from ..runtime.perf_counters import counters

        self.engine = engine
        # plain monotone counter for tests; the registry rates are the
        # operator surface (resolved once — the admission path is per-write)
        self.delayed_count = 0
        self._c_delay = counters.rate("engine.throttle.debt_delay_count")
        self._c_delay_ms = counters.percentile(
            "engine.throttle.debt_delay_ms")
        self._c_delay_ms_total = counters.rate(
            "engine.throttle.debt_delay_ms_total")
        # per-partition attribution: the monotone ms sum this one
        # throttle has charged, and the table ledger the host wires up
        # (set_table_name), so every delayed ms lands on a tenant too
        self.delay_ms_total = 0.0
        self.ledger = None
        # flight-recorder edge detection: ONE event per engage/disengage
        # transition, not one per delayed write. Deliberately lock-free
        # (this sits on the per-write admission path); a race can at
        # worst duplicate a transition event, never lose a delay.
        self._engaged = False

    def consume(self) -> float:
        """Charge one write; sleeps for the graduated delay. Called
        OUTSIDE any engine lock (the sleep must never convoy other
        writers). Returns the delay in ms (0.0 on the free path) so
        callers can attribute the stall to the partition that paid it."""
        ratio = self.engine.compact_debt_ratio()
        if ratio < self.SOFT:
            if self._engaged:
                self._engaged = False
                from ..runtime import events

                events.emit("throttle.disengage", ratio=round(ratio, 3))
            return 0.0
        if not self._engaged:
            self._engaged = True
            from ..runtime import events

            events.emit("throttle.engage", severity="warn",
                        ratio=round(ratio, 3))
        frac = min(1.0, (ratio - self.SOFT) / (1.0 - self.SOFT))
        delay_ms = self.MAX_MS * frac
        if delay_ms <= 0:
            return 0.0
        self.delayed_count += 1
        self.delay_ms_total += delay_ms
        self._c_delay.increment()
        self._c_delay_ms.set(delay_ms)
        self._c_delay_ms_total.increment(delay_ms)
        if self.ledger is not None:
            # charged here, not by the caller: the global total equals the
            # sum of the per-table attributions by construction
            self.ledger.charge_throttle_delay(delay_ms)
        time.sleep(delay_ms / 1000.0)
        return delay_ms
