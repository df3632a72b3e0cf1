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

import os
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

      ratio < soft                 free
      soft <= ratio < 1.0          delay scaling linearly up to max_ms
      ratio >= reject (if set)     ThrottleReject -> ERR_BUSY

    Knobs (resolved once at construction): PEGASUS_SCHED_THROTTLE
    (``0`` disables — byte-identical admission to the pre-throttle
    engine), PEGASUS_SCHED_THROTTLE_SOFT (ratio where delay starts),
    PEGASUS_SCHED_THROTTLE_MAX_MS (delay at the ceiling edge),
    PEGASUS_SCHED_THROTTLE_REJECT (ratio that rejects; 0 = never).
    Counters: engine.throttle.debt_delay_count / debt_reject_count
    rates + the engine.throttle.debt_delay_ms percentile, plus the
    monotone engine.throttle.debt_delay_ms_total rate whose .total() is
    the process-global delay-ms sum (it equals the sum of the per-table
    ledger attributions)."""

    def __init__(self, engine):
        from ..runtime.perf_counters import counters

        self.engine = engine
        self.enabled = os.environ.get("PEGASUS_SCHED_THROTTLE", "1") != "0"
        self.soft = float(os.environ.get("PEGASUS_SCHED_THROTTLE_SOFT",
                                         "0.5"))
        self.max_ms = float(os.environ.get("PEGASUS_SCHED_THROTTLE_MAX_MS",
                                           "50"))
        self.reject_ratio = float(os.environ.get(
            "PEGASUS_SCHED_THROTTLE_REJECT", "0"))
        # plain monotone counters for tests; the registry rates are the
        # operator surface (resolved once — the admission path is per-write)
        self.delayed_count = 0
        self.rejected_count = 0
        self._c_delay = counters.rate("engine.throttle.debt_delay_count")
        self._c_reject = counters.rate("engine.throttle.debt_reject_count")
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

    # a DEFER token means the scheduler is deliberately accumulating
    # this debt (a read-hot partition holding its compaction): charging
    # the normal slope there would collapse write throughput as a side
    # effect of a read-side optimization. The throttle instead engages
    # only in the last eighth before the ceiling cliff (the same 7/8
    # convention as the HBM read-hot headroom) — close enough that the
    # imminent ceiling-override compaction still gets its measured
    # slowdown, far enough that the defer window itself is free.
    DEFER_SOFT = 0.875

    def consume(self) -> float:
        """Charge one write; sleeps for the graduated delay, raises
        ThrottleReject past the reject ratio. Called OUTSIDE any engine
        lock (the sleep must never convoy other writers). Returns the
        delay in ms (0.0 on the free paths) so callers can attribute the
        stall to the partition that paid it."""
        if not self.enabled:
            return 0.0
        ratio = self.engine.compact_debt_ratio()
        soft = self.soft
        if ratio >= soft \
                and self.engine.compact_policy_fast() == "defer":
            soft = max(soft, self.DEFER_SOFT)
        if ratio < soft:
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
        if self.reject_ratio and ratio >= self.reject_ratio:
            self.rejected_count += 1
            self._c_reject.increment()
            raise ThrottleReject(
                f"write throttled: compaction debt {ratio:.2f}x of the "
                f"ceiling >= reject ratio {self.reject_ratio:.2f}")
        frac = min(1.0, (ratio - self.soft) / max(1e-9, 1.0 - self.soft))
        delay_ms = self.max_ms * frac
        if delay_ms <= 0:
            return 0.0
        self.delayed_count += 1
        self.delay_ms_total += delay_ms
        self._c_delay.increment()
        self._c_delay_ms.set(delay_ms)
        self._c_delay_ms_total.increment(delay_ms)
        if self.ledger is not None:
            # charged HERE, not by the caller: global total == sum of
            # per-table attributions holds structurally
            self.ledger.charge_throttle_delay(delay_ms)
        time.sleep(delay_ms / 1000.0)
        return delay_ms
