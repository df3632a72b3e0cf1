"""Manual-compact service: app-env driven once/periodic full compactions.

Port of pegasus_tpu/engine/manual_compact_service.py, itself a mirror of
pegasus_manual_compact_service (src/server/
pegasus_manual_compact_service.{h,cpp}): the meta server distributes
`manual_compact.*` app-envs to every replica; each replica decides locally
whether to run (once trigger newer than last finish; periodic trigger time
of day passed), bounded cluster-wide by `max_concurrent_running_count`
(a process-wide semaphore here standing in for the cluster-wide cap), and
records the finish time into the engine meta store so `query_compact_state`
and once-trigger dedup survive restarts.

Env keys (base.consts, byte-compatible with pegasus_const.cpp):
  manual_compact.disabled                         "true"/"false"
  manual_compact.max_concurrent_running_count     int
  manual_compact.once.trigger_time                unix seconds
  manual_compact.once.target_level                -1 | level
  manual_compact.once.bottommost_level_compaction "force"|"skip"
  manual_compact.periodic.trigger_time            "3:00,21:00" local times
  (periodic.* supports the same target_level / bottommost keys)

Time is injectable (`mock_now`) the way the reference gates
now_timestamp() under PEGASUS_UNIT_TEST (manual_compact_service.h:77-79).

A device compaction is probed by its device's watchdog before and after
the merge. There is no lane guard: a failed compaction is recorded for
query_compact_state, persists no finish time, and re-raises.
"""

import threading
import time

from ..base import consts
from ..runtime.perf_counters import counters

_QUEUED = "queued"
_RUNNING = "running"
_IDLE = "idle"


class _ConcurrencyGate:
    """Process-wide running-count cap (cluster-wide in the reference,
    enforced by meta-spread envs; one process hosts many replicas here).
    urgent=True bypasses the cap: a partition the cluster compaction
    scheduler marked urgent jumps the queue instead of waiting behind
    elective compactions."""

    def __init__(self):
        self._lock = threading.Lock()
        self.running = 0

    def try_acquire(self, limit: int, urgent: bool = False) -> bool:
        with self._lock:
            if limit > 0 and self.running >= limit:
                if not urgent:
                    return False
                # counted HERE, under the lock that decided it: this
                # acquire really did pass a cap that would have blocked
                counters.rate("manual_compact.queue_jump_count").increment()
            self.running += 1
            return True

    def release(self):
        with self._lock:
            self.running -= 1


GATE = _ConcurrencyGate()


class ManualCompactService:
    MIN_INTERVAL_SECONDS = 0  # tests override; reference flag default 0=any

    def __init__(self, server, mock_now: int = None):
        self.server = server
        self._mock_now = mock_now
        self._state = _IDLE
        self._lock = threading.Lock()
        self._enqueue_ms = 0
        self._start_ms = 0
        self._last_finish_ms = int(server.engine.meta_store.get(
            "pegasus_last_manual_compact_finish_time", 0)) * 1000
        self._last_used_ms = 0
        self._last_trace = None  # per-stage breakdown of the last run
        self._last_error = None  # repr of the last FAILED run's exception
        self._last_fail_ms = 0

    # ------------------------------------------------------------------ time

    def now_ms(self) -> int:
        return (self._mock_now * 1000 if self._mock_now is not None
                else int(time.time() * 1000))

    def set_mock_now(self, seconds: int):
        self._mock_now = seconds

    # ------------------------------------------------------------------ envs

    def start_manual_compact_if_needed(self, envs: dict) -> bool:
        """Called on every app-env update (and periodically); returns True
        when a compaction was started."""
        if self._check_disabled(envs):
            return False
        opts = None
        if self._check_once(envs):
            opts = self._extract_opts(envs, consts.MANUAL_COMPACT_ONCE_KEY_PREFIX)
        elif self._check_periodic(envs):
            opts = self._extract_opts(envs,
                                      consts.MANUAL_COMPACT_PERIODIC_KEY_PREFIX)
        if opts is None:
            return False
        limit = int(envs.get(
            consts.MANUAL_COMPACT_MAX_CONCURRENT_RUNNING_COUNT_KEY, 0))
        # an urgent scheduler token jumps the concurrency queue (the gate
        # counts real jumps as manual_compact.queue_jump_count)
        urgent = self.server.engine.compact_policy()[0] == "urgent"
        with self._lock:
            if self._state != _IDLE:
                return False
            if not GATE.try_acquire(limit, urgent=urgent):
                return False
            self._state = _QUEUED
            self._enqueue_ms = self.now_ms()
        counters.rate("manual_compact.enqueue_count").increment()
        try:
            self._run(opts)
        finally:
            GATE.release()
        return True

    def _check_disabled(self, envs) -> bool:
        return str(envs.get(consts.MANUAL_COMPACT_DISABLED_KEY,
                            "false")).lower() == "true"

    def _check_once(self, envs) -> bool:
        t = envs.get(consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY)
        if t is None:
            return False
        trigger_ms = int(t) * 1000
        return trigger_ms > self._last_finish_ms and self.now_ms() >= trigger_ms

    def _check_periodic(self, envs) -> bool:
        spec = envs.get(consts.MANUAL_COMPACT_PERIODIC_TRIGGER_TIME_KEY)
        if not spec:
            return False
        now_s = self.now_ms() // 1000
        lt = time.localtime(now_s)
        midnight = now_s - (lt.tm_hour * 3600 + lt.tm_min * 60 + lt.tm_sec)
        for hhmm in str(spec).split(","):
            hhmm = hhmm.strip()
            if not hhmm:
                continue
            hh, _, mm = hhmm.partition(":")
            trigger = midnight + int(hh) * 3600 + int(mm or 0) * 60
            if now_s >= trigger and trigger * 1000 > self._last_finish_ms:
                return True
        return False

    def _extract_opts(self, envs, prefix) -> dict:
        tl = int(envs.get(prefix + consts.MANUAL_COMPACT_TARGET_LEVEL_KEY, -1))
        bl = envs.get(prefix + consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_KEY,
                      consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_SKIP)
        return {
            "target_level": None if tl <= 0 else tl,
            "bottommost": bl == consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_FORCE,
        }

    # ------------------------------------------------------------------- run

    def _run(self, opts: dict):
        with self._lock:
            self._state = _RUNNING
            self._start_ms = self.now_ms()
        counters.rate("manual_compact.running_count").increment()
        # device-backed compactions get a liveness probe BEFORE the merge
        # (a wedged device is attributed to pre-existing device state, not
        # to the compaction) and AFTER it (refresh last_ok / catch an
        # in-run wedge the moment the merge returns or raises)
        is_device = getattr(self.server.engine.opts, "backend",
                            "cpu") != "cpu"
        if is_device:
            # start() arms the background probe loop (idempotent): a merge
            # that WEDGES never returns, so only a re-probing loop can
            # accumulate the consecutive failures that flip
            # wedged_at_stage while query_compact_state reports 'running'
            self._watchdog().start()
            self._watchdog().probe()
        error = None
        try:
            stats = self.server.engine.manual_compact(
                bottommost=opts["bottommost"],
                target_level=opts["target_level"],
                now=self._mock_now,
            )
            with self._lock:
                self._last_trace = stats.get("trace")
        except BaseException as e:
            # a FAILED run must not record finish state: persisting
            # `pegasus_last_manual_compact_finish_time` here would dedup
            # the once-trigger as "finished" and the compaction would
            # never be retried. BaseException, not Exception — an
            # interrupt (shutdown SIGINT/SystemExit) mid-compaction must
            # not be recorded as finished either. The failure is recorded
            # for query_compact_state and re-raised to the caller.
            error = e
            if isinstance(e, Exception):
                counters.rate("manual_compact.failure_count").increment()
            raise
        finally:
            if is_device:
                self._watchdog().probe()
            finish = self.now_ms()
            with self._lock:
                self._last_used_ms = finish - self._start_ms
                self._state = _IDLE
                if error is None:
                    self._last_finish_ms = finish
                    self._last_error = None
                else:
                    self._last_fail_ms = finish
                    self._last_error = repr(error)
            if error is None:
                self.server.engine.meta_store[
                    "pegasus_last_manual_compact_finish_time"] = finish // 1000

    def _watchdog(self):
        from ..ops.device_watchdog import watchdog_for

        return watchdog_for(self.server.engine.device)

    # ----------------------------------------------------------------- state

    def query_compact_state(self) -> str:
        """Human string like the reference's query_compact_state, plus the
        watchdog's wedge attribution and the offload placement."""
        with self._lock:
            if self._state == _RUNNING:
                out = (f"running; started at {self._start_ms} "
                       f"(queued at {self._enqueue_ms})")
            elif self._state == _QUEUED:
                out = f"queued at {self._enqueue_ms}"
            elif self._last_finish_ms:
                out = (f"idle; last finish at {self._last_finish_ms}, "
                       f"used {self._last_used_ms} ms")
            else:
                out = "idle; never compacted"
            if self._last_error is not None:
                out += (f"; last attempt FAILED at {self._last_fail_ms}: "
                        f"{self._last_error}")
        if getattr(self.server.engine.opts, "backend", "cpu") != "cpu":
            wedged = self._watchdog().wedged_at_stage
            if wedged is not None:
                out += f"; device wedged at stage {wedged}"
        target = self.server.engine.offload_target()
        if target:
            out += f"; compaction offload -> {target}"
        return out

    @property
    def last_trace(self):
        """Per-stage breakdown (tracing.TraceSession.summary) of the last
        completed manual compaction, or None."""
        with self._lock:
            return self._last_trace

    @property
    def last_finish_time_ms(self) -> int:
        return self._last_finish_ms
