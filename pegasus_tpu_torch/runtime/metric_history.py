"""Metric history: the time axis over the perf-counter registry.

Port of pegasus_tpu/runtime/metric_history.py, with its knobs, default
prefixes and window JSON. `counters.snapshot()` answers "what is the
value NOW"; every scrape-driven consumer therefore loses an excursion
that resolves between two scrapes (an L0 stall that cleared, a 30-second
dispatch-queue spike). This module samples a slice of the registry on a
fixed cadence into a fixed-size ring, so the last
``capacity * interval`` seconds of every selected series can be queried
by window after the fact.

Sampling per counter kind:

  * rate counters publish a rolling per-second rate, stored as-is;
  * number/gauge counters store the level; the window query can derive
    per-sample deltas from consecutive ring entries (``deltas=True``);
  * percentile counters flatten to their p99 as ``<name>.p99``.

Knobs: ``PEGASUS_HISTORY_INTERVAL_S`` (default 5), ``PEGASUS_HISTORY_CAP``
samples retained (default 720: an hour at the default cadence),
``PEGASUS_HISTORY_PREFIXES`` (comma-separated counter-name prefixes).

Surface: the ``metrics-history`` remote command (pid-keyed JSON). One
process-wide instance (HISTORY) is refcount-started by the service roles
and the replica stub; ``history.sample_count`` rates the cadence.
"""

import os
import threading
import time

from . import lockrank
from .perf_counters import counters
from .tasking import spawn_thread

_DEFAULT_PREFIXES = (
    "compact.lane.", "read.lane.", "offload.", "engine.", "rpc.server.",
    "plog.", "serve.group.", "replica.", "dup.lag.", "events.",
    "request.trace.", "manual_compact.", "doctor.", "incident.",
    "collector.", "sched.", "audit.",
    # the compaction stage spans' duration p99s
    "compact.stage.",
    # the learn plane's ship/verify series and the job tracer's gauges
    "learn.", "job.",
    # the tenant plane: per-table ledgers and SLO burn gauges
    "table.", "slo.",
    # device-served range reads: batch/row totals and the device/host split
    "read.range.",
    # the data plane's wave/batch rates and the serving plane's series
    "native.", "serve.",
)


class MetricHistory:
    def __init__(self, interval_s: float = None, capacity: int = None,
                 prefixes=None):
        self.interval_s = float(
            os.environ.get("PEGASUS_HISTORY_INTERVAL_S", "5")
            if interval_s is None else interval_s)
        self.capacity = max(2, int(
            os.environ.get("PEGASUS_HISTORY_CAP", "720")
            if capacity is None else capacity))
        if prefixes is None:
            env = os.environ.get("PEGASUS_HISTORY_PREFIXES", "")
            prefixes = tuple(p.strip() for p in env.split(",")
                             if p.strip()) or _DEFAULT_PREFIXES
        self.prefixes = tuple(prefixes)
        self._lock = lockrank.named_lock("history.ring")
        # ring of (ts, {name: float}) samples, oldest overwritten
        self._ring = [None] * self.capacity  #: guarded_by self._lock
        self._next = 0                       #: guarded_by self._lock
        # refcounted start/stop: meta+replica+collector in one onebox
        # process share one sampler, and the last app stopping stops it
        self._refs = 0                       #: guarded_by self._lock
        self._stop_evt = None                #: guarded_by self._lock
        self._c_sample = counters.rate("history.sample_count")

    # ------------------------------------------------------------ sampling

    def sample_once(self, now: float = None) -> dict:
        """Take one sample (also the test seam: `now` injects the time
        axis). -> the stored {name: value} dict."""
        snap = counters.snapshot()
        vals = {}
        for name, v in snap.items():
            if not name.startswith(self.prefixes):
                continue
            if isinstance(v, dict):  # percentile counter: keep the p99
                vals[name + ".p99"] = float(v.get("p99", 0))
            else:
                vals[name] = float(v)
        ts = time.time() if now is None else now
        with self._lock:
            self._ring[self._next % self.capacity] = (ts, vals)
            self._next += 1
        self._c_sample.increment()
        return vals

    def _loop(self, stop_evt: threading.Event) -> None:
        while not stop_evt.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 - a bad counter value
                # must never kill the history cadence for the process life
                print(f"[metric-history] sample failed: {e!r}", flush=True)

    def start(self) -> "MetricHistory":
        """Refcounted: the first start spawns the sampler thread, later
        starts just bump the count."""
        with self._lock:
            self._refs += 1
            if self._stop_evt is not None:
                return self
            self._stop_evt = threading.Event()
            evt = self._stop_evt
        spawn_thread(self._loop, evt, daemon=True, name="metric-history")
        return self

    def stop(self) -> None:
        """Drop one reference; the last one stops the sampler thread
        (it exits at its next wait tick — bounded by interval_s)."""
        with self._lock:
            self._refs = max(0, self._refs - 1)
            if self._refs or self._stop_evt is None:
                return
            evt, self._stop_evt = self._stop_evt, None
        evt.set()

    # ------------------------------------------------------------- queries

    def _samples_locked(self) -> list:  #: requires self._lock
        n = self._next
        if n <= self.capacity:
            return [s for s in self._ring[:n]]
        cut = n % self.capacity
        return self._ring[cut:] + self._ring[:cut]

    def window(self, seconds: float = None, prefix: str = None,
               names=None, deltas: bool = False, now: float = None) -> dict:
        """The ring's tail as JSON-ready samples, oldest first.
        `seconds` keeps samples with ts >= now - seconds; `prefix`/
        `names` filter series; `deltas=True` adds per-sample deltas vs
        the PREVIOUS retained sample (the level-counter rate view)."""
        cutoff = None
        if seconds is not None:
            cutoff = (time.time() if now is None else now) - seconds
        with self._lock:
            samples = self._samples_locked()
        names = set(names) if names else None
        out, prev = [], None
        for s in samples:
            if s is None:
                continue
            ts, vals = s
            keep = {k: v for k, v in vals.items()
                    if (prefix is None or k.startswith(prefix))
                    and (names is None or k in names)}
            if cutoff is not None and ts < cutoff:
                prev = keep  # the last pre-window sample anchors deltas
                continue
            entry = {"ts": ts, "values": keep}
            if deltas:
                entry["deltas"] = {
                    k: round(v - prev[k], 6) if prev and k in prev else 0.0
                    for k, v in keep.items()}
            out.append(entry)
            prev = keep
        return {"interval_s": self.interval_s, "capacity": self.capacity,
                "samples": out}

    def series(self, name: str, seconds: float = None) -> list:
        """[(ts, value)] for one counter over the window — convenience."""
        w = self.window(seconds=seconds, names=[name])
        return [(s["ts"], s["values"][name]) for s in w["samples"]
                if name in s["values"]]

    def reset(self) -> None:
        """Test hook: empty the ring (sampler refs untouched)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0


# process-wide sampler (one per OS process: each partition-group worker
# runs its own, exactly like the counter registry it samples)
HISTORY = MetricHistory()
