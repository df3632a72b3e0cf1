"""Perf counter registry: number / volatile number / rate / percentile.

Port of pegasus_tpu/runtime/perf_counters.py (no dependencies, copied
whole). The four counter kinds, scrapable by name through the
perf-counters[-by-prefix/-by-substr] remote commands
(runtime/remote_command.py) and the offload service's status.
"""

import threading
import time


class Counter:
    KIND = "number"

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def increment(self, by: int = 1):
        with self._lock:
            self._value += by

    def add(self, by):
        self.increment(by)

    def set(self, value):
        with self._lock:
            self._value = value

    def value(self):
        with self._lock:
            return self._value


class VolatileCounter(Counter):
    """Reads reset the count (per-interval deltas, rDSN volatile_number)."""

    KIND = "volatile_number"

    def value(self):
        with self._lock:
            v, self._value = self._value, 0
            return v


class RateCounter(Counter):
    """Events per second over a rolling window. Reads are NON-destructive:
    the destructive reset-on-read design meant concurrent scrapers
    (/metrics, remote commands, the info collector) each stole a fraction
    of the window and all reported a fraction of the true rate. Instead
    the counter accumulates into a timestamped window; a read rolls the
    window only once it is at least MIN_WINDOW old and republishes the
    finished window's rate until the next roll — so any number of
    concurrent scrapers observe the same value."""

    KIND = "rate"
    MIN_WINDOW = 1.0  # seconds a window must cover before it can roll

    def __init__(self, name: str):
        super().__init__(name)
        self._window_start = time.monotonic()
        self._last_rate = 0.0
        self._rolled = False
        self._total = 0

    def increment(self, by: int = 1):
        with self._lock:
            self._value += by
            self._total += by

    def add(self, by):
        self.increment(by)

    def total(self) -> int:
        """Monotone event count since process start. Unlike the raw
        window accumulator, this never resets on a read — the stable
        thing to assert on when any concurrent scraper (collector,
        /metrics, the metric-history sampler) may roll the window."""
        with self._lock:
            return self._total

    def value(self):
        with self._lock:
            now = time.monotonic()
            dt = now - self._window_start
            if dt >= self.MIN_WINDOW:
                self._last_rate = self._value / dt
                self._value = 0
                self._window_start = now
                self._rolled = True
            elif not self._rolled and self._value:
                # no window ever completed (freshly started process):
                # report the partial window instead of 0. ONLY then — an
                # idle-then-burst transition must keep publishing finished
                # windows, or a scrape 10ms into the burst would divide by
                # 10ms and report a 100x-inflated spike
                return self._value / max(dt, 1e-9)
            return self._last_rate


class PercentileCounter(Counter):
    """Sliding-window percentiles (p50/p90/p95/p99/p999)."""

    KIND = "percentile"
    WINDOW = 5000

    def __init__(self, name: str):
        super().__init__(name)
        self._samples = []
        self._idx = 0

    def set(self, value):
        with self._lock:
            if len(self._samples) < self.WINDOW:
                self._samples.append(value)
            else:
                self._samples[self._idx] = value
                self._idx = (self._idx + 1) % self.WINDOW

    add = set
    increment = set

    def reset(self):
        """Drop every sample: the window restarts empty."""
        with self._lock:
            self._samples = []
            self._idx = 0

    PCTS = (("p50", 0.50), ("p90", 0.90), ("p95", 0.95),
            ("p99", 0.99), ("p999", 0.999))

    def percentile(self, p: float):
        with self._lock:
            if not self._samples:
                return 0
            s = sorted(self._samples)
            k = min(len(s) - 1, int(p * len(s)))
            return s[k]

    def percentiles(self) -> dict:
        """One sort for the whole p50/p90/p95/p99/p999 dict (snapshot()
        exports this instead of the bare p99)."""
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return {name: 0 for name, _ in self.PCTS}
        return {name: s[min(len(s) - 1, int(p * len(s)))]
                for name, p in self.PCTS}

    def value(self):
        return self.percentile(0.99)


class GaugeCounter(Counter):
    """A level read from a function at scrape time (a module's own count,
    such as a kernel's launches, exported without a second copy)."""

    KIND = "gauge"

    def __init__(self, name: str, fn=None):
        super().__init__(name)
        self._fn = fn or (lambda: 0)

    def value(self):
        return self._fn()


_KINDS = {c.KIND: c for c in (Counter, VolatileCounter, RateCounter, PercentileCounter)}


class PerfCounters:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}

    def get(self, name: str, kind: str = "number"):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = _KINDS[kind](name)
                self._counters[name] = c
            elif c.KIND != kind:
                raise TypeError(
                    f"counter {name!r} already registered as {c.KIND}, requested {kind}"
                )
            return c

    def number(self, name):
        return self.get(name, "number")

    def volatile_number(self, name):
        return self.get(name, "volatile_number")

    def rate(self, name):
        return self.get(name, "rate")

    def percentile(self, name):
        return self.get(name, "percentile")

    def gauge(self, name, fn):
        """Register (or re-point) a gauge that reads fn() when scraped."""
        with self._lock:
            c = self._counters.get(name)
            if c is not None and c.KIND != GaugeCounter.KIND:
                raise TypeError(f"counter {name!r} already registered as "
                                f"{c.KIND}, requested gauge")
            self._counters[name] = GaugeCounter(name, fn)
            return self._counters[name]

    def snapshot(self, substr: str = None, prefix: str = None) -> dict:
        """perf-counters[-by-substr/-by-prefix] scrape. Percentile
        counters export their full {p50,p90,p95,p99,p999} dict (a single
        p99 hid the tail shape every latency investigation starts from);
        every other kind exports a scalar."""
        with self._lock:
            items = list(self._counters.items())
        out = {}
        for name, c in items:
            if substr is not None and substr not in name:
                continue
            if prefix is not None and not name.startswith(prefix):
                continue
            out[name] = (c.percentiles() if c.KIND == "percentile"
                         else c.value())
        return out

    def remove(self, name: str):
        with self._lock:
            self._counters.pop(name, None)


# process-wide registry, like rDSN's global counter table
counters = PerfCounters()
