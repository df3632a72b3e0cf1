"""Structured event ring: the state transitions a process records.

Port of pegasus_tpu/runtime/events.py, whole (the bounded ring, `emit`,
and the flight recorder's `emitted_total` / `reset`).
Counters are levels; an event records that something happened (a merge
finished, a tenant was refused), with a wall-clock ts and a monotone
per-process seq:

    from ..runtime import events
    events.emit("offload.reject", severity="warn", reason="merge_cap")

The ring is bounded (`PEGASUS_EVENTS_CAP` entries, default 4096); every
overwrite of an occupied slot counts into ``events.drop_count``. The
``events-dump`` remote command (runtime/remote_command.py) reads it.
"""

import os
import threading
import time

from .perf_counters import counters


class EventBus:
    """Bounded process-wide ring of (seq, ts, name, severity, attrs)."""

    def __init__(self, capacity: int = None):
        self.capacity = capacity if capacity is not None else int(
            os.environ.get("PEGASUS_EVENTS_CAP", "4096"))
        self.capacity = max(1, self.capacity)
        self._lock = threading.Lock()
        # preallocated ring + write cursor: append cost is one slot store
        self._ring = [None] * self.capacity  #: guarded_by self._lock
        self._next = 0   # total events ever emitted  #: guarded_by self._lock
        self._c_emit = counters.rate("events.emit_count")
        self._c_drop = counters.rate("events.drop_count")

    def emit(self, name: str, severity: str = "info", **attrs) -> None:
        """Record one state transition. `attrs` must be JSON-serializable
        scalars/short strings; the kwargs dict is stored as-is."""
        ts = time.time()
        with self._lock:
            slot = self._next % self.capacity
            dropped = self._ring[slot] is not None
            self._ring[slot] = (self._next, ts, name, severity,
                                attrs or None)
            self._next += 1
        self._c_emit.increment()
        if dropped:
            self._c_drop.increment()

    def snapshot(self, last: int = None, since: float = None,
                 prefix: str = None) -> list:
        """JSON-ready event dicts, oldest first. `last` bounds the count
        (applied AFTER the filters), `since` keeps events with ts >= it,
        `prefix` filters on the event name."""
        with self._lock:
            n = self._next
            if n <= self.capacity:
                entries = self._ring[:n]
            else:
                cut = n % self.capacity
                entries = self._ring[cut:] + self._ring[:cut]
        out = []
        for e in entries:
            if e is None:
                continue
            seq, ts, name, severity, attrs = e
            if since is not None and ts < since:
                continue
            if prefix is not None and not name.startswith(prefix):
                continue
            ev = {"seq": seq, "ts": ts, "name": name, "sev": severity}
            if attrs:
                ev["attrs"] = dict(attrs)
            out.append(ev)
        if last is not None and last >= 0:
            out = out[-last:] if last else []
        return out

    def emitted_total(self) -> int:
        """Total events ever emitted (monotone; the ring holds the tail)."""
        with self._lock:
            return self._next

    def reset(self) -> None:
        """Test hook: empty the ring."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0


# process-wide bus, like the counter registry and the tracer
EVENTS = EventBus()


def emit(name: str, severity: str = "info", **attrs) -> None:
    """Module-level shorthand for EVENTS.emit."""
    EVENTS.emit(name, severity=severity, **attrs)
