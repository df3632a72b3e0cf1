"""Stage-span timer for the engine's device lane.

One process-wide tracer, COMPACT_TRACER, times the stages under the same
names the JAX package's tracer uses, so per-stage breakdowns of the two
packages compare line for line:

  pack, h2d, device, gather   the compaction pipeline (ops/compact.py)
  sst_write                   the SST write-out (engine/sstable.py)
  read.lookup, read.range     device-served point and range reads
                              (ops/device_lookup.py)
  pipeline.stall              the calling thread waiting on a pipeline
                              worker (ops/pipeline.py)
  pipeline.overlap            an event, not a span: the seconds one item's
                              worker stages ran beside other work
  offload.ship, offload.merge, offload.fetch
                              one compaction-offload round, tenant side
                              (replication/compact_offload.py)

A span measures host wall time. Where a stage ends in a device
synchronisation (the `device` span ends after torch.cuda.synchronize),
that wall time covers the device work it launched.

A TraceSession aggregates every span closed while it is active, on any
thread: stage -> {s, calls, records, bytes}. The tracer also keeps each
thread's open spans, so the device watchdog can name the stage a wedged
device stopped in (innermost_open).
"""

import threading
import time
from contextlib import contextmanager


class TraceSession:
    def __init__(self):
        self.stages = {}
        self._lock = threading.Lock()

    def _add(self, stage: str, dur_s: float, records: int, nbytes: int):
        with self._lock:
            agg = self.stages.setdefault(
                stage, {"s": 0.0, "calls": 0, "records": 0, "bytes": 0})
            agg["s"] += dur_s
            agg["calls"] += 1
            agg["records"] += records
            agg["bytes"] += nbytes

    def summary(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self.stages.items()}


class StageTracer:
    def __init__(self):
        self._sessions = []
        # thread id -> its open stages, outermost first (each list is
        # touched only by its own thread; readers take snapshots)
        self._open = {}

    @contextmanager
    def span(self, stage: str, records: int = 0, nbytes: int = 0):
        """Time one stage. Yields a mutable {records, bytes} box so counts
        discovered mid-span can be added before the span closes."""
        box = {"records": records, "bytes": nbytes}
        stack = self._open.setdefault(threading.get_ident(), [])
        stack.append(stage)
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            stack.pop()
            dur_s = time.perf_counter() - t0
            for sess in list(self._sessions):
                sess._add(stage, dur_s, box["records"], box["bytes"])

    def event(self, stage: str, dur_s: float, records: int = 0,
              nbytes: int = 0) -> None:
        """Record a duration measured elsewhere under `stage`."""
        for sess in list(self._sessions):
            sess._add(stage, dur_s, records, nbytes)

    def innermost_open(self):
        """The innermost open stage of some thread, or None when no span
        is open."""
        for stack in list(self._open.values()):
            try:
                return stack[-1]
            except IndexError:  # empty, or emptied by its thread just now
                continue
        return None

    @contextmanager
    def session(self):
        """Aggregate the spans closed while the context is active
        (sessions nest; each gets its own aggregate)."""
        sess = TraceSession()
        self._sessions.append(sess)
        try:
            yield sess
        finally:
            self._sessions.remove(sess)


COMPACT_TRACER = StageTracer()
