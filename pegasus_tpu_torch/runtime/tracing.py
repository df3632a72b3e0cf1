"""Stage-span tracing for the engine's device lane, and request tracing
for the serving path.

Port of pegasus_tpu/runtime/tracing.py, whole: the same stage names,
counter names, ring rows and trace JSON, so the two packages' dumps
compare line for line and a trace id crosses between them.

StageTracer (COMPACT_TRACER) times the stages of background work:

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

Every closed span lands in a bounded ring (trace / dump: the
`compact-trace-dump` remote command) and in the counter registry under
`compact.stage.<name>.*` (count, records and bytes rates, a duration_us
percentile). The open spans of every thread stay visible (open_stages,
innermost_open), so the device watchdog can name the stage a wedged
device stopped in.

A span measures host wall time. Where a stage ends in a device
synchronisation (the `device` span ends after torch.cuda.synchronize),
that wall time covers the device work it launched.

A TraceSession aggregates every span closed while it is active. Unlike
the JAX package's, whose sessions are thread-local and handed to worker
threads by propagate_sessions/adopt_sessions, the port's sessions are
process-wide: a span closed on ANY thread (a pipeline worker, an RPC
worker serving an in-process server) lands in every active session, so
no hand-off is needed. The job context and the request-trace context
are thread-local and are carried across pool hops explicitly
(ops/pipeline.py submit, JOB_TRACER.adopt, REQUEST_TRACER.adopt).
"""

import collections
import os
import random
import threading
import time
from contextlib import contextmanager

from .perf_counters import counters


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
    def __init__(self, capacity: int = 4096, prefix: str = "compact"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._sessions = []
        # thread ident -> [(stage, started_wall_ts), ...] innermost LAST;
        # shared (not thread-local) so the watchdog thread can read which
        # stage another thread is stuck in
        self._open = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, stage: str, records: int = 0, nbytes: int = 0):
        """Time one stage. Yields a mutable {records, bytes} box so counts
        discovered mid-span can be added before the span closes."""
        stack = self._stack()
        depth = len(stack)
        stack.append(stage)
        tid = threading.get_ident()
        with self._lock:
            self._open.setdefault(tid, []).append((stage, time.time()))
        box = {"records": records, "bytes": nbytes}
        t0 = time.perf_counter()
        c0 = time.process_time()
        try:
            yield box
        finally:
            dur_s = time.perf_counter() - t0
            # process (not thread) cpu time: other threads' work under the
            # span counts, which is what makes host contention visible
            cpu_s = time.process_time() - c0
            stack.pop()
            with self._lock:
                open_list = self._open.get(tid)
                if open_list:
                    open_list.pop()
                    if not open_list:
                        self._open.pop(tid, None)
                self._spans.append((time.time(), depth, stage, dur_s,
                                    box["records"], box["bytes"], cpu_s))
            self._export(stage, dur_s, box["records"], box["bytes"])
            for sess in list(self._sessions):
                sess._add(stage, dur_s, box["records"], box["bytes"])

    def event(self, stage: str, dur_s: float, records: int = 0,
              nbytes: int = 0) -> None:
        """Record a duration measured elsewhere under `stage`: it lands in
        the ring, the counters and the active sessions like a span."""
        with self._lock:
            self._spans.append((time.time(), 0, stage, dur_s, records,
                                nbytes, 0.0))
        self._export(stage, dur_s, records, nbytes)
        for sess in list(self._sessions):
            sess._add(stage, dur_s, records, nbytes)

    def _export(self, stage, dur_s, records, nbytes):
        base = f"{self.prefix}.stage.{stage}"
        counters.rate(f"{base}.count").increment()
        counters.percentile(f"{base}.duration_us").set(int(dur_s * 1e6))
        if records:
            counters.rate(f"{base}.records").increment(records)
        if nbytes:
            counters.rate(f"{base}.bytes").increment(nbytes)

    @contextmanager
    def session(self):
        """Aggregate the spans closed, on any thread, while the context is
        active (sessions nest; each gets its own aggregate)."""
        sess = TraceSession()
        with self._lock:
            self._sessions.append(sess)
        try:
            yield sess
        finally:
            with self._lock:
                self._sessions.remove(sess)

    # ----------------------------------------------- live-state inspection

    def open_stages(self) -> dict:
        """thread ident -> [stage, ...] (outermost first) for every thread
        with an open span: what the watchdog snapshots on a failed probe."""
        with self._lock:
            return {tid: [s for s, _ in st] for tid, st in self._open.items()}

    def innermost_open(self):
        """(stage, started_wall_ts) of the open span most likely wedged:
        the innermost span of whichever stack has sat in its innermost
        stage the LONGEST. None when nothing is open."""
        best = None
        with self._lock:
            for st in self._open.values():
                if not st:
                    continue
                stage, t0 = st[-1]
                if best is None or t0 < best[1]:
                    best = (stage, t0)
        return best

    # ------------------------------------------------------ ring-buffer IO

    def trace(self, last: int = 100) -> list:
        """The most recent closed spans as JSON-ready dicts (close order:
        children close before their parents)."""
        with self._lock:
            spans = list(self._spans)[-last:]
        return [{"ts": ts, "depth": depth, "stage": stage,
                 "duration_us": int(dur_s * 1e6),
                 "cpu_us": int(cpu_s * 1e6),
                 "records": records, "bytes": nbytes}
                for ts, depth, stage, dur_s, records, nbytes, cpu_s in spans]

    def dump(self, last: int = 100) -> str:
        rows = self.trace(last)
        return "\n".join(
            f"{r['ts']:.6f} {'  ' * r['depth']}{r['stage']} "
            f"{r['duration_us']}us records={r['records']} bytes={r['bytes']}"
            for r in rows) or "no spans"


# process-wide tracer: every pipeline layer threads spans through it
COMPACT_TRACER = StageTracer()


# ======================================================== request tracing
#
# Where the StageTracer above times the compaction pipeline (a background
# job), the RequestTracer times the SERVING path: one trace per client
# request, its id carried in the RPC header (rpc/transport.py RpcHeader
# trace_id/trace_sampled) from client/client.py through the replica
# serverlet, the PacificA prepare/commit round, the private-log append and
# the engine apply. Spans are recorded at close time (children before
# parents, like StageTracer) into one per-trace record.
#
# Retention is two-tier:
#   - a sampled ring buffer of completed traces (every `sample_every`-th
#     trace; default every trace — this is a Python build, span cost is a
#     dict append), served by the `request-trace-dump` remote command;
#   - a slow-request ledger: ANY trace whose end-to-end duration reaches
#     `slow_threshold_us` keeps its full stage timeline regardless of
#     sampling — served by the `slow-requests` remote command. A slow
#     put is attributable to the client hop, the RPC layer, the quorum
#     round or the engine without reproducing it.
#
# Cross-process semantics: each process records the spans IT closes. The
# originating client owns the trace (root_local) and finalizes it; a
# server process that received the context over the wire finalizes its own
# partial view when its last concurrently-open handler for that trace
# returns. In a onebox (everything in one process, one global
# REQUEST_TRACER) the two sides share one record, so a single client put
# yields a single trace holding client, rpc, replication, plog and engine
# spans.


class TraceContext:
    """What travels in the RPC header: trace identity + sampling flag.
    `remote` marks a context that arrived over the wire (this process does
    not own the trace root)."""

    __slots__ = ("trace_id", "sampled", "remote")

    def __init__(self, trace_id: int, sampled: bool = True,
                 remote: bool = False):
        self.trace_id = trace_id
        self.sampled = sampled
        self.remote = remote


class RequestTracer:
    MAX_ACTIVE = 4096       # leaked/abandoned trace guard
    MAX_SPANS = 512         # per-trace span cap (runaway scan sessions)

    def __init__(self, capacity: int = 512, slow_capacity: int = 256):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ring = collections.deque(maxlen=capacity)
        self._slow = collections.deque(maxlen=slow_capacity)
        self._active = {}   # trace_id -> open trace record
        self.slow_threshold_us = int(
            os.environ.get("PEGASUS_SLOW_REQUEST_US", "50000"))
        self.sample_every = max(1, int(
            os.environ.get("PEGASUS_TRACE_SAMPLE_EVERY", "1")))
        self._seq = 0

    # ------------------------------------------------------------ context

    def current(self):
        """The TraceContext active in this thread, or None."""
        return getattr(self._local, "ctx", None)

    def _entry(self, trace_id: int, op: str, root_local: bool) -> dict:
        with self._lock:
            e = self._active.get(trace_id)
            if e is None:
                while len(self._active) >= self.MAX_ACTIVE:
                    self._active.pop(next(iter(self._active)))
                e = {"trace_id": trace_id, "op": op, "started": time.time(),
                     "spans": [], "root_local": root_local, "refs": 0}
                self._active[trace_id] = e
            return e

    @contextmanager
    def root(self, op: str):
        """Begin a trace in this thread (the CLIENT side of a request).
        Records a `client.<op>` span and finalizes the trace at exit.
        Nested client ops inside an active trace (e.g. copy_data's reads
        feeding writes) record plain spans instead of new traces."""
        prev = self.current()
        if prev is not None:
            with self.span(f"client.{op}"):
                yield prev
            return
        with self._lock:
            self._seq += 1
            sampled = (self._seq % self.sample_every) == 0
        ctx = TraceContext(random.getrandbits(63) | 1, sampled)
        e = self._entry(ctx.trace_id, op, root_local=True)
        self._local.ctx = ctx
        t0 = time.perf_counter()
        try:
            with self.span(f"client.{op}"):
                yield ctx
        finally:
            self._local.ctx = None
            self._finalize(e, int((time.perf_counter() - t0) * 1e6),
                           ctx.sampled)

    @contextmanager
    def serve(self, ctx: TraceContext, op: str):
        """Install a wire-propagated context for a SERVER-side handler and
        record the `rpc.server.<op>` span. When this process does not own
        the trace root, the trace's local view finalizes once its last
        open handler returns."""
        prev = self.current()
        e = self._entry(ctx.trace_id, op, root_local=False)
        with self._lock:
            e["refs"] += 1
        self._local.ctx = ctx
        t0 = time.perf_counter()
        try:
            with self.span(f"rpc.server.{op}"):
                yield ctx
        finally:
            self._local.ctx = prev
            with self._lock:
                e["refs"] -= 1
                done = e["refs"] == 0 and not e["root_local"]
            if done:
                self._finalize(e, int((time.perf_counter() - t0) * 1e6),
                               ctx.sampled)

    @contextmanager
    def adopt(self, ctx):
        """Install an existing context in THIS thread for a worker-pool
        hop (the parallel prepare fan-out runs _send_prepare_window on pool
        threads) — spans the worker closes join the owner's trace. No
        finalize: the owning thread's root/serve does that, and it blocks
        on the workers before closing, so the trace stays active. ctx
        may be None (untraced caller) — then this is a no-op."""
        if ctx is None:
            yield None
            return
        prev = getattr(self._local, "ctx", None)
        self._local.ctx = ctx
        try:
            yield ctx
        finally:
            self._local.ctx = prev

    @contextmanager
    def span(self, name: str, **attrs):
        """Record one stage of the active trace (no-op without a context).
        Yields the mutable attr dict so counts discovered mid-span can be
        added before it closes."""
        ctx = getattr(self._local, "ctx", None)
        if ctx is None:
            yield attrs
            return
        with self._lock:
            e = self._active.get(ctx.trace_id)
        if e is None:
            yield attrs
            return
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            self._local.depth = depth
            rec = {"name": name, "ts": ts, "depth": depth,
                   "duration_us": int((time.perf_counter() - t0) * 1e6)}
            rec.update(attrs)
            with self._lock:
                if len(e["spans"]) < self.MAX_SPANS:
                    e["spans"].append(rec)

    # ---------------------------------------------------------- retention

    def _finalize(self, e: dict, dur_us: int, sampled: bool) -> None:
        with self._lock:
            self._active.pop(e["trace_id"], None)
        trace = {"trace_id": format(e["trace_id"], "016x"), "op": e["op"],
                 "ts": e["started"], "duration_us": dur_us,
                 "spans": e["spans"]}
        slow = dur_us >= self.slow_threshold_us
        with self._lock:
            if slow:
                self._slow.append(trace)
            if sampled:
                self._ring.append(trace)
        counters.rate("request.trace.completed_count").increment()
        counters.percentile("request.trace.duration_us").set(dur_us)
        if slow:
            counters.rate("request.trace.slow_count").increment()

    def trace(self, last: int = 50) -> list:
        """The most recent sampled completed traces, JSON-ready."""
        with self._lock:
            return list(self._ring)[-last:]

    def slow_requests(self, last: int = 50) -> list:
        """The slow-request ledger: full stage timelines of every request
        that crossed slow_threshold_us."""
        with self._lock:
            return list(self._slow)[-last:]

    def find(self, trace_id: str):
        """Look one completed trace up by hex id (ledger first: slow
        traces are the ones being hunted)."""
        with self._lock:
            for t in list(self._slow) + list(self._ring):
                if t["trace_id"] == trace_id:
                    return t
        return None


# process-wide request tracer: client, transport, replication and engine
# all record into this instance (one process = one local trace view)
REQUEST_TRACER = RequestTracer()
