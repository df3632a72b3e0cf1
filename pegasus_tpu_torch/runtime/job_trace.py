"""Causal job tracing for the background planes.

Port of pegasus_tpu/runtime/job_trace.py, with its job ids, hop names and
JSON, so a timeline stitches across the packages. Where the RequestTracer
(runtime/tracing.py) gives every foreground request one timeline, the
JobTracer gives every background unit of work (a compaction, a learn, an
offload round) a CLUSTER-UNIQUE job id (node seed + counter, so two
nodes never mint the same id) and records per-hop spans into a bounded
per-job timeline. The id is propagated across hops:

  - the engine mints an id per compaction (engine/db.py _traced_compact,
    manual_compact) and its merge and install hops land in it;
  - the pipeline pool carries the active job across its thread hop
    (ops/pipeline.py submit), so a deferred install's hop lands in the
    compaction job that queued it;
  - the compaction-offload wire carries the id in the
    ``RPC_COMPACT_OFFLOAD_*`` messages; the service records its own
    ship/merge hops against the id and returns them in the merge
    response, and the tenant STITCHES them into its timeline
    (origin-tagged): one timeline spanning two hosts;
  - each learn is a job whose prepare / fetch / swap hops land in one
    timeline (replication/replica.py, replication/learn.py), with the id
    carried in the learn messages so the serving primary can attribute
    its pins.

Each process records the hops IT closes, keyed by the shared id. In a
onebox (one process, one JOB_TRACER) every plane writes into ONE record.

Surfaces: the ``job-trace`` remote command (pid-keyed) and shell
``job_trace``.

Counters: ``job.active`` (gauge), ``job.completed`` (rate),
``job.spans_dropped`` (rate: hops past the per-job cap).
"""

import collections
import os
import random
import threading
import time
from contextlib import contextmanager

from .perf_counters import counters


class JobTracer:
    MAX_ACTIVE = 1024   # leaked/abandoned job guard (oldest evicted)
    MAX_HOPS = 256      # per-job hop cap (a long-lived duplicator job
    # keeps its bounded head; overflow counts in job.spans_dropped)

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ring = collections.deque(maxlen=capacity)  # completed jobs
        self._active = {}   # job_id -> open timeline record
        # node seed: pid + random salt — two processes (or two boots of
        # one) can never mint colliding ids, which is what lets a remote
        # service record hops against an id it did not mint
        self._seed = f"{os.getpid():x}-{random.getrandbits(24):06x}"
        self._seq = 0
        self._c_active = counters.number("job.active")
        self._c_completed = counters.rate("job.completed")
        self._c_dropped = counters.rate("job.spans_dropped")

    # ------------------------------------------------------------ identity

    def mint(self) -> str:
        """A fresh cluster-unique job id: ``j<node-seed>-<counter>``."""
        with self._lock:
            self._seq += 1
            return f"j{self._seed}-{self._seq:x}"

    def current(self):
        """The job id active in this thread, or None."""
        return getattr(self._local, "job", None)

    # ----------------------------------------------------------- lifecycle

    def begin(self, kind: str, job_id: str = None, **attrs) -> str:
        """Open (or join) a job timeline. With ``job_id`` the record is
        keyed by a propagated id (the scheduler's token, an offload
        begin request); without one a fresh local id is minted. Joining
        an id this process already opened is idempotent — the existing
        record keeps its start time and kind."""
        jid = job_id or self.mint()
        with self._lock:
            e = self._active.get(jid)
            if e is None:
                while len(self._active) >= self.MAX_ACTIVE:
                    self._active.pop(next(iter(self._active)))
                e = {"job_id": jid, "kind": kind, "ts": time.time(),
                     "hops": [], "attrs": dict(attrs), "dropped": 0}
                self._active[jid] = e
            else:
                e["attrs"].update(attrs)
            self._c_active.set(len(self._active))
        return jid

    def finish(self, job_id: str, status: str = "ok", **attrs) -> None:
        """Close a job: the record moves to the completed ring with its
        end-to-end duration. Unknown/already-finished ids no-op (a
        propagated finish can race a MAX_ACTIVE eviction)."""
        with self._lock:
            e = self._active.pop(job_id, None)
            self._c_active.set(len(self._active))
        if e is None:
            return
        e["attrs"].update(attrs)
        e["status"] = status
        e["duration_us"] = int((time.time() - e["ts"]) * 1e6)
        with self._lock:
            self._ring.append(e)
        self._c_completed.increment()

    @contextmanager
    def job(self, kind: str, job_id: str = None, **attrs):
        """begin + activate in this thread + finish at exit — the owning
        scope of a background unit of work (a streamed learn, a traced
        compaction). Nested inside an already-active job this records a
        plain hop instead of a second job."""
        if self.current() is not None:
            with self.hop(f"{kind}.nested"):
                yield self.current()
            return
        jid = self.begin(kind, job_id=job_id, **attrs)
        self._local.job = jid
        try:
            yield jid
        except BaseException:
            self.finish(jid, status="error")
            raise
        else:
            self.finish(jid)
        finally:
            self._local.job = None

    @contextmanager
    def adopt(self, job_id):
        """Install an existing job id in THIS thread (pipeline-pool and
        lane-guard worker hops, the engine trigger adopting the
        scheduler token) without owning its finish. job_id may be None
        (untraced caller) — then this is a no-op."""
        if job_id is None:
            yield None
            return
        prev = getattr(self._local, "job", None)
        self._local.job = job_id
        try:
            yield job_id
        finally:
            self._local.job = prev

    # ---------------------------------------------------------------- hops

    def _append_hop(self, job_id: str, rec: dict) -> None:
        with self._lock:
            e = self._active.get(job_id)
            if e is None:
                return
            if len(e["hops"]) >= self.MAX_HOPS:
                e["dropped"] += 1
            else:
                e["hops"].append(rec)
                return
        self._c_dropped.increment()

    @contextmanager
    def hop(self, name: str, **attrs):
        """Record one timed hop of the thread's active job (no-op
        without one). Yields the mutable attr dict so counts discovered
        mid-hop can be added before it closes."""
        jid = self.current()
        if jid is None:
            yield attrs
            return
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            rec = {"name": name, "ts": ts,
                   "duration_us": int((time.perf_counter() - t0) * 1e6)}
            rec.update(attrs)
            self._append_hop(jid, rec)

    def note(self, name: str, job_id: str = None, **attrs) -> None:
        """Record a zero-duration hop (a point event: a scheduler
        decision, a token delivery, a lane fallback). With an explicit
        ``job_id`` the hop lands on that job — opening a remote-view
        record if this process has not seen the id yet (how a serving
        primary attributes its learn pins); without one it lands on the
        thread's active job and no-ops if there is none."""
        jid = job_id or self.current()
        if jid is None:
            return
        if job_id is not None:
            with self._lock:
                known = jid in self._active
            if not known:
                self.begin("remote", job_id=jid)
        rec = {"name": name, "ts": time.time(), "duration_us": 0}
        rec.update(attrs)
        self._append_hop(jid, rec)

    def stitch(self, job_id: str, hops, origin: str = "") -> None:
        """Merge hops recorded by ANOTHER process (the offload service's
        ship/merge spans, returned in the merge response) into this
        process's timeline for the job, each tagged with its origin —
        one timeline spanning two hosts. Malformed entries are dropped,
        never raised: the remote view is diagnostic, the merge result
        is not."""
        if not hops:
            return
        for h in hops:
            if not isinstance(h, dict) or "name" not in h:
                continue
            rec = dict(h)
            rec.setdefault("ts", time.time())
            rec.setdefault("duration_us", 0)
            if origin:
                rec["origin"] = origin
            self._append_hop(job_id, rec)

    # ------------------------------------------------------------ read API

    def _json_ready(self, e: dict) -> dict:
        out = {"job_id": e["job_id"], "kind": e["kind"], "ts": e["ts"],
               "hops": list(e["hops"]), "attrs": dict(e["attrs"])}
        if e.get("dropped"):
            out["hops_dropped"] = e["dropped"]
        if "status" in e:
            out["status"] = e["status"]
            out["duration_us"] = e["duration_us"]
        return out

    def jobs(self, last: int = 50, active: bool = True) -> list:
        """The most recent completed job timelines (oldest first), plus
        — with active=True — the still-open ones, JSON-ready."""
        with self._lock:
            done = [self._json_ready(e) for e in list(self._ring)[-last:]]
            live = ([self._json_ready(e) for e in self._active.values()]
                    if active else [])
        return done + live

    def find(self, job_id: str):
        """One timeline by id — active records first (the job being
        hunted is usually the one still wedged)."""
        with self._lock:
            e = self._active.get(job_id)
            if e is not None:
                return self._json_ready(e)
            for t in reversed(self._ring):
                if t["job_id"] == job_id:
                    return self._json_ready(t)
        return None

    def window(self, seconds: float = None) -> list:
        """Timelines that overlap the trailing window (the flight
        recorder's incident scrape); None = everything retained."""
        if seconds is None:
            return self.jobs(last=len(self._ring))
        floor = time.time() - seconds
        return [j for j in self.jobs(last=len(self._ring))
                if j["ts"] >= floor
                or any(h.get("ts", 0) >= floor for h in j["hops"])]


# process-wide tracer, like COMPACT_TRACER / REQUEST_TRACER: the engine,
# ops and replication planes record into this instance (one process = one
# local timeline view)
JOB_TRACER = JobTracer()
