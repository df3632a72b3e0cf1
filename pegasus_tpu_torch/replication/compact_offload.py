"""Compaction offload: one card-owning compaction service serving many
CPU-only replica nodes.

Port of pegasus_tpu/replication/compact_offload.py, service and client,
on the same wire: a pegasus_tpu tenant can ship its runs to this
service and a pegasus_tpu_torch tenant to a pegasus_tpu service.

  * **Service** (``CompactOffloadService``): one process per GPU host,
    owning the card. Tenants open a job with a manifest of packed runs
    (``ops.packing.pack_run_bytes``), ship the runs as bounded
    CRC-checked chunks into content-addressed staging (a retry ships only
    what never landed), then ask for the merge. The merge runs through
    ``parallel.compact_blocks_meshed`` on the service's backend (the
    card's by default, so every merge runs the merge-path kernel) under
    an admission gate: at most ``max_concurrent`` merges in flight
    (``PEGASUS_OFFLOAD_MAX_CONCURRENT``, default 2), the rest refused,
    never queued. Jobs are TTL leases: a dead tenant's job is reaped.

  * **Client** (``offload_compact_blocks``): the node-side merge entry
    a ``backend="cpu"`` engine routes through while a placement lease
    names a service (``engine/db.py`` ``set_offload_target``). One round:
    begin, ship what is not staged, merge, fetch, finish. The service
    merges with user rules and the default-TTL rewrite masked off and the
    client applies them after the fetch, so the output is byte-identical
    to the tenant's own ``compact_blocks(..., backend="cpu")``.

There is no lane guard on either side. A build, launch or device failure
in the service's merge is an error response (its repr), and the client
raises ``OffloadError`` on any failure (a refusal, a dead service, a
digest mismatch); it never merges locally in the service's place.
"""

import hashlib
import json
import os
import shutil
import time
import zlib
from dataclasses import replace

from ..ops.compact import CompactOptions, CompactResult, apply_post_filters
from ..ops.packing import pack_run_bytes, unpack_run_bytes
from ..rpc import codec
from ..rpc import messages as rpc_msg
from ..rpc.transport import ConnectionPool, RpcError, RpcServer
from ..runtime import events, lockrank
from ..runtime.job_trace import JOB_TRACER
from ..runtime.perf_counters import counters
from ..runtime.remote_command import RemoteCommandService
from ..runtime.tracing import COMPACT_TRACER as _TRACE

RPC_COMPACT_OFFLOAD_BEGIN = "RPC_COMPACT_OFFLOAD_BEGIN"
RPC_COMPACT_OFFLOAD_SHIP = "RPC_COMPACT_OFFLOAD_SHIP"
RPC_COMPACT_OFFLOAD_MERGE = "RPC_COMPACT_OFFLOAD_MERGE"
RPC_COMPACT_OFFLOAD_FETCH = "RPC_COMPACT_OFFLOAD_FETCH"
RPC_COMPACT_OFFLOAD_FINISH = "RPC_COMPACT_OFFLOAD_FINISH"

BACKENDS = ("cuda", "cpu")

# CompactOptions fields that cross the wire. user_ops (parsed rule
# objects) and default_ttl do NOT: they run tenant-side as post filters,
# so the service needs no rule vocabulary and the output stays
# byte-identical to the tenant's local merge.
_WIRE_OPT_FIELDS = ("now", "pidx", "partition_mask", "bottommost",
                    "filter", "prefix_u32", "runs_sorted")


class OffloadError(ConnectionError):
    """An offload round failed (service dead or busy, chunk CRC, digest
    mismatch, expired job, a failed merge on the service)."""


def chunk_bytes() -> int:
    """PEGASUS_OFFLOAD_CHUNK_BYTES: bounded ship/fetch chunk size."""
    return max(4096, int(os.environ.get("PEGASUS_OFFLOAD_CHUNK_BYTES",
                                        str(1 << 20))))


def rpc_timeout_s() -> float:
    """PEGASUS_OFFLOAD_RPC_TIMEOUT_S: per-RPC bound for begin/ship/fetch
    waves (the merge call gets its own, longer bound)."""
    return float(os.environ.get("PEGASUS_OFFLOAD_RPC_TIMEOUT_S", "30"))


def merge_timeout_s() -> float:
    """PEGASUS_OFFLOAD_MERGE_TIMEOUT_S: bound on the blocking merge RPC
    (covers the service-side merge, a cold kernel build included)."""
    return float(os.environ.get("PEGASUS_OFFLOAD_MERGE_TIMEOUT_S", "300"))


def _md5(data: bytes) -> str:
    # transfer-dedup content address, not a security boundary; corruption
    # on the wire is caught by the per-chunk CRC and this digest together
    return hashlib.md5(data).hexdigest()


def wire_opts(opts: CompactOptions) -> str:
    """The merge options a tenant ships; `now` must already be resolved
    (both sides' TTL drops must agree on the clock)."""
    return json.dumps({f: getattr(opts, f) for f in _WIRE_OPT_FIELDS},
                      sort_keys=True)


def opts_from_wire(opts_json: str, backend: str, device) -> CompactOptions:
    raw = json.loads(opts_json or "{}")
    kw = {f: raw[f] for f in _WIRE_OPT_FIELDS if f in raw}
    return CompactOptions(backend=backend, device=device, user_ops=(),
                          default_ttl=0, **kw)


# registered at import so perf-counters shows them at 0 before the
# first round
for _name in ("merge_count", "ship_bytes", "ship_blocks", "skipped_blocks",
              "fetch_bytes"):
    counters.rate(f"offload.client.{_name}")


# ================================================================ service


class CompactOffloadService:
    """One card-owning compaction service process (see module docstring).
    Construct, then ``start()``; ``address`` is what tenants dial.

    backend "cuda" merges on `device` (None = the card) through the
    merge-path kernel; "cpu" is the host merge, for a host without a
    card. `mesh` is a sequence of devices; more than one is not ported
    yet (parallel/sharded_compact.py)."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "cuda", device=None, mesh=None,
                 max_concurrent: int = None, job_ttl_s: float = None):
        if backend not in BACKENDS:
            raise ValueError(f"offload service backend {backend!r}: the "
                             f"port takes {' or '.join(BACKENDS)}")
        self.root = root
        self.backend = backend
        self.device = device
        self.mesh = mesh
        self.max_concurrent = max(1, int(
            os.environ.get("PEGASUS_OFFLOAD_MAX_CONCURRENT", "2")
            if max_concurrent is None else max_concurrent))
        self.job_ttl_s = float(
            os.environ.get("PEGASUS_OFFLOAD_JOB_TTL_S", "600")
            if job_ttl_s is None else job_ttl_s)
        self._blocks_dir = os.path.join(root, "blocks")
        self._jobs_dir = os.path.join(root, "jobs")
        os.makedirs(self._blocks_dir, exist_ok=True)
        os.makedirs(self._jobs_dir, exist_ok=True)
        # leaf lock over job/staging state; never held across a merge, a
        # disk write or an RPC
        self._lock = lockrank.named_lock("offload.service")
        self._jobs = {}       #: guarded_by self._lock
        self._next_job = 0    #: guarded_by self._lock
        self._running = 0     #: guarded_by self._lock
        # digest -> {"got": set((offset, len)), "size", "finalizing"} for
        # blocks mid-ship
        self._inflight = {}   #: guarded_by self._lock
        self._merge_total = 0  #: guarded_by self._lock
        self._c_jobs = counters.number("offload.service.jobs_active")
        self._c_running = counters.number("offload.service.running_merges")
        self._c_merges = counters.rate("offload.service.merge_count")
        self._c_rejects = counters.rate("offload.service.reject_count")
        self._c_in = counters.rate("offload.service.bytes_in")
        self._c_out = counters.rate("offload.service.bytes_out")
        self._c_resumed = counters.rate("offload.service.resumed_blocks")
        self.rpc = RpcServer(host, port)
        self.rpc.register(RPC_COMPACT_OFFLOAD_BEGIN, self._on_begin)
        self.rpc.register(RPC_COMPACT_OFFLOAD_SHIP, self._on_ship)
        self.rpc.register(RPC_COMPACT_OFFLOAD_MERGE, self._on_merge)
        self.rpc.register(RPC_COMPACT_OFFLOAD_FETCH, self._on_fetch)
        self.rpc.register(RPC_COMPACT_OFFLOAD_FINISH, self._on_finish)
        self.commands = RemoteCommandService()
        self.commands.register_defaults(node_kind="compact_offload",
                                        describe=self.status)
        self.commands.register("offload-status",
                               lambda a: json.dumps(self.status()))
        self.rpc.register("RPC_CLI_CLI_CALL", self.commands.rpc_handler)
        self.address = f"{self.rpc.address[0]}:{self.rpc.address[1]}"

    def start(self) -> "CompactOffloadService":
        self.rpc.start()
        return self

    def stop(self) -> None:
        self.rpc.stop()

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        """The placement scrape: free merge slots are what a scheduler
        turns into placements."""
        with self._lock:
            jobs = len(self._jobs)
            running = self._running
            merges = self._merge_total
        staged = 0
        try:
            staged = sum(e.stat().st_size for e in os.scandir(self._blocks_dir)
                         if e.is_file())
        except OSError:
            pass
        return {"address": self.address, "backend": self.backend,
                "max_concurrent": self.max_concurrent,
                "running_merges": running,
                "free_slots": max(0, self.max_concurrent - running),
                "jobs": jobs, "merges_done": merges,
                "staged_bytes": staged}

    # ------------------------------------------------------------ plumbing

    def _block_path(self, digest: str) -> str:
        return os.path.join(self._blocks_dir, digest)

    def _trace(self, job: dict, name: str, **attrs) -> None:
        """Record one service-side hop of a job; the merge response
        returns them (spans_json) for the tenant."""
        rec = {"name": name, "ts": time.time(), "duration_us": 0}
        rec.update(attrs)
        with self._lock:
            job["spans"].append(rec)

    def _job(self, job_id: int) -> dict:
        now = time.monotonic()
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise OffloadError(f"offload job {job_id} expired/unknown")
            job["expires"] = now + self.job_ttl_s  # every RPC renews
            return job

    def _reap_locked(self, now: float) -> None:  #: requires self._lock
        for jid in [j for j, job in self._jobs.items()
                    if now >= job["expires"]]:
            job = self._jobs.pop(jid)
            shutil.rmtree(job["dir"], ignore_errors=True)
        self._c_jobs.set(len(self._jobs))

    def _gc_blocks(self) -> None:
        """Drop staged runs (and torn .part files, and their in-memory
        staging state) that no live job references once their TTL lapsed.
        Content-addressed blocks outlive jobs on purpose (a retry's ship
        resumes from them), but an abandoned mid-ship tenant must not leak
        disk or ``_inflight`` entries forever."""
        with self._lock:
            live = {e.digest for job in self._jobs.values()
                    for e in job["runs"]}
        cutoff = time.time() - self.job_ttl_s
        try:
            entries = list(os.scandir(self._blocks_dir))
        except OSError:
            return
        for e in entries:
            digest = e.name[:-5] if e.name.endswith(".part") else e.name
            try:
                if digest not in live and e.stat().st_mtime < cutoff:
                    os.unlink(e.path)
                    with self._lock:
                        self._inflight.pop(digest, None)
            except OSError:
                continue
        # inflight entries whose .part is gone go with the job references;
        # the stat runs outside the leaf lock
        with self._lock:
            stale = [d for d in self._inflight if d not in live]
        for digest in stale:
            if not os.path.exists(self._block_path(digest) + ".part"):
                with self._lock:
                    self._inflight.pop(digest, None)

    # ------------------------------------------------------------ handlers

    def _on_begin(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.OffloadBeginRequest, body)
        now = time.monotonic()
        with self._lock:
            self._reap_locked(now)
            if len(self._jobs) >= self.max_concurrent * 4:
                self._c_rejects.increment()
                events.emit("offload.reject", severity="warn",
                            tenant=req.tenant, gpid=req.gpid,
                            reason="job_cap", jobs=len(self._jobs))
                return codec.encode(rpc_msg.OffloadBeginResponse(
                    error=1, error_text=f"busy: {len(self._jobs)} jobs "
                    f"active (cap {self.max_concurrent * 4})"))
            self._next_job += 1
            job_id = self._next_job
            job = {"id": job_id, "tenant": req.tenant, "gpid": req.gpid,
                   "runs": list(req.runs), "opts_json": req.opts_json,
                   "dir": os.path.join(self._jobs_dir, str(job_id)),
                   "outputs": [], "stats": {}, "spans": [],
                   "expires": now + self.job_ttl_s}
            self._jobs[job_id] = job
            self._c_jobs.set(len(self._jobs))
        self._gc_blocks()
        staged = []
        for e in req.runs:
            try:
                if os.path.getsize(self._block_path(e.digest)) == e.size:
                    staged.append(e.name)
                    self._c_resumed.increment()
            except OSError:
                continue
        self._trace(job, "offload.svc.begin", runs=len(req.runs),
                    resumed=len(staged))
        return codec.encode(rpc_msg.OffloadBeginResponse(
            job_id=job_id, staged=staged))

    def _on_ship(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.OffloadShipRequest, body)
        try:
            job = self._job(req.job_id)
            entry = next((e for e in job["runs"] if e.name == req.name), None)
            if entry is None:
                raise OffloadError(f"unknown run {req.name!r}")
            if zlib.crc32(req.data) != req.crc:
                raise OffloadError(f"chunk CRC mismatch for {req.name}"
                                   f"@{req.offset}")
            landed = self._land_chunk(entry, req.offset, req.data)
        except (OffloadError, OSError, ValueError) as e:
            return codec.encode(rpc_msg.OffloadShipResponse(
                error=1, error_text=repr(e)))
        self._c_in.increment(len(req.data))
        return codec.encode(rpc_msg.OffloadShipResponse(landed=landed))

    def _land_chunk(self, entry, offset: int, data: bytes) -> bool:
        """Write one chunk at its offset into the content-addressed
        staging file; when every byte has arrived, verify the whole-file
        digest and publish it atomically. Chunks may arrive out of order
        (a call_many wave fans across the RPC pool). -> True once the
        block is fully landed and verified."""
        final = self._block_path(entry.digest)
        part = final + ".part"
        with self._lock:
            if os.path.exists(final):
                return True  # a sibling shipper already landed it
            st = self._inflight.setdefault(entry.digest,
                                           {"got": set(), "size": entry.size,
                                            "finalizing": False})
            if st["got"] and not os.path.exists(part):
                # stale state from an abandoned ship whose .part was GC'd
                # (or finalize-failed): a fresh shipper starts with an
                # empty got-set, or its first chunk would read as complete
                st["got"] = set()
                st["finalizing"] = False
        open(part, "ab").close()  # ensure it exists before the r+b write
        with open(part, "r+b") as f:
            f.seek(offset)
            f.write(data)
        with self._lock:
            # the got-set records a chunk only after its bytes are in the
            # file, and exactly one handler finalizes (the last chunks of
            # a wave land on concurrent pool threads)
            st["got"].add((offset, len(data)))
            complete = (sum(ln for _, ln in st["got"]) >= entry.size
                        and not st["finalizing"])
            if complete:
                st["finalizing"] = True
        if not complete:
            return os.path.exists(final)
        try:
            with open(part, "rb") as f:
                whole = f.read()
        except OSError:
            return os.path.exists(final)  # a sibling already published
        if len(whole) != entry.size or _md5(whole) != entry.digest:
            # torn/overlapping ship: drop the staging state so a retry
            # starts the block clean
            with self._lock:
                self._inflight.pop(entry.digest, None)
            try:
                os.unlink(part)
            except OSError:
                pass
            raise OffloadError(f"staged run {entry.name} digest mismatch")
        os.replace(part, final)
        with self._lock:
            self._inflight.pop(entry.digest, None)
        return True

    def _on_merge(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.OffloadMergeRequest, body)
        try:
            job = self._job(req.job_id)
            with self._lock:
                if job["outputs"]:
                    # idempotent: a repeated merge call returns the done job
                    return codec.encode(rpc_msg.OffloadMergeResponse(
                        outputs=list(job["outputs"]),
                        stats_json=json.dumps(job["stats"]),
                        spans_json=json.dumps(job["spans"])))
                if self._running >= self.max_concurrent:
                    # admission gate: refuse, never queue
                    self._c_rejects.increment()
                    events.emit("offload.reject", severity="warn",
                                tenant=job["tenant"], gpid=job["gpid"],
                                reason="merge_cap", running=self._running)
                    return codec.encode(rpc_msg.OffloadMergeResponse(
                        error=1, error_text=f"busy: {self._running} merges "
                        f"in flight (cap {self.max_concurrent})"))
                self._running += 1
                self._c_running.set(self._running)
            try:
                outputs, stats = self._merge_job(job)
            finally:
                with self._lock:
                    self._running -= 1
                    self._c_running.set(self._running)
        except (OffloadError, OSError, ValueError) as e:
            return codec.encode(rpc_msg.OffloadMergeResponse(
                error=1, error_text=repr(e)))
        # anything else (a kernel build or launch failure, a device error)
        # propagates: the transport answers ERR_INVALID_DATA with its repr
        with self._lock:
            spans = list(job["spans"])
        return codec.encode(rpc_msg.OffloadMergeResponse(
            outputs=outputs, stats_json=json.dumps(stats),
            spans_json=json.dumps(spans)))

    def _merge_job(self, job: dict) -> tuple:
        """Load the job's staged runs (manifest order = merge priority),
        merge them on this service's backend, publish the packed output
        under the job dir. -> (outputs manifest, stats)."""
        from ..parallel.sharded_compact import compact_blocks_meshed

        t0 = time.perf_counter()
        blocks = []
        nbytes = 0
        for e in job["runs"]:
            try:
                with open(self._block_path(e.digest), "rb") as f:
                    data = f.read()
            except OSError:
                raise OffloadError(f"run {e.name} not staged (re-begin)")
            if _md5(data) != e.digest:
                raise OffloadError(f"staged run {e.name} corrupt on disk")
            nbytes += len(data)
            blocks.append(unpack_run_bytes(data))
        self._trace(job, "offload.svc.load", runs=len(blocks),
                    nbytes=nbytes,
                    duration_us=int((time.perf_counter() - t0) * 1e6))
        opts = opts_from_wire(job["opts_json"], self.backend, self.device)
        t_merge = time.perf_counter()
        result = compact_blocks_meshed(blocks, opts, self.mesh)
        self._trace(job, "offload.svc.merge",
                    records_in=sum(b.n for b in blocks),
                    records_out=result.block.n,
                    duration_us=int((time.perf_counter() - t_merge) * 1e6))
        t_pub = time.perf_counter()
        out_bytes = pack_run_bytes(result.block)
        os.makedirs(job["dir"], exist_ok=True)
        with open(os.path.join(job["dir"], "out.0"), "wb") as f:
            f.write(out_bytes)
        outputs = [rpc_msg.LearnBlockEntry("out.0", len(out_bytes),
                                           _md5(out_bytes))]
        self._trace(job, "offload.svc.publish", nbytes=len(out_bytes),
                    duration_us=int((time.perf_counter() - t_pub) * 1e6))
        stats = dict(result.stats)
        with self._lock:
            job["outputs"] = list(outputs)
            job["stats"] = stats
            self._merge_total += 1
        self._c_merges.increment()
        events.emit("offload.merge", tenant=job["tenant"], gpid=job["gpid"],
                    records_in=stats.get("input_records", 0),
                    records_out=stats.get("output_records", 0),
                    ms=round((time.perf_counter() - t0) * 1e3, 1))
        return outputs, stats

    def _on_fetch(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.OffloadFetchRequest, body)
        try:
            job = self._job(req.job_id)
            path = os.path.join(job["dir"], os.path.basename(req.name))
            with open(path, "rb") as f:
                f.seek(req.offset)
                data = f.read(req.length)
            total = os.path.getsize(path)
        except (OffloadError, OSError) as e:
            return codec.encode(rpc_msg.LearnFetchResponse(
                error=1, error_text=repr(e)))
        self._c_out.increment(len(data))
        return codec.encode(rpc_msg.LearnFetchResponse(
            data=data, crc=zlib.crc32(data), total=total))

    def _on_finish(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.OffloadFinishRequest, body)
        with self._lock:
            job = self._jobs.pop(req.job_id, None)
            self._c_jobs.set(len(self._jobs))
        if job is not None:
            shutil.rmtree(job["dir"], ignore_errors=True)
        return codec.encode(rpc_msg.OffloadShipResponse(landed=True))


# ================================================================= client

# one pool per tenant process: offload traffic reuses one connection per
# service
_POOL = ConnectionPool()


def _conn(addr: str):
    host, _, port = addr.rpartition(":")
    return _POOL.get((host, int(port)))


def _call(addr: str, code: str, req, resp_cls, timeout: float = None):
    try:
        _, body = _conn(addr).call(code, codec.encode(req),
                                   timeout=rpc_timeout_s() if timeout is None
                                   else timeout)
        resp = codec.decode(resp_cls, body)
    except (RpcError, OSError, ValueError, codec.CodecError) as e:
        raise OffloadError(f"{code} to {addr}: {e}") from e
    if resp.error:
        raise OffloadError(f"{code}: {resp.error_text}")
    return resp


def _call_wave(addr: str, calls: list, what: str) -> list:
    try:
        return _conn(addr).call_many(calls, timeout=rpc_timeout_s())
    except (RpcError, OSError, ValueError) as e:
        raise OffloadError(f"{what} {addr}: {e}") from e


def _ship_runs(addr: str, job_id: int, entries, payloads, staged) -> dict:
    """Ship every run the service does not already hold, as bounded CRC'd
    chunks pipelined through call_many waves (replication/learn.py
    chunk_waves). -> stats."""
    from .learn import chunk_waves

    shipped = skipped = nbytes = 0
    c_blocks = counters.rate("offload.client.ship_blocks")
    c_skip = counters.rate("offload.client.skipped_blocks")
    for entry, payload in zip(entries, payloads):
        if entry.name in staged:
            skipped += 1
            c_skip.increment()
            continue
        for wave in chunk_waves(entry.size, chunk_bytes()):
            calls = []
            for off, ln in wave:
                data = payload[off:off + ln]
                calls.append((RPC_COMPACT_OFFLOAD_SHIP, codec.encode(
                    rpc_msg.OffloadShipRequest(
                        job_id=job_id, name=entry.name, offset=off,
                        data=data, crc=zlib.crc32(data)))))
            for _, rbody in _call_wave(addr, calls, "ship to"):
                resp = codec.decode(rpc_msg.OffloadShipResponse, rbody)
                if resp.error:
                    raise OffloadError(f"ship failed: {resp.error_text}")
        shipped += 1
        nbytes += entry.size
        c_blocks.increment()
    counters.rate("offload.client.ship_bytes").increment(nbytes)
    return {"shipped_runs": shipped, "skipped_runs": skipped,
            "shipped_bytes": nbytes}


def _fetch_output(addr: str, job_id: int, entry) -> bytes:
    """Stream one merged output block back (per-chunk CRC + whole-block
    digest), pipelined through call_many waves on the same grid."""
    from .learn import chunk_waves

    parts = []
    for wave in chunk_waves(entry.size, chunk_bytes()):
        calls = [(RPC_COMPACT_OFFLOAD_FETCH, codec.encode(
            rpc_msg.OffloadFetchRequest(
                job_id=job_id, name=entry.name, offset=off, length=ln)))
            for off, ln in wave]
        for _, rbody in _call_wave(addr, calls, "fetch from"):
            resp = codec.decode(rpc_msg.LearnFetchResponse, rbody)
            if resp.error:
                raise OffloadError(f"fetch failed: {resp.error_text}")
            if zlib.crc32(resp.data) != resp.crc:
                raise OffloadError(f"fetch chunk CRC mismatch ({entry.name})")
            parts.append(resp.data)
    data = b"".join(parts)
    if len(data) != entry.size or _md5(data) != entry.digest:
        raise OffloadError(f"fetched output {entry.name} digest mismatch")
    counters.rate("offload.client.fetch_bytes").increment(len(data))
    return data


def offload_compact_blocks(blocks, opts: CompactOptions, addr: str,
                           tenant: str = "") -> CompactResult:
    """Node-side merge entry: compact `blocks` (newest first) on the
    offload service at `addr` ("host:port"), byte-identical to
    ``compact_blocks(blocks, opts)`` with ``backend="cpu"``. One round:
    begin, ship what the service has not staged, merge, fetch, finish;
    then the tenant-side post passes (user rules, default-TTL rewrite).
    Raises OffloadError on any failure; nothing merges locally instead.

    The stats are the service's merge stats plus offloaded, service,
    shipped_runs, skipped_runs, shipped_bytes, fetched_bytes and
    service_spans (the service's begin/load/merge/publish records)."""
    from ..engine.block import KVBlock

    # resolve the clock once: the service's drops and the local post
    # filters must agree on `now` or TTL edges diverge
    opts = replace(opts, now=opts.resolved_now())
    runs = [b for b in blocks if b.n]
    payloads = [pack_run_bytes(b) for b in runs]
    entries = [rpc_msg.LearnBlockEntry(f"run.{i}", len(p), _md5(p))
               for i, p in enumerate(payloads)]
    # the job-trace id crosses the wire: the service records its own hops
    # and returns them on merge, and they are stitched into this job
    trace_job = JOB_TRACER.current() or ""
    with _TRACE.span("offload.ship", records=sum(b.n for b in runs),
                     nbytes=sum(len(p) for p in payloads)), \
            JOB_TRACER.hop("offload.ship", service=addr,
                           nbytes=sum(len(p) for p in payloads)) as jh:
        begin = _call(addr, RPC_COMPACT_OFFLOAD_BEGIN,
                      rpc_msg.OffloadBeginRequest(
                          tenant=tenant, gpid=f"{opts.pidx}",
                          runs=entries, opts_json=wire_opts(opts),
                          job=trace_job),
                      rpc_msg.OffloadBeginResponse)
        ship = _ship_runs(addr, begin.job_id, entries, payloads,
                          set(begin.staged))
        jh.update(ship)
    del payloads
    try:
        with _TRACE.span("offload.merge", records=sum(b.n for b in runs)), \
                JOB_TRACER.hop("offload.merge", service=addr):
            m = _call(addr, RPC_COMPACT_OFFLOAD_MERGE,
                      rpc_msg.OffloadMergeRequest(job_id=begin.job_id),
                      rpc_msg.OffloadMergeResponse,
                      timeout=merge_timeout_s())
        if trace_job and m.spans_json:
            # one timeline, two hosts: the service's view comes home in
            # the response and lands origin-tagged beside our own hops
            try:
                JOB_TRACER.stitch(trace_job, json.loads(m.spans_json),
                                  origin=addr)
            except ValueError:
                pass  # a torn spans payload: the stats parse below raises
        with _TRACE.span("offload.fetch",
                         nbytes=sum(e.size for e in m.outputs)) as sp, \
                JOB_TRACER.hop("offload.fetch", service=addr,
                               nbytes=sum(e.size for e in m.outputs)):
            out_parts = [_fetch_output(addr, begin.job_id, e)
                         for e in m.outputs]
            out = unpack_run_bytes(out_parts[0]) if out_parts \
                else KVBlock.empty()
            sp["records"] = out.n
    finally:
        try:
            _call(addr, RPC_COMPACT_OFFLOAD_FINISH,
                  rpc_msg.OffloadFinishRequest(job_id=begin.job_id),
                  rpc_msg.OffloadShipResponse)
        except OffloadError:
            pass  # the job TTL covers an unreachable service
    out = apply_post_filters(out, opts, opts.now)
    try:
        stats = json.loads(m.stats_json or "{}")
        spans = json.loads(m.spans_json or "[]")
    except ValueError as e:
        raise OffloadError(f"malformed merge stats from {addr}: {e}") from e
    stats.update(ship)
    stats.update({"offloaded": True, "service": addr,
                  "output_records": out.n,
                  "fetched_bytes": sum(e.size for e in m.outputs),
                  "service_spans": spans})
    counters.rate("offload.client.merge_count").increment()
    return CompactResult(out, stats)
