"""The storage-engine server: read handlers, write dispatch, app-envs.

Port of pegasus_tpu/engine/server_impl.py: the pegasus_server_impl +
pegasus_server_write pair
(src/server/pegasus_server_impl.{h,cpp}, pegasus_server_write.cpp) over our
LSM engine: every rrdb read RPC handled here (get :265, multi_get :343,
sortkey_count :764, ttl :843, get_scanner :904, scan :1151), committed
mutations dispatched per decree (on_batched_write_requests,
pegasus_server_write.cpp:39-110: consecutive put/remove batched into one
engine write; multi_put/incr/CAS/... routed to single handlers), dynamic
behavior driven by app-envs (update_app_envs :2406).

The engine is the port's LsmEngine: on the cuda backend (the default)
concurrent point and range reads coalesce into batched device lookups of
the resident runs (ops/device_lookup.py), and bulk-load ingest and manual
compaction merge through the merge-path kernel. A device failure raises
to the caller. Responses are byte-identical to pegasus_tpu's for the
same requests, decree, timestamp_us and `now`.
"""

import struct
import threading
import time

from ..base import consts, key_schema
from ..base.utils import c_escape_string, epoch_now
from ..base.value_schema import SCHEMAS
from ..runtime import lockrank
from ..runtime.perf_counters import counters
from ..runtime.table_stats import TABLE_STATS
from ..runtime.tracing import REQUEST_TRACER
from ..rpc import messages as msg
from ..rpc.messages import FilterType, Status, match_filter
from .capacity_unit_calculator import CapacityUnitCalculator
from .compaction_rules import parse_user_specified_compaction
from .db import EngineOptions, LsmEngine
from .hotkey_collector import HotkeyCollector
from .manual_compact_service import ManualCompactService
from .range_read_limiter import RangeReadLimiter
from .scan_context import ScanContext, ScanContextCache
from .throttling import DebtThrottle, ThrottlingController
from .write_service import WriteService

# write op codes live in rpc.task_codes; re-exported for the serverlet
from ..rpc.task_codes import (BATCHABLE, RPC_BULK_LOAD_INGEST,  # noqa: F401
                              RPC_CHECK_AND_MUTATE, RPC_CHECK_AND_SET,
                              RPC_DUPLICATE, RPC_INCR, RPC_MULTI_PUT,
                              RPC_MULTI_REMOVE, RPC_PUT, RPC_REMOVE,
                              RPC_TRIGGER_AUDIT)

# short op names for the per-partition qps + latency counter pairs
# (app.<id>.<pidx>.<op>_qps / <op>_latency_us — write-path latency parity
# with the read handlers' get/multi_get percentiles)
_OP_NAMES = {RPC_PUT: "put", RPC_REMOVE: "remove",
             RPC_MULTI_PUT: "multi_put", RPC_MULTI_REMOVE: "multi_remove",
             RPC_INCR: "incr", RPC_CHECK_AND_SET: "check_and_set",
             RPC_CHECK_AND_MUTATE: "check_and_mutate",
             RPC_DUPLICATE: "duplicate", RPC_BULK_LOAD_INGEST: "bulk_load",
             RPC_TRIGGER_AUDIT: "trigger_audit"}


def _hk_hash32(hash_key: bytes):
    """32-bit hashkey hash for SST bloom probes — the same truncation the
    engine stores per record (db.get) and _bloom_build indexes. Returns
    None (= no pruning) for the EMPTY hashkey: key_hash falls back to
    hashing the sort key then (key_schema.py:60-72), so records under
    b'' carry per-sortkey hashes and no single probe covers them."""
    if not hash_key:
        return None
    return key_schema.key_hash(
        key_schema.generate_key(hash_key, b"")) & 0xFFFFFFFF


class _ReadSlot:
    __slots__ = ("key", "now", "event", "value", "err", "done")

    def __init__(self, key, now):
        self.key, self.now = key, now
        self.event = threading.Event()
        self.value = self.err = None
        self.done = False


class _RangeSlot:
    __slots__ = ("rng", "now", "h32", "event", "value", "err", "done")

    def __init__(self, rng, now, h32):
        self.rng, self.now, self.h32 = rng, now, h32
        self.event = threading.Event()
        self.value = self.err = None
        self.done = False


class _ReadCoalescer:
    """Groups CONCURRENT point reads into one engine.get_batch call — the
    read-path twin of the plog's leader/follower group commit: the first
    arriving thread claims the drain and serves queued slots (itself
    included) in device-batch-sized groups; threads that arrive mid-drain
    park on their slot. A solo get is a batch of one (no linger —
    lone-reader latency is unchanged, and db.get_batch routes a batch of
    one to the host walk anyway via the device_read_min_batch floor);
    under concurrency the queue forms the device batches by itself. A
    leader serves at most MAX_LEADER_ROUNDS batches past its own result
    (one client must never pay unbounded latency serving everyone else
    under saturation), then relinquishes; parked slots re-check on a
    bounded wait and self-promote, which also recovers leadership if a
    leader thread died non-locally. Only active when the engine's device
    reads are on — otherwise every get goes straight to engine.get."""

    MAX_LEADER_ROUNDS = 4
    MAX_BATCH = 64   # slots per engine batch (the reference's default)

    def __init__(self, engine):
        self.engine = engine
        self._lock = lockrank.named_lock("read.coalescer")
        self._queue = []        #: guarded_by self._lock
        self._draining = False  #: guarded_by self._lock
        # hot-path counter resolved once (the registry lock is per
        # lookup, and this fires on every point read)
        self._c_batch_size = counters.percentile("read.batch.size")

    def get(self, key: bytes, now: int):
        if not self.engine._device_reads_on():
            return self.engine.get(key, now=now)
        slot = _ReadSlot(key, now)
        self._join_many([slot])
        if slot.err is not None:
            raise slot.err
        return slot.value

    def get_many(self, keys, now: int):
        """Point reads of one caller thread (a dispatch batch): the whole
        wave joins the coalescer as a slot group, merging with concurrent
        readers' slots into shared device batches, and parks one thread
        instead of one per key. Raises the first slot error."""
        if not keys:
            return []
        if not self.engine._device_reads_on():
            return self.engine.get_batch(keys, now=[now] * len(keys))
        slots = [_ReadSlot(k, now) for k in keys]
        self._join_many(slots)
        out = []
        for s in slots:
            if s.err is not None:
                raise s.err
            out.append(s.value)
        return out

    def _join_many(self, slots) -> None:
        """Queue every slot and drive the leader/follower drain until ALL
        are served: the group-commit loop shared with the range twin
        (_RangeCoalescer), which differs only in what _serve dispatches.
        Claim the drain when free, serve at most MAX_LEADER_ROUNDS batches
        past the round where every OWN slot is done, hand off on exit."""
        with self._lock:
            self._queue.extend(slots)
        while not all(s.done for s in slots):
            pending = next(s for s in slots if not s.done)
            with self._lock:
                lead = not self._draining and bool(self._queue)
                if lead:
                    self._draining = True
            if not lead:
                # parked; the bounded wait re-checks so a relinquished
                # (or dead) leader's leftover queue gets a new leader.
                # A poke without a result (leader handoff) clears the
                # event so the next park actually waits — slot.done, not
                # the event, is the loop's truth
                pending.event.wait(0.05)
                if not pending.done:
                    pending.event.clear()
                continue
            try:
                rounds = 0
                while True:
                    with self._lock:
                        batch = self._queue[: self.MAX_BATCH]
                        del self._queue[: self.MAX_BATCH]
                    if not batch:
                        break
                    self._serve(batch)
                    rounds += 1
                    if (rounds >= self.MAX_LEADER_ROUNDS
                            and all(s.done for s in slots)):
                        break
            finally:
                with self._lock:
                    self._draining = False
                    if self._queue:
                        # hand the drain off promptly: wake one parked
                        # slot so relinquished work doesn't wait out a
                        # 50ms poll tick
                        self._queue[0].event.set()

    def _serve(self, batch) -> None:
        self._c_batch_size.set(len(batch))
        try:
            vals = self.engine.get_batch([s.key for s in batch],
                                         now=[s.now for s in batch])
        except Exception as e:  # noqa: BLE001 - every waiter needs the outcome
            for s in batch:
                s.err, s.done = e, True
                s.event.set()
            return
        for s, v in zip(batch, vals):
            s.value, s.done = v, True
            s.event.set()


class _RangeCoalescer(_ReadCoalescer):
    """The _ReadCoalescer's range twin: concurrent bounded scans on the
    same partition (multi_get hash ranges, sortkey_count, filter-free
    scanner batches) group into ONE engine.scan_range_batch call — one
    device interval resolve per SST per GROUP instead of per request.
    Reverse ranges skip the queue entirely: the engine serves them
    host-side (and counts them in read.range.reverse_host_count) anyway,
    so there is nothing to share."""

    def __init__(self, engine):
        super().__init__(engine)
        self._lock = lockrank.named_lock("read.range_coalescer")
        self._c_batch_size = counters.percentile("read.range.batch.size")

    def scan_range(self, start: bytes, stop, now: int, hash32=None,
                   reverse: bool = False):
        """-> the merged-scan iterator scan(start, stop) would return
        (stop None = open end), device-resolved and group-coalesced when
        the engine's device reads are on."""
        if reverse or not self.engine._device_reads_on():
            return self.engine.scan_range_batch(
                [(start, stop)], now=now, reverse=reverse,
                hash32s=[hash32])[0]
        slot = _RangeSlot((start, stop), now, hash32)
        self._join_many([slot])
        if slot.err is not None:
            raise slot.err
        return slot.value

    def _serve(self, batch) -> None:
        self._c_batch_size.set(len(batch))
        try:
            its = self.engine.scan_range_batch(
                [s.rng for s in batch], now=[s.now for s in batch],
                hash32s=[s.h32 for s in batch])
        except Exception as e:  # noqa: BLE001 - every waiter needs the outcome
            for s in batch:
                s.err, s.done = e, True
                s.event.set()
            return
        for s, it in zip(batch, its):
            s.value, s.done = it, True
            s.event.set()


class PegasusServer:
    """One partition's storage server (a replication_app_base storage engine,
    registered by name like the reference's string-keyed factory,
    src/server/pegasus_server_impl.h:59-64)."""

    ENGINE_NAME = "pegasus-tpu"

    def __init__(self, path: str, app_id: int = 1, pidx: int = 0,
                 options: EngineOptions = None, server: str = "local",
                 app_envs: dict = None, cluster_id: int = 0):
        """options: the engine's EngineOptions; the default is the cuda
        backend on the card (EngineOptions(device="cpu") runs the cuda
        backend's plain versions on the CPU)."""
        self.app_id = app_id
        self.pidx = pidx
        self.server = server
        opts = options or EngineOptions()
        opts.pidx = pidx
        self.engine = LsmEngine(path, opts)
        # cluster_id flows into every local write's value timetag: the
        # same provenance bits the duplicate apply path stores for its
        # ORIGIN cluster, so a local row and its duplicated copy hold
        # byte-identical values
        self.write_service = WriteService(self.engine, app_id, pidx, server,
                                          cluster_id=cluster_id)
        self._schema = SCHEMAS[self.engine.data_version()]
        self._contexts = ScanContextCache()
        self._app_envs = {}
        self._default_ttl = 0
        self._slow_query_threshold_ms = 20  # reference default 20ms
        self._abnormal_get_size = 0                  # bytes; 0 = disabled
        self._abnormal_multi_get_size = 0            # bytes; 0 = disabled
        self._abnormal_multi_get_iterate_count = 0   # rows;  0 = disabled
        self._pfx = f"app.{app_id}.{pidx}."
        # hot read-path counters resolved ONCE: counters.rate(name) takes
        # the registry lock per call
        self._c_get_qps = counters.rate(self._pfx + "get_qps")
        self._c_multi_get_qps = counters.rate(self._pfx + "multi_get_qps")
        self._c_scan_qps = counters.rate(self._pfx + "scan_qps")
        self._c_get_latency = counters.percentile(
            self._pfx + "get_latency_us")
        # device-served reads: concurrent on_get point reads coalesce into
        # engine.get_batch device batches, concurrent bounded scans into
        # engine.scan_range_batch ones (no-op passthroughs when the
        # engine's device reads are off)
        self._read_coalescer = _ReadCoalescer(self.engine)
        self._range_coalescer = _RangeCoalescer(self.engine)
        self.manual_compact_service = ManualCompactService(self)
        self.read_hotkey = HotkeyCollector("read")
        self.write_hotkey = HotkeyCollector("write")
        self.write_qps_throttler = ThrottlingController()
        self.write_size_throttler = ThrottlingController()
        self.read_qps_throttler = ThrottlingController()
        # compaction-debt admission control: graduated backpressure keyed
        # on the engine's L0 debt, charged alongside the env throttles on
        # every write
        self.debt_throttler = DebtThrottle(self.engine)
        self.cu_calculator = CapacityUnitCalculator(
            app_id, pidx, read_hotkey=self.read_hotkey,
            write_hotkey=self.write_hotkey)
        self.write_service.cu_calculator = self.cu_calculator
        # tenant accounting: wired by set_table_name once the host learns
        # which table this partition serves; None until then (engines
        # without a table name stay unattributed)
        self.table_name = ""
        self.table_ledger = None
        if app_envs:
            self.update_app_envs(app_envs)

    # -------------------------------------------------------------- app envs

    def set_table_name(self, name: str) -> None:
        """Wire this partition to its tenant ledger: resolve the per-table
        ledger once, register the gpid -> table mapping (job and
        transport attribution), and hand the ledger to the debt throttle
        and the engine, so delay-ms and device-read probes are charged
        where they happen."""
        if not name or name == self.table_name:
            return
        self.table_name = name
        led = TABLE_STATS.register_gpid(self.app_id, self.pidx, name)
        self.table_ledger = led
        self.debt_throttler.ledger = led
        self.engine.table_ledger = led

    def update_app_envs(self, envs: dict) -> None:
        """Hot-apply per-table dynamic config (src/server/pegasus_server_impl.cpp:2406)."""
        self._app_envs.update(envs)
        ttl = envs.get(consts.TABLE_LEVEL_DEFAULT_TTL)
        if ttl is not None:
            self._default_ttl = max(0, int(ttl))
            self.engine.opts.default_ttl = self._default_ttl
        sq = envs.get(consts.ENV_SLOW_QUERY_THRESHOLD)
        if sq is not None:
            # validate ONCE here (the reference validates at env update);
            # a malformed value must never fail the read path
            try:
                self._slow_query_threshold_ms = max(0, int(sq))
            except (TypeError, ValueError):
                print(f"[app-envs] bad {consts.ENV_SLOW_QUERY_THRESHOLD}="
                      f"{sq!r} ignored", flush=True)
        # per-table write throttling (reference replica.write_throttling
        # env -> rDSN throttling_controller; by-qps and by-request-size)
        for env_key, ctl in ((consts.ENV_WRITE_THROTTLING,
                              self.write_qps_throttler),
                             (consts.ENV_WRITE_THROTTLING_BY_SIZE,
                              self.write_size_throttler),
                             (consts.ENV_READ_THROTTLING,
                              self.read_qps_throttler)):
            v = envs.get(env_key)
            if v is not None and v != ctl.env_value:
                if not ctl.parse_from_env(v):
                    print(f"[app-envs] bad {env_key}={v!r} ignored",
                          flush=True)
        # abnormal request/response SIZE tracing (reference
        # pegasus_server_impl.h:317-343 _abnormal_*_threshold gflags;
        # 0 = disabled): oversized reads are logged + counted even when fast
        for env_key, attr in (
                (consts.ENV_ABNORMAL_GET_SIZE, "_abnormal_get_size"),
                (consts.ENV_ABNORMAL_MULTI_GET_SIZE,
                 "_abnormal_multi_get_size"),
                (consts.ENV_ABNORMAL_MULTI_GET_ITERATE_COUNT,
                 "_abnormal_multi_get_iterate_count")):
            v = envs.get(env_key)
            if v is not None:
                try:
                    setattr(self, attr, max(0, int(v)))
                except (TypeError, ValueError):
                    print(f"[app-envs] bad {env_key}={v!r} ignored", flush=True)
        backend = envs.get(consts.COMPACTION_BACKEND_KEY)
        if backend in ("cpu", "cuda", "tpu"):
            # "tpu" (a pegasus_tpu meta's word for the device backend)
            # selects the card here
            self.engine.opts.backend = "cpu" if backend == "cpu" else "cuda"
        if consts.USER_SPECIFIED_COMPACTION in envs:
            self.engine.opts.user_ops = tuple(parse_user_specified_compaction(
                envs[consts.USER_SPECIFIED_COMPACTION]))
        for env_key, opt in ((consts.CHECKPOINT_RESERVE_MIN_COUNT,
                              "checkpoint_reserve_min_count"),
                             (consts.CHECKPOINT_RESERVE_TIME_SECONDS,
                              "checkpoint_reserve_time_seconds")):
            v = envs.get(env_key)
            if v is not None:
                try:
                    setattr(self.engine.opts, opt, max(0, int(v)))
                except (TypeError, ValueError):
                    print(f"[app-envs] bad {env_key}={v!r} ignored", flush=True)
        comp = envs.get(consts.ROCKSDB_COMPRESSION_TYPE)
        if comp in ("none", "zlib"):
            self.engine.opts.compression = comp
        pv = envs.get(consts.REPLICA_PARTITION_VERSION)
        if pv is not None:
            # post-split ownership mask: compaction drops keys whose hash no
            # longer routes here (reference set_partition_version)
            self.engine.opts.partition_mask = max(0, int(pv))
        scenario = envs.get(consts.ENV_USAGE_SCENARIO_KEY)
        if scenario:
            self.set_usage_scenario(scenario)
        if any(k.startswith(consts.MANUAL_COMPACT_KEY_PREFIX) for k in envs):
            self.manual_compact_service.start_manual_compact_if_needed(
                self._app_envs)

    def set_usage_scenario(self, scenario: str) -> bool:
        """normal / prefer_write / bulk_load tuning profiles
        (src/server/pegasus_server_impl.cpp:2668-2738) mapped onto the full
        engine knob set the reference's SetOptions profiles reach:
        L0 trigger, memtable budget, output file sizing, and level budgets
        (bulk_load mirrors PrepareForBulkLoad: no auto compaction, huge
        write buffers, everything deferred to the post-load manual compact)."""
        o = self.engine.opts
        if scenario == consts.USAGE_SCENARIO_NORMAL:
            o.l0_compaction_trigger = 4
            o.memtable_bytes = 64 << 20
            o.target_file_size_bytes = 64 << 20
            o.level_base_bytes = 256 << 20
        elif scenario == consts.USAGE_SCENARIO_PREFER_WRITE:
            o.l0_compaction_trigger = 10
            o.memtable_bytes = 128 << 20
            o.target_file_size_bytes = 128 << 20
            o.level_base_bytes = 512 << 20
        elif scenario == consts.USAGE_SCENARIO_BULK_LOAD:
            o.l0_compaction_trigger = 1 << 30  # no auto compaction
            o.memtable_bytes = 256 << 20
            o.target_file_size_bytes = 256 << 20
            o.level_base_bytes = 1 << 62       # no cascades during the load
        else:
            return False
        self._app_envs[consts.ENV_USAGE_SCENARIO_KEY] = scenario
        return True

    @property
    def app_envs(self) -> dict:
        return dict(self._app_envs)

    def _make_limiter(self, count_only: bool = False) -> RangeReadLimiter:
        """Per-RPC iteration budget (src/server/range_read_limiter.h:29-100);
        thresholds come from app-envs with the reference's defaults."""
        envs = self._app_envs
        return RangeReadLimiter(
            max_iteration_count=int(envs.get(
                consts.ROCKSDB_ITERATION_THRESHOLD_COUNT, 1000)),
            max_iteration_size=0 if count_only else int(envs.get(
                consts.ROCKSDB_ITERATION_THRESHOLD_SIZE, 4 << 20)),
            max_duration_ms=int(envs.get(
                consts.ROCKSDB_ITERATION_THRESHOLD_TIME_MS, 5000)),
        )

    # ------------------------------------------------------------ write path

    def on_batched_write_window(self, window, now: int = None):
        """Apply a contiguous committed decree WINDOW — `window` is
        [(decree, timestamp_us, requests)] in decree order (the decree-
        pipelined replication path). Maximal stretches of batchable
        (put/remove) decrees collapse into ONE write_service call and ONE
        engine lock acquisition; everything else dispatches per decree
        exactly as on_batched_write_requests. -> {decree: response list}.
        Engine state advances stretch by stretch, so a mid-window failure
        leaves last_committed_decree at the last applied decree."""
        out = {}
        if not window:
            return out
        with REQUEST_TRACER.span("engine.apply", decree=window[-1][0],
                                 batch=sum(len(e[2]) for e in window)):
            i = 0
            while i < len(window):
                _, _, reqs = window[i]
                if reqs and all(c in BATCHABLE for c, _ in reqs):
                    j = i + 1
                    while j < len(window) and window[j][2] and \
                            all(c in BATCHABLE for c, _ in window[j][2]):
                        j += 1
                    out.update(self._apply_batchable_stretch(window[i:j]))
                    i = j
                else:
                    d, ts, reqs = window[i]
                    out[d] = self.on_batched_write_requests(d, ts, reqs,
                                                            now=now)
                    i += 1
            return out

    def _apply_batchable_stretch(self, entries):
        """One engine call for a stretch of batchable decrees; per-op
        qps/latency counters mirror the single-decree batch path (the
        stretch hits the engine as ONE write, so its elapsed time is every
        member's apply cost)."""
        t0 = time.perf_counter()
        resps = self.write_service.apply_batched_window(entries)
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        ops = set()
        for _, _, reqs in entries:
            for code, _ in reqs:
                ops.add(_OP_NAMES[code])
                counters.rate(self._pfx + f"{_OP_NAMES[code]}_qps").increment()
        for op in ops:
            counters.percentile(self._pfx + f"{op}_latency_us").set(elapsed_us)
        if self.table_ledger is not None:
            self.table_ledger.charge_write(
                elapsed_us, n_ops=sum(len(e[2]) for e in entries))
        return resps

    def on_batched_write_requests(self, decree: int, timestamp_us: int, requests,
                                  now: int = None):
        """The replication->engine boundary
        (src/server/pegasus_server_write.cpp:39): `requests` is a list of
        (code, request) already committed at `decree`. Returns responses in
        order. Consecutive PUT/REMOVE coalesce into one engine write.
        `now` injects the read-modify-write clock for tests (the reference's
        PEGASUS_UNIT_TEST mock-time hook)."""
        if not requests:
            self.write_service.empty_put(decree)
            return []
        if len(requests) == 1 and requests[0][0] not in BATCHABLE:
            code, req = requests[0]
            return [self._dispatch_single(decree, timestamp_us, code, req, now)]
        # batch path: only batchable codes may be grouped (the reference
        # asserts non-batchable codes never arrive in a multi-request batch)
        t0 = time.perf_counter()
        responses = []
        ws = self.write_service
        with REQUEST_TRACER.span("engine.apply", decree=decree,
                                 batch=len(requests)):
            ws.batch_prepare()
            for code, req in requests:
                if code == RPC_PUT:
                    ws.batch_put(req, timestamp_us)
                    responses.append(ws._fill(msg.UpdateResponse(), decree))
                    counters.rate(self._pfx + "put_qps").increment()
                elif code == RPC_REMOVE:
                    ws.batch_remove(req.key)
                    responses.append(ws._fill(msg.UpdateResponse(), decree))
                    counters.rate(self._pfx + "remove_qps").increment()
                else:
                    ws.batch_abort()
                    raise ValueError(
                        f"non-batchable code {code} in batched request")
            ws.batch_commit(decree)
        # group-committed put/remove share the batch's engine latency:
        # they hit the engine as ONE write, so that is their apply cost
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        for op in {_OP_NAMES[code] for code, _ in requests}:
            counters.percentile(self._pfx + f"{op}_latency_us").set(elapsed_us)
        if self.table_ledger is not None:
            self.table_ledger.charge_write(elapsed_us, n_ops=len(requests))
        return responses

    def _dispatch_single(self, decree, timestamp_us, code, req, now=None):
        op = _OP_NAMES.get(code)
        if op is None:
            raise ValueError(f"unknown write code {code}")
        counters.rate(self._pfx + f"{op}_qps").increment()
        ws = self.write_service
        t0 = time.perf_counter()
        with REQUEST_TRACER.span("engine.apply", decree=decree, op=op):
            if code == RPC_PUT:
                resp = ws.put(decree, req, timestamp_us)
            elif code == RPC_REMOVE:
                resp = ws.remove(decree, req.key)
            elif code == RPC_MULTI_PUT:
                resp = ws.multi_put(decree, req, timestamp_us)
            elif code == RPC_MULTI_REMOVE:
                resp = ws.multi_remove(decree, req)
            elif code == RPC_INCR:
                resp = ws.incr(decree, req, now=now)
            elif code == RPC_CHECK_AND_SET:
                resp = ws.check_and_set(decree, req, now=now)
            elif code == RPC_CHECK_AND_MUTATE:
                resp = ws.check_and_mutate(decree, req, now=now)
            elif code == RPC_DUPLICATE:
                resp = ws.duplicate(decree, req, now=now)
            elif code == RPC_TRIGGER_AUDIT:
                resp = ws.trigger_audit(decree, req)
            else:
                resp = ws.ingestion_files(decree, req)
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        counters.percentile(self._pfx + f"{op}_latency_us").set(elapsed_us)
        if self.table_ledger is not None:
            self.table_ledger.charge_write(elapsed_us)
        return resp

    # ------------------------------------------------------------- read path

    def on_get(self, key: bytes, now: int = None) -> msg.ReadResponse:
        """src/server/pegasus_server_impl.cpp:265."""
        t0 = time.perf_counter()
        now = epoch_now() if now is None else now
        resp, hk, size = self._get_response(
            key, self._read_coalescer.get(key, now))
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        self._c_get_latency.set(elapsed_us)
        if self.table_ledger is not None:
            self.table_ledger.charge_read(elapsed_us, size)
        self._check_slow_query("get", hk, elapsed_us)
        return resp

    def on_get_batch(self, keys, now: int = None) -> list:
        """on_get over a dispatch batch: ONE coalescer slot-group join
        serves the whole wave, then each key's bookkeeping runs as on_get
        runs it (the same counters, CU charges and abnormal-size /
        slow-query tracing, byte-identical ReadResponses). Latency
        samples share the batch's elapsed time."""
        t0 = time.perf_counter()
        now = epoch_now() if now is None else now
        raws = self._read_coalescer.get_many(keys, now)
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        out = []
        for key, raw in zip(keys, raws):
            resp, hk, size = self._get_response(key, raw)
            self._c_get_latency.set(elapsed_us)
            if self.table_ledger is not None:
                self.table_ledger.charge_read(elapsed_us, size)
            self._check_slow_query("get", hk, elapsed_us)
            out.append(resp)
        return out

    def _get_response(self, key: bytes, raw):
        """One get's ReadResponse from its stored value (None = missing),
        with its CU charge, size tracing and qps tick. -> (resp,
        hash_key, size)."""
        resp = msg.ReadResponse(app_id=self.app_id, partition_index=self.pidx,
                                server=self.server)
        if raw is None:
            resp.error = Status.NOT_FOUND
        else:
            resp.value = self._schema.extract_user_data(raw)
        try:
            hk, _ = key_schema.restore_key(key)
        except ValueError:
            hk = key  # malformed client key: still account, never raise
        self.cu_calculator.add_get_cu(hk, key, resp.value)
        size = len(key) + len(resp.value)
        self._check_abnormal_size("get", hk, size, self._abnormal_get_size)
        self._c_get_qps.increment()
        return resp, hk, size

    def _check_abnormal_size(self, op: str, hash_key: bytes, size: int,
                             size_thr: int, rows: int = 0,
                             rows_thr: int = 0) -> None:
        """Oversized-read tracing (reference _abnormal_*_threshold,
        pegasus_server_impl.h:317-343): a read can be fast AND abusive;
        size/row thresholds flag it independently of latency."""
        if (size_thr and size >= size_thr) or (rows_thr and rows >= rows_thr):
            counters.rate(self._pfx + "recent_abnormal_count").increment()
            print(f"[abnormal-size] {op} hash_key="
                  f"\"{c_escape_string(hash_key[:64])}\" size={size}B "
                  f"rows={rows} (thresholds {size_thr}B/{rows_thr})",
                  flush=True)

    def _check_slow_query(self, op: str, hash_key: bytes, elapsed_us: int):
        """Slow/abnormal query tracing (reference _slow_query_threshold_ns,
        pegasus_server_impl.cpp:318-332): log offenders, bump the counter."""
        threshold_ms = self._slow_query_threshold_ms
        if threshold_ms > 0 and elapsed_us >= threshold_ms * 1000:
            counters.rate(self._pfx + "recent_abnormal_count").increment()
            print(f"[slow-query] app={self.app_id}.{self.pidx} op={op} "
                  f"hash_key=\"{c_escape_string(hash_key)}\" "
                  f"time_used={elapsed_us}us", flush=True)

    def on_multi_get(self, req: msg.MultiGetRequest, now: int = None) -> msg.MultiGetResponse:
        """src/server/pegasus_server_impl.cpp:343: specified sort_keys, or a
        bounded+filtered range under the hash_key. reverse=True keeps the
        LAST max_kv_count/size items of the range and returns them in
        descending sort_key order (the reference iterates with Prev())."""
        now = epoch_now() if now is None else now
        t0 = time.perf_counter()
        resp = msg.MultiGetResponse(app_id=self.app_id, partition_index=self.pidx,
                                    server=self.server)
        self._c_multi_get_qps.increment()
        if req.sort_keys:
            size = 0
            # a specified-sort_keys multi_get IS a point-read batch: one
            # engine.get_batch over one snapshot (device-served when the
            # SSTs are resident, host-walked otherwise)
            raws = self.engine.get_batch(
                [key_schema.generate_key(req.hash_key, sk)
                 for sk in req.sort_keys], now=now)
            for sk, raw in zip(req.sort_keys, raws):
                if raw is not None:
                    data = b"" if req.no_value else self._schema.extract_user_data(raw)
                    resp.kvs.append(msg.KeyValue(sk, data))
                    size += len(sk) + len(data)
            self.cu_calculator.add_multi_get_cu(req.hash_key, resp.kvs)
            self._check_abnormal_size(
                "multi_get", req.hash_key, size, self._abnormal_multi_get_size,
                rows=len(req.sort_keys),
                rows_thr=self._abnormal_multi_get_iterate_count)
            elapsed_us = int((time.perf_counter() - t0) * 1e6)
            if self.table_ledger is not None:
                self.table_ledger.charge_read(elapsed_us, size)
            self._check_slow_query("multi_get", req.hash_key, elapsed_us)
            return resp

        start = key_schema.generate_key(req.hash_key, req.start_sortkey)
        if req.stop_sortkey:
            stop = key_schema.generate_key(req.hash_key, req.stop_sortkey)
        else:
            stop = key_schema.generate_next_bytes(req.hash_key)

        out, complete = [], True
        size = 0
        iterated = 0
        h32 = _hk_hash32(req.hash_key)
        # both directions resolve the same bounded range [start, scan_hi)
        # through the range coalescer — device-served interval resolve for
        # forward scans, host-walked (and counted as such) for reverse
        scan_hi = stop + b"\x00" if req.stop_inclusive else stop
        it = self._range_coalescer.scan_range(start, scan_hi, now,
                                              hash32=h32,
                                              reverse=req.reverse)
        # reverse iterates the engine descending (the reference's Prev()
        # from the stop key), so bounded reads return the range's TAIL and
        # the limiter budget is spent at the correct end. The limiter
        # starts AFTER scan_range: the device interval resolve must not
        # eat the per-RPC iteration-time budget (the host walk pays no
        # such setup, and byte identity includes the complete/INCOMPLETE
        # verdict)
        limiter = self._make_limiter()
        for k, raw, _ in it:
            if req.reverse:
                if k == start and not req.start_inclusive:
                    break
            else:
                if k >= stop:
                    if req.stop_inclusive and k == stop:
                        pass  # still include the stop key itself
                    else:
                        break
                if not req.start_inclusive and k == start:
                    continue
            limiter.add_count()
            iterated += 1
            if not limiter.valid():
                complete = False
                break
            _, sk = key_schema.restore_key(k)
            if not match_filter(req.sort_key_filter_type, req.sort_key_filter_pattern, sk):
                continue
            data = b"" if req.no_value else self._schema.extract_user_data(raw)
            out.append(msg.KeyValue(sk, data))
            size += len(sk) + len(data)
            limiter.add_size(len(sk) + len(data))
            if (req.max_kv_count > 0 and len(out) > req.max_kv_count) or (
                req.max_kv_size > 0 and size > req.max_kv_size
            ):
                out.pop()
                complete = False
                break
        self.cu_calculator.add_multi_get_cu(req.hash_key, out)
        self._check_abnormal_size(
            "multi_get", req.hash_key, size, self._abnormal_multi_get_size,
            rows=iterated, rows_thr=self._abnormal_multi_get_iterate_count)
        elapsed_us = int((time.perf_counter() - t0) * 1e6)
        if self.table_ledger is not None:
            self.table_ledger.charge_read(elapsed_us, size)
        self._check_slow_query("multi_get", req.hash_key, elapsed_us)
        resp.kvs = out
        resp.error = Status.OK if complete else Status.INCOMPLETE
        return resp

    def on_sortkey_count(self, hash_key: bytes, now: int = None) -> msg.CountResponse:
        """src/server/pegasus_server_impl.cpp:764."""
        now = epoch_now() if now is None else now
        resp = msg.CountResponse(app_id=self.app_id, partition_index=self.pidx,
                                 server=self.server)
        start = key_schema.generate_key(hash_key, b"")
        stop = key_schema.generate_next_bytes(hash_key)
        # counts resolve from the device intervals minus the host-filtered
        # deletions: the merged iterator already applies newest-wins /
        # tombstone / TTL, so counting its rows IS the filtered count.
        # scan_range (the eager device resolve) runs before the limiter
        # starts: see on_multi_get
        it = self._range_coalescer.scan_range(start, stop, now,
                                              hash32=_hk_hash32(hash_key))
        limiter = self._make_limiter(count_only=True)
        count = 0
        for _ in it:
            limiter.add_count()
            if not limiter.valid():
                resp.error = Status.INCOMPLETE
                break
            count += 1
        resp.count = count
        self.cu_calculator.add_sortkey_count_cu(hash_key)
        self._c_scan_qps.increment()
        return resp

    def on_ttl(self, key: bytes, now: int = None) -> msg.TTLResponse:
        """src/server/pegasus_server_impl.cpp:843."""
        now = epoch_now() if now is None else now
        resp = msg.TTLResponse(app_id=self.app_id, partition_index=self.pidx,
                               server=self.server)
        raw = self.engine.get(key, now=now)
        if raw is None:
            resp.error = Status.NOT_FOUND
            return resp
        expire = self._schema.extract_expire_ts(raw)
        resp.ttl_seconds = (expire - now) if expire > 0 else -1
        try:
            self.cu_calculator.add_ttl_cu(key_schema.restore_key(key)[0], key)
        except ValueError:
            pass
        return resp

    # ------------------------------------------------------------- scans

    def on_get_scanner(self, req: msg.GetScannerRequest, now: int = None) -> msg.ScanResponse:
        """src/server/pegasus_server_impl.cpp:904."""
        now = epoch_now() if now is None else now
        resp = msg.ScanResponse(app_id=self.app_id, partition_index=self.pidx,
                                server=self.server)
        self._c_scan_qps.increment()

        start = req.start_key
        stop = req.stop_key if req.stop_key else None
        # hash-key prefix filter narrows the LOWER bound like the reference
        # (:961-978): keys encode [u16 hashkey_len][hash_key][sort_key], and
        # any hash_key with this prefix has len >= len(pattern), so its
        # encoded key sorts >= [len(pattern)][pattern] — a valid lower bound.
        # (No tight upper bound exists: longer hash_keys sort by the leading
        # length field, not contiguously after the pattern range.)
        if (req.hash_key_filter_type == FilterType.MATCH_PREFIX
                and req.hash_key_filter_pattern):
            pstart = key_schema.generate_key(req.hash_key_filter_pattern, b"")
            if pstart > start:
                start = pstart
        # single-hashkey scans (the client's hash_scan shape) carry the
        # hashkey hash down so the file walk can bloom-prune
        h32 = None
        try:
            hk_start, _ = key_schema.restore_key(start)
            if hk_start and stop is not None and (
                    stop == key_schema.generate_next_bytes(hk_start)
                    or key_schema.restore_key(stop)[0] == hk_start):
                h32 = _hk_hash32(hk_start)
        except (ValueError, IndexError, struct.error):
            pass
        # the filter-free fast path (no row can be rejected server-side)
        # routes through the range coalescer so the scanner's batches
        # resolve their SST intervals on device; filtered scans keep the
        # plain host iterator — their effective ranges are sparse and the
        # per-row filters dominate anyway
        if self._scan_filter_free(req):
            it = self._range_coalescer.scan_range(start, stop, now,
                                                  hash32=h32)
        else:
            it = self.engine.scan(start, stop, now=now, hash32=h32)
        return self._fill_scan_batch(resp, it, req, now)

    def _scan_row_passes(self, req, k: bytes) -> bool:
        """The per-row filter set of append_key_value_for_scan
        (pegasus_server_impl.cpp:2094-2166)."""
        if not req.start_inclusive and k == req.start_key:
            return False
        if req.stop_key and k == req.stop_key and not req.stop_inclusive:
            return False
        hk, sk = key_schema.restore_key(k)
        if not match_filter(req.hash_key_filter_type,
                            req.hash_key_filter_pattern, hk):
            return False
        if not match_filter(req.sort_key_filter_type,
                            req.sort_key_filter_pattern, sk):
            return False
        if req.validate_partition_hash and self.engine.opts.partition_mask > 0:
            if not key_schema.check_key_hash(k, self.pidx,
                                             self.engine.opts.partition_mask):
                return False
        return True

    def on_scan(self, req: msg.ScanRequest, now: int = None) -> msg.ScanResponse:
        """src/server/pegasus_server_impl.cpp:1151: resume a pinned session."""
        now = epoch_now() if now is None else now
        resp = msg.ScanResponse(app_id=self.app_id, partition_index=self.pidx,
                                server=self.server)
        ctx = self._contexts.fetch(req.context_id)
        if ctx is None:
            resp.error = Status.NOT_FOUND
            resp.context_id = consts.SCAN_CONTEXT_ID_NOT_EXIST
            return resp
        return self._fill_scan_batch(resp, ctx.iterator, ctx.request, now, ctx=ctx)

    def on_clear_scanner(self, context_id: int) -> None:
        self._contexts.remove(context_id)

    def _scan_filter_free(self, req) -> bool:
        """No per-row filter can reject anything for this request: skip
        _scan_row_passes entirely (it restore_key()s EVERY row — two
        allocations per row for the overwhelmingly common filterless
        scan, a measurable slice of BASELINE's scan-path CPU)."""
        # (no stop_key clause: the engine iterator's upper bound is already
        # exclusive, so the row-level stop_inclusive check never fires)
        return (req.hash_key_filter_type == FilterType.NO_FILTER
                and req.sort_key_filter_type == FilterType.NO_FILTER
                and req.start_inclusive
                and not (req.validate_partition_hash
                         and self.engine.opts.partition_mask > 0))

    def _fill_scan_batch(self, resp, iterator, req, now, ctx=None):
        """Pull RAW engine rows: every iterated row (filtered out or not)
        charges the per-RPC limiter, so sparse-filter scans cannot pin a
        read thread unboundedly (reference scan loop under
        range_read_limiter, pegasus_server_impl.cpp:1000-1150)."""
        t0 = time.perf_counter()
        batch = max(1, req.batch_size)
        limiter = self._make_limiter()
        n = 0
        nbytes = 0
        exhausted = True
        filter_free = self._scan_filter_free(req)
        for k, raw, expire in iterator:
            limiter.add_count()
            if not limiter.valid():
                exhausted = False  # partial batch; session continues
                break
            if not filter_free and not self._scan_row_passes(req, k):
                continue
            data = b"" if req.no_value else self._schema.extract_user_data(raw)
            kv = msg.KeyValue(k, data)
            if req.return_expire_ts:
                kv.expire_ts_seconds = expire
            limiter.add_size(len(k) + len(data))
            nbytes += len(k) + len(data)
            resp.kvs.append(kv)
            n += 1
            if n >= batch:
                exhausted = False
                break
        self.cu_calculator.add_scan_cu(resp.kvs)
        if self.table_ledger is not None:
            self.table_ledger.charge_scan(
                int((time.perf_counter() - t0) * 1e6), nbytes)
        if exhausted:
            resp.context_id = consts.SCAN_CONTEXT_ID_COMPLETED
        else:
            if ctx is None:
                ctx = ScanContext(iterator, req)
            resp.context_id = self._contexts.put(ctx)
        return resp

    # -------------------------------------------------------------- hotkeys

    def on_detect_hotkey(self, kind: str, action: str) -> str:
        """detect_hotkey RPC (reference pegasus_server_impl.cpp:2976)."""
        if kind not in ("read", "write"):
            return f"ERROR: bad hotkey type {kind!r} (read|write)"
        if action not in ("start", "stop", "query"):
            return f"ERROR: bad action {action!r} (start|stop|query)"
        collector = self.read_hotkey if kind == "read" else self.write_hotkey
        if action == "start":
            return collector.start()
        if action == "stop":
            return collector.stop()
        return collector.query()

    # ------------------------------------------------------------ lifecycle

    def manual_compact(self, bottommost: bool = True, now: int = None) -> dict:
        t0 = time.perf_counter()
        stats = self.engine.manual_compact(bottommost=bottommost, now=now)
        counters.percentile(self._pfx + "manual_compact_s").set(
            time.perf_counter() - t0)
        return stats

    @property
    def last_audit(self):
        """Most recent decree-anchored consistency digest this replica
        computed (trigger_audit apply), or None."""
        return self.write_service.last_audit

    def stats(self) -> dict:
        return self.engine.stats()

    def close(self):
        self.engine.close()
