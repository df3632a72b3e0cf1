"""Replica serverlet: binds rrdb task codes to a PegasusServer per partition.

Port of pegasus_tpu/engine/replica_service.py, the reference's
pegasus_read_service registration glue + pegasus_service_app
(src/server/pegasus_read_service.h:36-84, pegasus_service_app.h): one
process serves many (app_id, partition) replicas; each RPC is routed by the
header's (app_id, partition_index) and the key's partition hash is sanity-
checked against the partition the way pegasus_server_write does
(src/server/pegasus_server_write.cpp per-request hash check).

Standalone mode commits writes locally with a monotonically increasing
decree under the partition's write lock (one writer per partition, as
PacificA serialises them). set_write_router is the seam through which a
replication layer takes the writes over (PacificA is not ported yet).
Read and write throttles answer ERR_BUSY; on-disk corruption
ERR_INVALID_DATA; a device, build or launch failure reaches the caller as
ERR_INVALID_DATA with its repr (the transport's handler-error mapping).
Batch handlers (rpc_batch_handlers) serve the hot read codes the
transport bins per wave: a wave of gets is one PegasusServer.on_get_batch
per replica, so concurrent point reads reach the device lookup.
"""

import threading
import time

from ..rpc import codec
from ..rpc import messages as msg
from ..rpc.task_codes import (RPC_CLEAR_SCANNER, RPC_GET,  # noqa: F401
                              RPC_GET_SCANNER, RPC_MULTI_GET, RPC_SCAN,
                              RPC_SORTKEY_COUNT, RPC_TTL)
from ..rpc.transport import (ERR_BUSY, ERR_INVALID_DATA, ERR_INVALID_STATE,
                             ERR_OBJECT_NOT_FOUND, RpcError)
from ..runtime.perf_counters import counters
from . import server_impl
from .server_impl import PegasusServer
from .sstable import CorruptionError
from .throttling import ThrottleReject

WRITE_CODES = {
    server_impl.RPC_PUT: (msg.UpdateRequest, msg.UpdateResponse),
    server_impl.RPC_REMOVE: (msg.KeyRequest, msg.UpdateResponse),
    server_impl.RPC_MULTI_PUT: (msg.MultiPutRequest, msg.UpdateResponse),
    server_impl.RPC_MULTI_REMOVE: (msg.MultiRemoveRequest, msg.MultiRemoveResponse),
    server_impl.RPC_INCR: (msg.IncrRequest, msg.IncrResponse),
    server_impl.RPC_CHECK_AND_SET: (msg.CheckAndSetRequest, msg.CheckAndSetResponse),
    server_impl.RPC_CHECK_AND_MUTATE: (msg.CheckAndMutateRequest,
                                       msg.CheckAndMutateResponse),
    server_impl.RPC_DUPLICATE: (msg.DuplicateRequest, msg.DuplicateResponse),
    server_impl.RPC_BULK_LOAD_INGEST: (msg.BulkLoadIngestRequest,
                                       msg.BulkLoadIngestResponse),
    server_impl.RPC_TRIGGER_AUDIT: (msg.TriggerAuditRequest,
                                    msg.TriggerAuditResponse),
}


def _charge_error(srv) -> None:
    """An error the table saw (a throttle reject, a corrupt read)."""
    if srv.table_ledger is not None:
        srv.table_ledger.charge_error()


def _corruption_error(srv, e: CorruptionError) -> RpcError:
    _charge_error(srv)
    return RpcError(ERR_INVALID_DATA, f"on-disk corruption: {e.detail} "
                                      f"(replica {srv.app_id}.{srv.pidx})")


class ReplicaService:
    """Hosts PegasusServer replicas; register with RpcServer.register_serverlet."""

    def __init__(self):
        self._lock = threading.Lock()
        self._replicas = {}     # (app_id, pidx) -> PegasusServer
        self._wlocks = {}       # (app_id, pidx) -> per-partition write lock
        self._partition_counts = {}  # app_id -> partition count
        self._write_router = None    # set by replication to intercept writes

    def add_replica(self, server: PegasusServer, partition_count: int) -> None:
        with self._lock:
            self._replicas[(server.app_id, server.pidx)] = server
            self._wlocks[(server.app_id, server.pidx)] = threading.Lock()
            self._partition_counts[server.app_id] = partition_count

    def remove_replica(self, app_id: int, pidx: int) -> None:
        with self._lock:
            self._replicas.pop((app_id, pidx), None)
            self._wlocks.pop((app_id, pidx), None)

    def set_write_router(self, fn) -> None:
        """fn(server, code, req) -> response; replaces local commit (PacificA)."""
        self._write_router = fn

    def _replica(self, header) -> PegasusServer:
        srv = self._replicas.get((header.app_id, header.partition_index))
        if srv is None:
            raise RpcError(ERR_OBJECT_NOT_FOUND,
                           f"partition {header.app_id}.{header.partition_index} "
                           f"not served here")
        n = self._partition_counts.get(header.app_id, 1)
        if n > 0 and header.partition_hash \
                and header.partition_index != header.partition_hash % n:
            raise RpcError(ERR_INVALID_STATE,
                           f"partition hash routes to "
                           f"{header.partition_hash % n}, not {header.partition_index}")
        return srv

    # --------------------------------------------------------------- handlers

    def rpc_handlers(self) -> dict:
        h = {
            RPC_GET: self._on_get,
            RPC_MULTI_GET: self._on_multi_get,
            RPC_SORTKEY_COUNT: self._on_sortkey_count,
            RPC_TTL: self._on_ttl,
            RPC_GET_SCANNER: self._on_get_scanner,
            RPC_SCAN: self._on_scan,
            RPC_CLEAR_SCANNER: self._on_clear_scanner,
        }
        for code in WRITE_CODES:
            h[code] = self._on_write
        return h

    def rpc_batch_handlers(self) -> dict:
        """Hot read codes the transport coalesces per wave. Each
        fn(headers, bodies) returns one result per frame: bytes on
        success, or the RpcError/Exception the per-frame handler would
        have raised, so the transport writes byte-identical responses
        either way."""
        return {
            RPC_GET: self._on_get_batch,
            RPC_MULTI_GET: self._batch_loop(self._on_multi_get),
            RPC_SCAN: self._batch_loop(self._on_scan),
        }

    @staticmethod
    def _batch_loop(fn):
        """Per-frame handler -> batch handler: the storage call stays per
        frame, the wave pays one dispatch and one reply write."""
        def run(headers, bodies):
            out = []
            for header, body in zip(headers, bodies):
                try:
                    out.append(fn(header, body))
                except Exception as e:  # noqa: BLE001 - per-frame verdict
                    out.append(e)
            return out
        return run

    def _replica_read(self, header) -> PegasusServer:
        """Resolve + charge the read throttle (reference
        replica.read_throttling env; qps units)."""
        srv = self._replica(header)
        try:
            srv.read_qps_throttler.consume(1)
        except ThrottleReject as e:
            _charge_error(srv)
            raise RpcError(ERR_BUSY, str(e))
        return srv

    def _read(self, header, method: str, *args):
        """Serve one read with on-disk corruption surfaced as a TYPED
        rpc error: the engine refused to return bytes it cannot verify,
        and the client sees a clean error naming the cause, never garbage
        and never a handler-bug repr."""
        srv = self._replica_read(header)
        try:
            return getattr(srv, method)(*args)
        except CorruptionError as e:
            raise _corruption_error(srv, e)

    def _on_get(self, header, body) -> bytes:
        req = codec.decode(msg.KeyRequest, body)
        return codec.encode(self._read(header, "on_get", req.key))

    def _on_get_batch(self, headers, bodies) -> list:
        """RPC_GET over a coalesced wave: per-frame admission (decode,
        partition resolve, read throttle: each request charged on its
        own), then ONE PegasusServer.on_get_batch per distinct replica.
        A per-frame failure is that frame's result, a replica's failure
        every member's: the errors _on_get would have raised."""
        results = [None] * len(headers)
        groups = {}  # id(srv) -> (srv, [(frame index, key), ...])
        for i, (header, body) in enumerate(zip(headers, bodies)):
            try:
                req = codec.decode(msg.KeyRequest, body)
                srv = self._replica_read(header)
            except Exception as e:  # noqa: BLE001 - per-frame verdict
                results[i] = e
                continue
            groups.setdefault(id(srv), (srv, []))[1].append((i, req.key))
        for srv, members in groups.values():
            try:
                resps = srv.on_get_batch([k for _, k in members])
                for (i, _), resp in zip(members, resps):
                    results[i] = codec.encode(resp)
            except Exception as e:  # noqa: BLE001 - per-frame verdict
                if isinstance(e, CorruptionError):
                    e = _corruption_error(srv, e)
                for i, _ in members:
                    results[i] = e
        return results

    def _on_multi_get(self, header, body) -> bytes:
        req = codec.decode(msg.MultiGetRequest, body)
        return codec.encode(self._read(header, "on_multi_get", req))

    def _on_sortkey_count(self, header, body) -> bytes:
        req = codec.decode(msg.KeyRequest, body)
        return codec.encode(self._read(header, "on_sortkey_count", req.key))

    def _on_ttl(self, header, body) -> bytes:
        req = codec.decode(msg.KeyRequest, body)
        return codec.encode(self._read(header, "on_ttl", req.key))

    def _on_get_scanner(self, header, body) -> bytes:
        req = codec.decode(msg.GetScannerRequest, body)
        return codec.encode(self._read(header, "on_get_scanner", req))

    def _on_scan(self, header, body) -> bytes:
        req = codec.decode(msg.ScanRequest, body)
        return codec.encode(self._read(header, "on_scan", req))

    def _on_clear_scanner(self, header, body) -> bytes:
        req = codec.decode(msg.ScanRequest, body)
        self._replica(header).on_clear_scanner(req.context_id)
        return b""

    def _on_write(self, header, body) -> bytes:
        req_cls, _ = WRITE_CODES[header.code]
        req = codec.decode(req_cls, body)
        srv = self._replica(header)
        # per-table throttling gates the request BEFORE any decree work
        # (reference: rDSN throttling_controller consulted on the primary,
        # env replica.write_throttling[_by_size])
        try:
            d0 = (srv.write_qps_throttler.delayed_count
                  + srv.write_size_throttler.delayed_count)
            srv.write_qps_throttler.consume(1)
            srv.write_size_throttler.consume(len(body))
            # compaction-debt admission control: graduated delay as L0
            # debt approaches the stall cliff (counted on the
            # engine.throttle.debt_* series)
            delay_ms = srv.debt_throttler.consume()
            if delay_ms > 0:
                # per-partition delay attribution: which partition paid
                # the debt stall, in ms
                counters.rate(
                    f"app.{srv.app_id}.{srv.pidx}."
                    "recent_write_throttling_delay_ms").increment(delay_ms)
            if (srv.write_qps_throttler.delayed_count
                    + srv.write_size_throttler.delayed_count) > d0:
                counters.rate(
                    f"app.{srv.app_id}.{srv.pidx}."
                    "recent_write_throttling_delay_count").increment()
        except ThrottleReject as e:
            counters.rate(
                f"app.{srv.app_id}.{srv.pidx}."
                "recent_write_throttling_reject_count").increment()
            _charge_error(srv)
            raise RpcError(ERR_BUSY, str(e))
        if srv.table_ledger is not None:
            srv.table_ledger.charge_bytes_in(len(body))
        router = self._write_router
        if router is not None:
            resp = router(srv, header.code, req)
        else:
            with self._wlocks[(srv.app_id, srv.pidx)]:
                decree = srv.engine.last_committed_decree() + 1
                resps = srv.on_batched_write_requests(
                    decree, int(time.time() * 1e6), [(header.code, req)])
                resp = resps[0]
        return codec.encode(resp)
