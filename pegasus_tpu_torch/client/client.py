"""Pegasus client: hashkey/sortkey API with partition-hash routing.

Port of pegasus_tpu/client/client.py: the pegasus_client surface (src/include/pegasus/client.h:40-380) over this
build's RPC transport: every call encodes (hash_key, sort_key) into a stored
key (base.key_schema), computes partition_hash = pegasus_key_hash(key)
(reference: src/client_lib/pegasus_client_impl.cpp:106), resolves
pidx = hash % partition_count, and calls the partition's serving node.

Partition resolution is pluggable: a StaticResolver pins a fixed
pidx -> address map (onebox); a meta-server resolver (not ported yet)
queries and caches the routing table. The client speaks the wire of
pegasus_tpu's servers as well as the port's, and touches no device.
"""

import threading

from ..base import consts, key_schema
from ..rpc import codec
from ..rpc import messages as msg
from ..rpc import task_codes as codes
from ..rpc.messages import Status
from ..rpc.task_codes import (RPC_CHECK_AND_MUTATE, RPC_CHECK_AND_SET,
                              RPC_INCR, RPC_MULTI_PUT, RPC_MULTI_REMOVE,
                              RPC_PUT, RPC_REMOVE)
from ..rpc.transport import (ConnectionPool, ERR_BUSY, ERR_INVALID_STATE,
                             ERR_NETWORK_FAILURE, ERR_OBJECT_NOT_FOUND,
                             ERR_TIMEOUT, RpcError)
from ..runtime.tasking import tracked_executor
from ..runtime.tracing import REQUEST_TRACER


class PegasusError(Exception):
    def __init__(self, status, text=""):
        super().__init__(f"pegasus error {status}: {text}")
        self.status = status


class StaticResolver:
    """Fixed pidx -> (host, port) map (single-node / onebox)."""

    def __init__(self, app_id: int, addresses):
        self.app_id = app_id
        self._addresses = list(addresses)

    @property
    def partition_count(self) -> int:
        return len(self._addresses)

    def refresh(self) -> None:
        pass  # static map: nothing to re-query

    def secondaries(self, pidx: int) -> list:
        return []  # static maps carry no membership info

    def resolve(self, pidx: int, refresh: bool = False):
        return self._addresses[pidx]


_READ_CODES = frozenset({codes.RPC_GET, codes.RPC_MULTI_GET, codes.RPC_TTL,
                         codes.RPC_SORTKEY_COUNT})


class PegasusClient:
    """Synchronous client for one table (app).

    backup_request=True sends failed READS to a secondary before waiting
    on reconfiguration (the reference's backup-request path: lower tail
    latency and availability at the cost of possibly-stale reads; scans
    stay on the primary — their sessions are server-pinned)."""

    def __init__(self, resolver, pool: ConnectionPool = None,
                 timeout: float = 10.0, backup_request: bool = False):
        self.resolver = resolver
        self.pool = pool or ConnectionPool()
        self.timeout = timeout
        self.backup_request = backup_request
        self._async_pool = None
        self._async_lock = threading.Lock()

    # ------------------------------------------------------------ internals

    def _route(self, key: bytes):
        h = key_schema.key_hash(key)
        pidx = h % self.resolver.partition_count
        return pidx, h

    def _call(self, code: str, pidx: int, phash: int, req_obj, resp_cls):
        # every client op opens (or joins) a request trace: the context
        # rides the RPC header from here down through replication and the
        # engine (runtime/tracing.py RequestTracer)
        with REQUEST_TRACER.root(code):
            return self._call_traced(code, pidx, phash, req_obj, resp_cls)

    def _call_traced(self, code, pidx, phash, req_obj, resp_cls):
        body = codec.encode(req_obj)
        last = None
        for attempt in range(3):
            if attempt > 0:
                try:
                    self.resolver.refresh()
                except (RpcError, OSError):
                    # a transient meta hiccup must not kill a DATA-op
                    # retry: the cached routing is still the best guess,
                    # and the op either succeeds against it or fails with
                    # its own (actionable) error below
                    pass
                if phash:
                    # reconfiguration may have CHANGED the partition count
                    # (split): recompute the route, not just the address
                    pidx = phash % self.resolver.partition_count
            addr = self.resolver.resolve(pidx)
            try:
                # one connection per (node, partition): the partition-group
                # serving node hands sharded connections to the owning
                # group executor, taking the router out of the data path
                conn = self.pool.get(addr, shard=pidx)
                _, rbody = conn.call(code, body, app_id=self.resolver.app_id,
                                     partition_index=pidx, partition_hash=phash,
                                     timeout=self.timeout)
                return codec.decode(resp_cls, rbody) if resp_cls else None
            except OSError as e:  # dead node: connect refused/reset
                last = e
                self.pool.invalidate(addr)
                backup = self._try_backup_read(code, body, pidx, phash, resp_cls)
                if backup is not None:
                    return backup[0]
                continue
            except RpcError as e:
                last = e
                if e.err in (ERR_NETWORK_FAILURE, ERR_TIMEOUT,
                             ERR_OBJECT_NOT_FOUND, ERR_INVALID_STATE):
                    self.pool.invalidate(addr)
                    if e.err in (ERR_NETWORK_FAILURE, ERR_TIMEOUT):
                        backup = self._try_backup_read(code, body, pidx,
                                                       phash, resp_cls)
                        if backup is not None:
                            return backup[0]
                    continue  # re-resolve (reconfiguration / failover)
                if e.err == ERR_BUSY:
                    # throttled (reference PERR_APP_BUSY): the caller decides
                    # whether to back off and retry — no transparent retry
                    raise PegasusError(Status.TRY_AGAIN, str(e))
                raise PegasusError(Status.IO_ERROR, str(e))
        raise PegasusError(Status.TRY_AGAIN, str(last))

    def _try_backup_read(self, code, body, pidx, phash, resp_cls):
        """-> (decoded,) from a secondary, or None. Reads only."""
        if not self.backup_request or code not in _READ_CODES:
            return None
        for addr in self.resolver.secondaries(pidx):
            try:
                conn = self.pool.get(addr, shard=pidx)
                _, rbody = conn.call(code, body, app_id=self.resolver.app_id,
                                     partition_index=pidx, partition_hash=phash,
                                     timeout=self.timeout)
                return (codec.decode(resp_cls, rbody) if resp_cls else None,)
            except (RpcError, OSError):
                self.pool.invalidate(addr)
                continue
        return None

    def _key_call(self, code, hash_key, sort_key, resp_cls):
        key = key_schema.generate_key(hash_key, sort_key)
        pidx, h = self._route(key)
        return self._call(code, pidx, h, msg.KeyRequest(key), resp_cls)

    def _hash_call(self, code, hash_key, req_obj, resp_cls):
        key = key_schema.generate_key(hash_key, b"")
        pidx, h = self._route(key)
        return self._call(code, pidx, h, req_obj, resp_cls)

    @staticmethod
    def _ok(resp, *accept):
        if resp.error not in (Status.OK, *accept):
            raise PegasusError(resp.error)
        return resp

    # ------------------------------------------------------------- data ops

    def set(self, hash_key: bytes, sort_key: bytes, value: bytes,
            ttl_seconds: int = 0) -> None:
        key = key_schema.generate_key(hash_key, sort_key)
        pidx, h = self._route(key)
        expire = key_schema.expire_ts_from_ttl(ttl_seconds)
        resp = self._call(RPC_PUT, pidx, h,
                          msg.UpdateRequest(key, value, expire),
                          msg.UpdateResponse)
        self._ok(resp)

    def get(self, hash_key: bytes, sort_key: bytes):
        """-> value bytes or None when absent."""
        resp = self._key_call(codes.RPC_GET, hash_key, sort_key, msg.ReadResponse)
        if resp.error == Status.NOT_FOUND:
            return None
        self._ok(resp)
        return resp.value

    def exist(self, hash_key: bytes, sort_key: bytes) -> bool:
        return self.get(hash_key, sort_key) is not None

    def delete(self, hash_key: bytes, sort_key: bytes) -> None:
        resp = self._key_call(RPC_REMOVE, hash_key, sort_key, msg.UpdateResponse)
        self._ok(resp)

    def ttl(self, hash_key: bytes, sort_key: bytes):
        """-> remaining seconds, -1 if no ttl, None if absent."""
        resp = self._key_call(codes.RPC_TTL, hash_key, sort_key, msg.TTLResponse)
        if resp.error == Status.NOT_FOUND:
            return None
        self._ok(resp)
        return resp.ttl_seconds

    def incr(self, hash_key: bytes, sort_key: bytes, increment: int,
             ttl_seconds: int = 0) -> int:
        key = key_schema.generate_key(hash_key, sort_key)
        pidx, h = self._route(key)
        expire = (key_schema.expire_ts_from_ttl(ttl_seconds)
                  if ttl_seconds > 0 else ttl_seconds)
        resp = self._call(RPC_INCR, pidx, h,
                          msg.IncrRequest(key, increment, expire),
                          msg.IncrResponse)
        self._ok(resp)
        return resp.new_value

    def batch_get(self, items, timeout: float = None):
        """Multi-partition point-read fan-out: items is [(hash_key,
        sort_key), ...] -> [value | None, ...] in order.

        Keys group by their (node, partition) connection and each group's
        requests leave as ONE pipelined call_many wave — send phase first
        across every connection, then collect, so k partitions' worth of
        server work runs concurrently and each direction costs one
        syscall per partition instead of one per key. A failed wave falls
        back to the per-key retrying path for just its keys."""
        out = [None] * len(items)
        groups = {}   # (addr, pidx) -> [(i, body, phash)]
        for i, (hk, sk) in enumerate(items):
            key = key_schema.generate_key(hk, sk)
            pidx, h = self._route(key)
            addr = tuple(self.resolver.resolve(pidx))
            groups.setdefault((addr, pidx), []).append(
                (i, codec.encode(msg.KeyRequest(key)), h))
        pends = []
        for (addr, pidx), entries in groups.items():
            calls = [(codes.RPC_GET, body, self.resolver.app_id, pidx, h)
                     for _, body, h in entries]
            try:
                conn = self.pool.get(addr, shard=pidx)
                pends.append((conn, calls, entries,
                              conn.call_many_send(calls)))
            except (RpcError, OSError):
                pends.append((None, calls, entries, None))
        for conn, calls, entries, handle in pends:
            results = None
            if handle is not None:
                try:
                    results = conn.call_many_collect(
                        handle, calls, timeout or self.timeout)
                except (RpcError, OSError):
                    results = None
            if results is None:   # wave failed: per-key retrying fallback
                for i, _, _ in entries:
                    hk, sk = items[i]
                    out[i] = self.get(hk, sk)
                continue
            for (i, _, _), (_, rbody) in zip(entries, results):
                resp = codec.decode(msg.ReadResponse, rbody)
                if resp.error == Status.NOT_FOUND:
                    out[i] = None
                elif resp.error != Status.OK:
                    raise PegasusError(resp.error)
                else:
                    out[i] = resp.value
        return out

    def multi_set(self, hash_key: bytes, kvs: dict, ttl_seconds: int = 0) -> None:
        req = msg.MultiPutRequest(
            hash_key,
            [msg.KeyValue(sk, v) for sk, v in kvs.items()],
            key_schema.expire_ts_from_ttl(ttl_seconds),
        )
        resp = self._hash_call(RPC_MULTI_PUT, hash_key, req, msg.UpdateResponse)
        self._ok(resp)

    def multi_get(self, hash_key: bytes, sort_keys=None, max_kv_count: int = 0,
                  max_kv_size: int = 0, **range_opts):
        """-> (complete, {sort_key: value}). With sort_keys=None fetches the
        (optionally bounded) range under hash_key."""
        req = msg.MultiGetRequest(hash_key, list(sort_keys or []),
                                  max_kv_count, max_kv_size, **range_opts)
        resp = self._hash_call(codes.RPC_MULTI_GET, hash_key, req,
                               msg.MultiGetResponse)
        self._ok(resp, Status.INCOMPLETE)
        return resp.error == Status.OK, {kv.key: kv.value for kv in resp.kvs}

    def multi_del(self, hash_key: bytes, sort_keys) -> int:
        req = msg.MultiRemoveRequest(hash_key, list(sort_keys))
        resp = self._hash_call(RPC_MULTI_REMOVE, hash_key, req,
                               msg.MultiRemoveResponse)
        self._ok(resp)
        return resp.count

    def sortkey_count(self, hash_key: bytes) -> int:
        key = key_schema.generate_key(hash_key, b"")
        pidx, h = self._route(key)
        resp = self._call(codes.RPC_SORTKEY_COUNT, pidx, h,
                          msg.KeyRequest(hash_key), msg.CountResponse)
        self._ok(resp, Status.INCOMPLETE)
        return resp.count

    def check_and_set(self, hash_key: bytes, check_sort_key: bytes,
                      check_type: int, check_operand: bytes,
                      set_sort_key: bytes, set_value: bytes,
                      set_ttl_seconds: int = 0, return_check_value: bool = False):
        req = msg.CheckAndSetRequest(
            hash_key, check_sort_key, check_type, check_operand,
            set_diff_sort_key=set_sort_key != check_sort_key,
            set_sort_key=set_sort_key, set_value=set_value,
            set_expire_ts_seconds=key_schema.expire_ts_from_ttl(set_ttl_seconds),
            return_check_value=return_check_value)
        resp = self._hash_call(RPC_CHECK_AND_SET, hash_key, req,
                               msg.CheckAndSetResponse)
        if resp.error not in (Status.OK, Status.TRY_AGAIN):
            raise PegasusError(resp.error)
        return resp

    def check_and_mutate(self, hash_key: bytes, check_sort_key: bytes,
                         check_type: int, check_operand: bytes,
                         mutations, return_check_value: bool = False):
        """mutations: list of ("set", sort_key, value, ttl) | ("del", sort_key)."""
        ml = []
        for m in mutations:
            if m[0] == "set":
                _, sk, v, ttl = m
                ml.append(msg.Mutate(msg.MutateOperation.PUT, sk, v,
                                     key_schema.expire_ts_from_ttl(ttl)))
            else:
                ml.append(msg.Mutate(msg.MutateOperation.DELETE, m[1]))
        req = msg.CheckAndMutateRequest(hash_key, check_sort_key, check_type,
                                        check_operand, ml, return_check_value)
        resp = self._hash_call(RPC_CHECK_AND_MUTATE, hash_key, req,
                               msg.CheckAndMutateResponse)
        if resp.error not in (Status.OK, Status.TRY_AGAIN):
            raise PegasusError(resp.error)
        return resp

    # --------------------------------------------------------------- scans

    def get_scanner(self, hash_key: bytes = b"", start_sort_key: bytes = b"",
                    stop_sort_key: bytes = b"", batch_size: int = 1000,
                    **opts):
        """Scanner over one hash_key's range (hash scanner). For a full-table
        scan use get_unordered_scanners."""
        if hash_key:
            start = key_schema.generate_key(hash_key, start_sort_key)
            stop = (key_schema.generate_key(hash_key, stop_sort_key)
                    if stop_sort_key else key_schema.generate_next_bytes(hash_key))
            pidx, h = self._route(start)
            return Scanner(self, [pidx], start, stop, batch_size, phash=h, **opts)
        return Scanner(self, list(range(self.resolver.partition_count)),
                       b"", b"", batch_size, **opts)

    def get_unordered_scanners(self, max_split_count: int = 0,
                               batch_size: int = 1000,
                               prefetch: bool = True):
        """One scanner per partition group (full-table scan, reference
        client.h:322-380). prefetch=True (default) opens every
        partition's scan session up front as a batched fan-out: all the
        get_scanner requests leave before any response is awaited
        (call_many send/collect split), so the partitions build their
        first batches concurrently instead of serially on first use —
        and every scanner keeps pipelining its CONTINUATION batches the
        same way (Scanner prefetch: the next RPC_SCAN is on the wire
        while the current batch drains). A failed prefetch degrades that
        scanner to lazy fetching."""
        n = self.resolver.partition_count
        scanners = [Scanner(self, [p], b"", b"", batch_size,
                            prefetch=prefetch)
                    for p in range(n)]
        if not prefetch:
            return scanners
        pends = []
        for sc in scanners:
            pidx = sc.pidxs[0]
            req = msg.GetScannerRequest(batch_size=batch_size,
                                        validate_partition_hash=False)
            calls = [(codes.RPC_GET_SCANNER, codec.encode(req),
                      self.resolver.app_id, pidx, 0)]
            try:
                conn = self.pool.get(self.resolver.resolve(pidx),
                                     shard=pidx)
                pends.append((sc, conn, calls, conn.call_many_send(calls)))
            except (RpcError, OSError):
                continue
        for sc, conn, calls, handle in pends:
            try:
                (_, rbody), = conn.call_many_collect(handle, calls,
                                                     self.timeout)
                resp = codec.decode(msg.ScanResponse, rbody)
            except (RpcError, OSError):
                continue
            if resp.error == Status.OK:
                sc._preload(resp)
        return scanners

    # -------------------------------------------------------------- async
    # The reference API is half async_* callbacks over its rDSN task pool
    # (client.h:283-320). These return concurrent.futures.Future from a
    # shared executor and still accept the callback idiom:
    # callback(error_code, result), error_code 0 on success, the
    # PegasusError status otherwise. The RPC transport is pipelined and
    # thread-safe, so concurrent futures share connections.

    _MAX_ASYNC_WORKERS = 8

    def _executor(self):
        with self._async_lock:
            if self._async_pool is None:
                self._async_pool = tracked_executor(
                    self._MAX_ASYNC_WORKERS,
                    thread_name_prefix="pegasus-async")
            return self._async_pool

    def _submit(self, fn, callback, *args, **kwargs):
        future = self._executor().submit(fn, *args, **kwargs)
        if callback is not None:
            def _done(f):
                err = f.exception()
                if err is None:
                    callback(0, f.result())
                elif isinstance(err, PegasusError):
                    callback(err.status, None)
                else:
                    callback(-1, None)

            future.add_done_callback(_done)
        return future

    def async_set(self, hash_key, sort_key, value, ttl_seconds=0,
                  callback=None):
        return self._submit(self.set, callback, hash_key, sort_key, value,
                            ttl_seconds)

    def async_get(self, hash_key, sort_key, callback=None):
        return self._submit(self.get, callback, hash_key, sort_key)

    def async_del(self, hash_key, sort_key, callback=None):
        return self._submit(self.delete, callback, hash_key, sort_key)

    def async_multi_set(self, hash_key, kvs, ttl_seconds=0, callback=None):
        return self._submit(self.multi_set, callback, hash_key, kvs,
                            ttl_seconds)

    def async_multi_get(self, hash_key, sort_keys=None, max_kv_count=0,
                        max_kv_size=0, callback=None):
        return self._submit(self.multi_get, callback, hash_key, sort_keys,
                            max_kv_count, max_kv_size)

    def async_multi_del(self, hash_key, sort_keys, callback=None):
        return self._submit(self.multi_del, callback, hash_key, sort_keys)

    def async_incr(self, hash_key, sort_key, increment, ttl_seconds=0,
                   callback=None):
        return self._submit(self.incr, callback, hash_key, sort_key,
                            increment, ttl_seconds)

    def async_check_and_set(self, hash_key, check_sort_key, check_type,
                            check_operand, set_sort_key, set_value,
                            ttl_seconds=0, return_check_value=False,
                            callback=None):
        return self._submit(self.check_and_set, callback, hash_key,
                            check_sort_key, check_type, check_operand,
                            set_sort_key, set_value, ttl_seconds,
                            return_check_value)

    def async_check_and_mutate(self, hash_key, check_sort_key, check_type,
                               check_operand, mutations,
                               return_check_value=False, callback=None):
        return self._submit(self.check_and_mutate, callback, hash_key,
                            check_sort_key, check_type, check_operand,
                            mutations, return_check_value)

    def async_sortkey_count(self, hash_key, callback=None):
        return self._submit(self.sortkey_count, callback, hash_key)

    def close(self):
        with self._async_lock:
            pool, self._async_pool = self._async_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        self.pool.close()


class Scanner:
    """Iterates (hash_key, sort_key, value) across partitions sequentially
    (reference pegasus_scanner_impl walks partitions in order).

    prefetch=True pipelines continuation batches: as soon as a batch with
    a live server session is absorbed, the next RPC_SCAN leaves on the
    wire (call_many send/collect split) and is collected when iteration
    drains the current batch — the server builds batch N+1 (one
    device-served range dispatch per batch) while the client consumes
    batch N. A failed prefetch degrades that fetch to the retrying lazy
    path, so semantics are unchanged."""

    def __init__(self, client: PegasusClient, pidxs, start_key, stop_key,
                 batch_size, phash: int = 0, **opts):
        self.client = client
        self.pidxs = list(pidxs)
        self.start_key = start_key
        self.stop_key = stop_key
        self.batch_size = batch_size
        self.phash = phash
        self._prefetch = bool(opts.pop("prefetch", False))
        self.opts = opts
        self._cur = 0
        self._ctx = None
        self._batch = []
        self._bi = 0
        self._done = False
        self._pending = None  # in-flight continuation (conn, calls, handle,
        #                       pidx, ctx) — collected by the next _fetch

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._bi < len(self._batch):
                kv = self._batch[self._bi]
                self._bi += 1
                hk, sk = key_schema.restore_key(kv.key)
                return hk, sk, kv.value
            if self._done:
                raise StopIteration
            self._fetch()

    def _fetch(self):
        if self._cur >= len(self.pidxs):
            self._done = True
            return
        pidx = self.pidxs[self._cur]
        if self._collect_prefetch(pidx):
            return
        if self._ctx is None:
            req = msg.GetScannerRequest(
                start_key=self.start_key, stop_key=self.stop_key,
                batch_size=self.batch_size,
                validate_partition_hash=False, **self.opts)
            resp = self.client._call(codes.RPC_GET_SCANNER, pidx, self.phash,
                                     req, msg.ScanResponse)
        else:
            resp = self.client._call(codes.RPC_SCAN, pidx, self.phash,
                                     msg.ScanRequest(self._ctx), msg.ScanResponse)
        if resp.error not in (Status.OK,):
            raise PegasusError(resp.error)
        self._absorb(resp)

    def _absorb(self, resp):
        self._batch = resp.kvs
        self._bi = 0
        if resp.context_id == consts.SCAN_CONTEXT_ID_COMPLETED:
            self._ctx = None
            self._cur += 1
        else:
            # an EMPTY batch can still be incomplete: the server's range
            # limiter may spend its whole budget on filtered-out rows —
            # keep the session and fetch again
            self._ctx = resp.context_id
            if self._prefetch:
                self._send_prefetch()

    def _send_prefetch(self):
        """Fire the next RPC_SCAN for the live session without waiting
        (best effort: any failure just leaves the lazy path to do the
        fetch with its full retry machinery)."""
        pidx = self.pidxs[self._cur]
        calls = [(codes.RPC_SCAN, codec.encode(msg.ScanRequest(self._ctx)),
                  self.client.resolver.app_id, pidx, self.phash)]
        try:
            conn = self.client.pool.get(self.client.resolver.resolve(pidx),
                                        shard=pidx)
            self._pending = (conn, calls, conn.call_many_send(calls),
                             pidx, self._ctx)
        except (RpcError, OSError):
            self._pending = None

    def _collect_prefetch(self, pidx) -> bool:
        """Absorb an in-flight prefetched batch. -> True when it served
        this fetch; False degrades to the lazy path (stale target after a
        partition transition, send/collect failure, server-side error)."""
        if self._pending is None:
            return False
        conn, calls, handle, ppidx, pctx = self._pending
        self._pending = None
        if ppidx != pidx or pctx != self._ctx:
            return False
        try:
            (_, rbody), = conn.call_many_collect(handle, calls,
                                                 self.client.timeout)
            resp = codec.decode(msg.ScanResponse, rbody)
        except (RpcError, OSError):
            return False
        if resp.error != Status.OK:
            return False
        self._absorb(resp)
        return True

    def _preload(self, resp):
        """Absorb a fan-out-prefetched first batch (get_unordered_scanners
        opened this partition's session before iteration started)."""
        if self._cur == 0 and self._ctx is None and not self._batch:
            self._absorb(resp)

    def close(self):
        if self._ctx is not None and self._cur < len(self.pidxs):
            try:
                self.client._call(codes.RPC_CLEAR_SCANNER, self.pidxs[self._cur],
                                  self.phash, msg.ScanRequest(self._ctx), None)
            except (PegasusError, RpcError):
                pass
            self._ctx = None
