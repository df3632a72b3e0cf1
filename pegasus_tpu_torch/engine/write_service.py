"""Write service: one function per mutation type over the engine.

Port of pegasus_tpu/engine/write_service.py, a mirror of
pegasus_write_service(_impl) (src/server/pegasus_write_service.{h,cpp},
_impl.h): typed mutations arrive post-commit from replication with a decree;
each either builds a WriteBatch (batched put/remove path) or performs its
read-modify-write atomically (incr :179, check_and_set :261,
check_and_mutate :358) — safe because PacificA serializes writes per
partition. Every committed decree lands in the engine meta store even for
rejected mutations (empty_put), preserving the last_flushed_decree invariant.
"""

import time

from ..base import key_schema
from ..base.utils import epoch_now
from ..base.value_schema import SCHEMAS, generate_timetag
from ..runtime import events
from ..runtime.fail_points import fail_point
from ..runtime.perf_counters import counters
from ..runtime.tracing import REQUEST_TRACER
from ..rpc import codec, messages as msg, task_codes
from ..rpc.messages import CasCheckType, MutateOperation, Status
from .db import LsmEngine, WriteBatch

# inner request type per duplicable task code (duplicate_request.raw_message)
_DUP_INNER = {
    task_codes.RPC_PUT: msg.UpdateRequest,
    task_codes.RPC_REMOVE: msg.KeyRequest,
    task_codes.RPC_MULTI_PUT: msg.MultiPutRequest,
    task_codes.RPC_MULTI_REMOVE: msg.MultiRemoveRequest,
    task_codes.RPC_INCR: msg.IncrRequest,
    task_codes.RPC_CHECK_AND_SET: msg.CheckAndSetRequest,
    task_codes.RPC_CHECK_AND_MUTATE: msg.CheckAndMutateRequest,
}


def buf2int64(data: bytes):
    """dsn::buf2int64: strict ascii int64 parse; None on failure."""
    try:
        text = data.decode("ascii")
    except UnicodeDecodeError:
        return None
    if not text or text.strip() != text:
        return None
    try:
        v = int(text, 10)
    except ValueError:
        return None
    if not (-(1 << 63) <= v < (1 << 63)):
        return None
    return v


class WriteService:
    def __init__(self, engine: LsmEngine, app_id: int = 1, pidx: int = 0,
                 server: str = "", cluster_id: int = 0):
        self.engine = engine
        self.app_id = app_id
        self.pidx = pidx
        self.server = server
        self.cluster_id = cluster_id
        self._schema = SCHEMAS[engine.data_version()]
        self._batch = None
        self.cu_calculator = None  # set by PegasusServer
        # most recent decree-anchored consistency digest (trigger_audit);
        # the replica stub's query-audit command + beacon states read it
        self.last_audit = None

    def _hk(self, key: bytes) -> bytes:
        return key_schema.restore_key(key)[0]

    def _engine_write(self, batch, decree: int) -> None:
        """Every mutation reaches the engine through here, so the request
        trace separates engine-write time from the read-modify-write
        around it (incr/CAS read the old value first)."""
        with REQUEST_TRACER.span("engine.write", decree=decree):
            self.engine.write(batch, decree)

    # ----------------------------------------------------------- helpers

    def _fill(self, resp, decree):
        resp.app_id = self.app_id
        resp.partition_index = self.pidx
        if hasattr(resp, "decree"):
            resp.decree = decree
        resp.server = self.server
        return resp

    def _encode(self, user_data: bytes, expire_ts: int, timestamp_us: int = 0,
                deleted: bool = False) -> bytes:
        timetag = 0
        if self._schema.VERSION >= 1:
            timetag = generate_timetag(timestamp_us, self.cluster_id, deleted)
        return self._schema.generate_value(expire_ts, timetag, user_data)

    def _get_live(self, key: bytes, now: int):
        """-> (found, user_data, expire_ts); found=False when missing/expired/
        tombstoned (the db_get_context equivalent)."""
        raw = self.engine.get(key, now=now)
        if raw is None:
            return False, b"", 0
        return True, self._schema.extract_user_data(raw), self._schema.extract_expire_ts(raw)

    def empty_put(self, decree: int):
        """Advance last_flushed_decree with no data mutation
        (src/server/pegasus_write_service.cpp empty_put)."""
        self._engine_write(WriteBatch(), decree)
        return Status.OK

    # ------------------------------------------------------------ writes

    def put(self, decree: int, req: msg.UpdateRequest, timestamp_us: int = 0):
        resp = self._fill(msg.UpdateResponse(), decree)
        value = self._encode(req.value, req.expire_ts_seconds, timestamp_us)
        self._engine_write(WriteBatch().put(req.key, value, req.expire_ts_seconds), decree)
        if self.cu_calculator:
            self.cu_calculator.add_put_cu(self._hk(req.key), req.key, req.value)
        return resp

    def remove(self, decree: int, key: bytes):
        resp = self._fill(msg.UpdateResponse(), decree)
        self._engine_write(WriteBatch().delete(key), decree)
        if self.cu_calculator:
            self.cu_calculator.add_remove_cu(self._hk(key), key)
        return resp

    def multi_put(self, decree: int, req: msg.MultiPutRequest, timestamp_us: int = 0):
        resp = self._fill(msg.UpdateResponse(), decree)
        if not req.kvs:
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        batch = WriteBatch()
        total = 0
        for kv in req.kvs:
            key = key_schema.generate_key(req.hash_key, kv.key)
            value = self._encode(kv.value, req.expire_ts_seconds, timestamp_us)
            batch.put(key, value, req.expire_ts_seconds)
            total += len(key) + len(kv.value)
        self._engine_write(batch, decree)
        if self.cu_calculator:
            self.cu_calculator.add_multi_put_cu(req.hash_key, req.kvs)
        return resp

    def multi_remove(self, decree: int, req: msg.MultiRemoveRequest):
        resp = self._fill(msg.MultiRemoveResponse(), decree)
        if not req.sort_keys:
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        batch = WriteBatch()
        total = 0
        for sk in req.sort_keys:
            batch.delete(key_schema.generate_key(req.hash_key, sk))
            total += len(req.hash_key) + len(sk)
        self._engine_write(batch, decree)
        if self.cu_calculator:
            self.cu_calculator.add_multi_remove_cu(req.hash_key, req.sort_keys)
        resp.count = len(req.sort_keys)
        return resp

    def incr(self, decree: int, req: msg.IncrRequest, now: int = None):
        """src/server/pegasus_write_service_impl.h:179-258 semantics."""
        resp = self._fill(msg.IncrResponse(), decree)
        now = epoch_now() if now is None else now
        found, old_data, old_expire = self._get_live(req.key, now)
        if not found:
            new_value = req.increment
            new_expire = req.expire_ts_seconds if req.expire_ts_seconds > 0 else 0
        else:
            if len(old_data) == 0:
                new_value = req.increment
            else:
                old_int = buf2int64(old_data)
                if old_int is None:
                    resp.error = Status.INVALID_ARGUMENT
                    self.empty_put(decree)
                    return resp
                new_value = old_int + req.increment
                # int64 overflow rejection (impl.h:137-143); explicit range
                # check because python ints never wrap
                if not (-(1 << 63) <= new_value < (1 << 63)):
                    resp.error = Status.INVALID_ARGUMENT
                    resp.new_value = old_int
                    self.empty_put(decree)
                    return resp
            if req.expire_ts_seconds == 0:
                new_expire = old_expire
            elif req.expire_ts_seconds < 0:
                new_expire = 0
            else:
                new_expire = req.expire_ts_seconds
        value = self._encode(str(new_value).encode(), new_expire)
        self._engine_write(WriteBatch().put(req.key, value, new_expire), decree)
        if self.cu_calculator:  # RMW: read CU for the old value + write CU
            self.cu_calculator.add_incr_cu(self._hk(req.key), req.key)
        resp.new_value = new_value
        return resp

    def check_and_set(self, decree: int, req: msg.CheckAndSetRequest, now: int = None):
        """src/server/pegasus_write_service_impl.h:261-357 semantics."""
        resp = self._fill(msg.CheckAndSetResponse(), decree)
        now = epoch_now() if now is None else now
        if not self._check_type_supported(req.check_type):
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        check_key = key_schema.generate_key(req.hash_key, req.check_sort_key)
        exist, check_data, _ = self._get_live(check_key, now)
        if req.return_check_value:
            resp.check_value_returned = True
            resp.check_value_exist = exist
            if exist:
                resp.check_value = check_data
        passed, invalid = self._validate_check(req.check_type, req.check_operand,
                                               exist, check_data)
        if invalid:
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        if not passed:
            resp.error = Status.TRY_AGAIN
            self.empty_put(decree)
            return resp
        set_sk = req.set_sort_key if req.set_diff_sort_key else req.check_sort_key
        set_key = key_schema.generate_key(req.hash_key, set_sk)
        value = self._encode(req.set_value, req.set_expire_ts_seconds)
        self._engine_write(
            WriteBatch().put(set_key, value, req.set_expire_ts_seconds), decree
        )
        if self.cu_calculator:  # RMW: the check read charges read CU too
            self.cu_calculator.add_check_and_set_cu(
                req.hash_key, req.check_sort_key, set_sk, req.set_value)
        return resp

    def check_and_mutate(self, decree: int, req: msg.CheckAndMutateRequest, now: int = None):
        """src/server/pegasus_write_service_impl.h:358-483 semantics."""
        resp = self._fill(msg.CheckAndMutateResponse(), decree)
        now = epoch_now() if now is None else now
        if not req.mutate_list:
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        if not self._check_type_supported(req.check_type):
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        check_key = key_schema.generate_key(req.hash_key, req.check_sort_key)
        exist, check_data, _ = self._get_live(check_key, now)
        if req.return_check_value:
            resp.check_value_returned = True
            resp.check_value_exist = exist
            if exist:
                resp.check_value = check_data
        passed, invalid = self._validate_check(req.check_type, req.check_operand,
                                               exist, check_data)
        if invalid:
            resp.error = Status.INVALID_ARGUMENT
            self.empty_put(decree)
            return resp
        if not passed:
            resp.error = Status.TRY_AGAIN
            self.empty_put(decree)
            return resp
        batch = WriteBatch()
        total = 0
        for m in req.mutate_list:
            key = key_schema.generate_key(req.hash_key, m.sort_key)
            if m.operation == MutateOperation.PUT:
                value = self._encode(m.value, m.set_expire_ts_seconds)
                batch.put(key, value, m.set_expire_ts_seconds)
                total += len(key) + len(value)
            else:
                batch.delete(key)
                total += len(key)
        self._engine_write(batch, decree)
        if self.cu_calculator:  # RMW: the check read charges read CU too
            self.cu_calculator.add_check_and_mutate_cu(
                req.hash_key, req.check_sort_key, total, len(req.mutate_list))
        return resp

    def ingestion_files(self, decree: int, req: msg.BulkLoadIngestRequest):
        """Replicated bulk-load ingestion (the ingestion_files write,
        reference pegasus_write_service_impl.h:484): every replica of the
        partition applies this at the same decree, reading the SHARED
        provider set — so bulk-loaded data has a decree and survives
        failover like any other committed write."""
        from .bulk_load import ingest_partition

        resp = self._fill(msg.BulkLoadIngestResponse(), decree)
        try:
            stats = ingest_partition(self.engine, req.provider_root,
                                     req.app_name, req.partition_count,
                                     self.pidx, self._schema)
            resp.ingested_records = stats["records"]
        except (OSError, ValueError) as e:
            resp.error = Status.IO_ERROR
            print(f"[bulk_load] ingest failed: {e!r}")
        self.empty_put(decree)  # the decree itself still advances
        return resp

    def duplicate(self, decree: int, req: msg.DuplicateRequest, now: int = None):
        """Apply a mutation shipped from another cluster (the remote side of
        pegasus_mutation_duplicator). verify_timetag resolves write-write
        conflicts last-writer-wins with cluster-id tiebreak (value schema v1
        timetag, reference pegasus_write_service::duplicate +
        rocksdb_wrapper's verify_timetag get)."""
        resp = self._fill(msg.DuplicateResponse(), decree)
        inner_cls = _DUP_INNER.get(req.task_code)
        if inner_cls is None:
            resp.error = Status.INVALID_ARGUMENT
            resp.error_hint = f"non-duplicable task code {req.task_code}"
            self.empty_put(decree)
            return resp
        inner = codec.decode(inner_cls, req.raw_message)
        if req.verify_timetag and self._schema.VERSION >= 1 \
                and hasattr(inner, "key"):
            incoming = generate_timetag(req.timestamp, req.cluster_id,
                                        req.task_code == task_codes.RPC_REMOVE)
            raw = self.engine.get(inner.key, now=epoch_now() if now is None else now)
            if raw is not None and self._schema.extract_timetag(raw) > incoming:
                # local version is newer: drop the stale duplicate
                self.empty_put(decree)
                resp.error_hint = "ignored stale duplicate"
                return resp
        # apply with the ORIGIN timestamp so timetags carry provenance
        if req.task_code == task_codes.RPC_PUT:
            value = self._encode_with_origin(inner.value, inner.expire_ts_seconds,
                                             req.timestamp, req.cluster_id, False)
            self._engine_write(WriteBatch().put(inner.key, value,
                                                inner.expire_ts_seconds),
                               decree)
        elif req.task_code == task_codes.RPC_REMOVE:
            self._engine_write(WriteBatch().delete(inner.key), decree)
        elif req.task_code == task_codes.RPC_MULTI_PUT:
            batch = WriteBatch()
            for kv in inner.kvs:
                key = key_schema.generate_key(inner.hash_key, kv.key)
                value = self._encode_with_origin(kv.value, inner.expire_ts_seconds,
                                                 req.timestamp, req.cluster_id,
                                                 False)
                batch.put(key, value, inner.expire_ts_seconds)
            self._engine_write(batch, decree)
        elif req.task_code == task_codes.RPC_MULTI_REMOVE:
            batch = WriteBatch()
            for sk in inner.sort_keys:
                batch.delete(key_schema.generate_key(inner.hash_key, sk))
            self._engine_write(batch, decree)
        else:
            # read-modify-write codes re-run locally (incr/CAS duplicate as
            # their effect is deterministic given the shipped arguments)
            handler = {task_codes.RPC_INCR: self.incr,
                       task_codes.RPC_CHECK_AND_SET: self.check_and_set,
                       task_codes.RPC_CHECK_AND_MUTATE: self.check_and_mutate}
            handler[req.task_code](decree, inner, now=now)
        return resp

    def trigger_audit(self, decree: int, req: msg.TriggerAuditRequest):
        """Decree-anchored consistency digest: this mutation is a no-op
        for data (it only advances the decree), but because it rides the
        apply path, every replica executes it with exactly the decrees <
        `decree` applied and nothing after, so the digest each computes is
        anchored at the same point of the mutation stream
        (engine.state_digest: a commutative per-record combine over the
        recency-merged logical contents). The fold is O(live records) and
        runs in the apply path: the partition's writes wait for it.
        `audit.digest_us` records what each one cost.

        The `audit.digest` fail point corrupts THIS replica's digest when
        armed as return(<node>) or return(<node>@<app_id>.<pidx>) (node ""
        matches every replica): a silent divergence for the doctor's and
        the audit's tests, with the data untouched."""
        resp = self._fill(msg.TriggerAuditResponse(), decree)
        self.empty_put(decree)  # the decree itself advances like any write
        t0 = time.perf_counter()
        try:
            # the auditor-chosen ownership mask rides the mutation
            dig = self.engine.state_digest(now=req.now or None,
                                           pmask=req.pmask or None)
        except Exception as e:  # noqa: BLE001 - an audit must never wedge
            # the apply path; a digest failure reports as inconclusive
            resp.error = Status.IO_ERROR
            resp.server = f"{self.server} (digest failed: {e!r})"
            self.last_audit = {"audit_id": req.audit_id, "decree": decree,
                               "digest": "", "error": repr(e),
                               "ts": time.time()}
            return resp
        digest = dig["digest"]
        fp = fail_point("audit.digest")
        if fp is not None and fp[0] == "return":
            node, _, gpid = fp[1].partition("@")
            if (not node or node == self.server) and \
                    (not gpid or gpid == f"{self.app_id}.{self.pidx}"):
                digest = "deadbeef" + digest[8:]
        counters.rate("audit.trigger_count").increment()
        counters.percentile("audit.digest_us").set(
            int((time.perf_counter() - t0) * 1e6))
        events.emit("audit.applied", gpid=f"{self.app_id}.{self.pidx}",
                    decree=decree, node=self.server)
        self.last_audit = {"audit_id": req.audit_id, "decree": decree,
                           "digest": digest, "records": dig["records"],
                           "now": dig["now"], "ts": time.time()}
        resp.decree = decree
        resp.digest = digest
        resp.records = dig["records"]
        return resp

    def _encode_with_origin(self, user_data, expire_ts, timestamp_us,
                            cluster_id, deleted) -> bytes:
        timetag = 0
        if self._schema.VERSION >= 1:
            timetag = generate_timetag(timestamp_us, cluster_id, deleted)
        return self._schema.generate_value(expire_ts, timetag, user_data)

    # ------------------------------------------------- batched put/remove

    def apply_batched_window(self, entries):
        """Apply a contiguous committed decree window of BATCHABLE
        mutations — `entries` is [(decree, timestamp_us, [(code, req)])]
        — in ONE engine call (engine.write_batch: one lock acquisition
        for the whole window) instead of k. -> {decree: response list}."""
        pairs, resps = [], {}
        for decree, timestamp_us, reqs in entries:
            wb = WriteBatch()
            rl = []
            for code, req in reqs:
                if code == task_codes.RPC_PUT:
                    value = self._encode(req.value, req.expire_ts_seconds,
                                         timestamp_us)
                    wb.put(req.key, value, req.expire_ts_seconds)
                else:
                    wb.delete(req.key)
                rl.append(self._fill(msg.UpdateResponse(), decree))
            pairs.append((wb, decree))
            resps[decree] = rl
        with REQUEST_TRACER.span("engine.write", decree=entries[-1][0],
                                 records=sum(len(e[2]) for e in entries)):
            self.engine.write_batch(pairs)
        return resps

    def batch_prepare(self):
        self._batch = WriteBatch()

    def batch_put(self, req: msg.UpdateRequest, timestamp_us: int = 0):
        value = self._encode(req.value, req.expire_ts_seconds, timestamp_us)
        self._batch.put(req.key, value, req.expire_ts_seconds)

    def batch_remove(self, key: bytes):
        self._batch.delete(key)

    def batch_commit(self, decree: int):
        batch, self._batch = self._batch, None
        self._engine_write(batch, decree)
        return Status.OK

    def batch_abort(self):
        self._batch = None

    # ----------------------------------------------------------- checks

    @staticmethod
    def _check_type_supported(check_type: int) -> bool:
        return CasCheckType.NO_CHECK <= check_type <= CasCheckType.VALUE_INT_GREATER

    @staticmethod
    def _validate_check(check_type: int, operand: bytes, exist: bool, value: bytes):
        """-> (passed, invalid_argument); the 17-variant matrix of
        src/server/pegasus_write_service_impl.h:570-663."""
        ct = check_type
        if ct == CasCheckType.NO_CHECK:
            return True, False
        if ct == CasCheckType.VALUE_NOT_EXIST:
            return not exist, False
        if ct == CasCheckType.VALUE_NOT_EXIST_OR_EMPTY:
            return (not exist) or len(value) == 0, False
        if ct == CasCheckType.VALUE_EXIST:
            return exist, False
        if ct == CasCheckType.VALUE_NOT_EMPTY:
            return exist and len(value) != 0, False
        if ct in (CasCheckType.VALUE_MATCH_ANYWHERE, CasCheckType.VALUE_MATCH_PREFIX,
                  CasCheckType.VALUE_MATCH_POSTFIX):
            if not exist:
                return False, False
            if len(operand) == 0:
                return True, False
            if len(value) < len(operand):
                return False, False
            if ct == CasCheckType.VALUE_MATCH_ANYWHERE:
                return operand in value, False
            if ct == CasCheckType.VALUE_MATCH_PREFIX:
                return value.startswith(operand), False
            return value.endswith(operand), False
        if CasCheckType.VALUE_BYTES_LESS <= ct <= CasCheckType.VALUE_BYTES_GREATER:
            if not exist:
                return False, False
            if value < operand:
                return ct <= CasCheckType.VALUE_BYTES_LESS_OR_EQUAL, False
            if value == operand:
                return (CasCheckType.VALUE_BYTES_LESS_OR_EQUAL <= ct
                        <= CasCheckType.VALUE_BYTES_GREATER_OR_EQUAL), False
            return ct >= CasCheckType.VALUE_BYTES_GREATER_OR_EQUAL, False
        if CasCheckType.VALUE_INT_LESS <= ct <= CasCheckType.VALUE_INT_GREATER:
            if not exist:
                return False, False
            v = buf2int64(value)
            if v is None:
                return False, True
            o = buf2int64(operand)
            if o is None:
                return False, True
            if v < o:
                return ct <= CasCheckType.VALUE_INT_LESS_OR_EQUAL, False
            if v == o:
                return (CasCheckType.VALUE_INT_LESS_OR_EQUAL <= ct
                        <= CasCheckType.VALUE_INT_GREATER_OR_EQUAL), False
            return ct >= CasCheckType.VALUE_INT_GREATER_OR_EQUAL, False
        return False, False
