"""Cross-cluster duplication: ship committed mutations to a remote cluster.

Port of pegasus_tpu/replication/duplicator.py (pegasus_mutation_duplicator
and the rDSN duplication framework; reference
src/server/pegasus_mutation_duplicator.{h,cpp}): a hook on the replica's
commit path enqueues every mutation; a shipper thread replays them to the
remote cluster as RPC_RRDB_RRDB_DUPLICATE writes carrying the origin
timestamp and cluster id. The remote applies them through its own PacificA
(so duplicates are replicated there too), with last-writer-wins conflict
resolution on the value schema's timetag (verify_timetag). Shipping is in
order overall, which subsumes the reference's per-hash FIFO guarantee.
The frames are byte-identical to the reference's, so either package's
shipper feeds either package's cluster.

One difference from the reference: a shipper stopped in the middle of a
retry confirms nothing after the decree it was retrying. The reference
went on through the rest of its batch, and a later mutation with nothing
to ship (a bulk-load ingest) advanced the confirmed decree past the
undelivered one, which its persisted progress then skipped for good.

A second: catch_up refuses a log that does not reach back to the confirmed
decree (DuplicationGap). The reference shipped what the log still held and
moved its confirmed decree past the missing window; in the reference a
relearned replica's log begins at its checkpoint, so promoting it did
exactly that (the port's learn keeps the log back to the duplication
floor, Replica.fetch_learn_tail).
"""

import json
import os
import threading
import time

from ..base import key_schema
from ..engine.replica_service import WRITE_CODES
from ..rpc import codec
from ..rpc import messages as msg
from ..rpc.task_codes import RPC_DUPLICATE
from ..rpc.transport import ConnectionPool, RpcError
from ..runtime.job_trace import JOB_TRACER
from ..runtime.tasking import spawn_thread
from .mutation_log import LogMutation


class DuplicationGap(RuntimeError):
    """The replica's log no longer holds decrees the duplication has not
    confirmed: shipping on would skip them at the remote for good."""


class MutationDuplicator:
    """Attach with `replica.commit_hooks.append(dup.on_commit)`."""

    def __init__(self, remote_resolver, cluster_id: int = 1,
                 fail_mode: str = "slow", dupid: int = 0,
                 progress_dir: str = None, confirmed_floor: int = 0,
                 paused: bool = False):
        """remote_resolver: a client resolver for the remote table;
        fail_mode: 'slow' blocks and retries (the default), 'skip' drops
        on error (the reference's dup fail-mode knob); progress_dir: where
        the confirmed decree persists; confirmed_floor: the meta-held
        confirmed decree of this partition (beacon-reported, so it
        survives a failover as the reference's duplication_info.progress
        does): shipping starts past max(local, floor). Create with
        paused=True and unpause only after catch_up(), or a live hook
        mutation could ship first and advance the confirmed decree past
        the unshipped backlog, which would then be skipped for good."""
        self.resolver = remote_resolver
        self.cluster_id = cluster_id
        self.fail_mode = fail_mode
        self.dupid = dupid
        self.pool = ConnectionPool()
        self._queue = []
        self._cv = threading.Condition()
        self._stop = False
        self._paused = paused
        self._inflight = False
        self.shipped = 0
        self.skipped = 0
        self._progress_path = (os.path.join(progress_dir, f"dup_{dupid}.json")
                               if progress_dir else None)
        self.last_shipped_decree = max(self._load_progress(), confirmed_floor)
        self._saved_decree = self.last_shipped_decree
        self._saved_at = 0.0
        # one long-lived traced job per duplicator: each shipped window
        # notes a hop, stop() closes it (the ship cadence between this
        # cluster and the remote)
        self._trace_job = JOB_TRACER.begin("duplicate", dupid=dupid,
                                           cluster=cluster_id)
        self._thread = spawn_thread(self._ship_loop, daemon=True,
                                    name=f"dup:{dupid}")

    # ------------------------------------------------------------- progress

    def _load_progress(self) -> int:
        if self._progress_path and os.path.exists(self._progress_path):
            try:
                with open(self._progress_path) as f:
                    return int(json.load(f)["confirmed_decree"])
            except (OSError, ValueError, KeyError):
                pass
        return 0

    _SAVE_EVERY_DECREES = 64
    _SAVE_EVERY_SECONDS = 1.0

    def _save_progress(self, force: bool = False) -> None:
        """Batched persistence: the file is a restart hint (catch_up and
        the meta's confirmed floor cover a stale value; shipping is at
        least once), so a write and rename per decree buys nothing."""
        if not self._progress_path:
            return
        if not force:
            due = (self.last_shipped_decree - self._saved_decree
                   >= self._SAVE_EVERY_DECREES
                   or time.monotonic() - self._saved_at
                   >= self._SAVE_EVERY_SECONDS)
            if not due:
                return
        tmp = self._progress_path + ".tmp"
        os.makedirs(os.path.dirname(self._progress_path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"dupid": self.dupid,
                       "confirmed_decree": self.last_shipped_decree}, f)
        os.replace(tmp, self._progress_path)
        self._saved_decree = self.last_shipped_decree
        self._saved_at = time.monotonic()

    def catch_up(self, plog, committed: int) -> int:
        """Backfill the ship queue from the log past the confirmed decree:
        how a fresh duplicator (dup add, restart, failover promotion)
        ships history it never saw through the commit hook. Overlap with
        live hook traffic resolves at the remote by the timetag's
        last-writer-wins. Past a confirmed decree (> 0) the log must hold
        its successor, or, empty past it, nothing may be committed there
        (`committed`, the replica's committed decree): else DuplicationGap
        and nothing is queued. A dup with nothing confirmed yet ships
        what the log holds (the older state is the bootstrap's).
        -> the number backfilled."""
        backlog = list(plog.replay(self.last_shipped_decree))
        need = self.last_shipped_decree + 1
        first = backlog[0].decree if backlog else None
        if need > 1 and (first > need if backlog else committed >= need):
            raise DuplicationGap(
                f"dup {self.dupid}: the log holds no decree from {need} "
                f"(first held: {first}, committed: {committed})")
        with self._cv:
            self._queue[:0] = backlog
            self._cv.notify()
        return len(backlog)

    # ----------------------------------------------------------------- hook

    def on_commit(self, m: LogMutation) -> None:
        with self._cv:
            self._queue.append(m)
            self._cv.notify()

    def set_paused(self, paused: bool) -> None:
        """Pause = stop shipping but keep queueing (the backlog survives;
        the log and the persisted progress cover a restart while
        paused)."""
        with self._cv:
            self._paused = paused
            self._cv.notify()

    # ----------------------------------------------------------------- ship

    _SHIP_BATCH = 32   # queued mutations shipped per pipelined wave

    def _ship_loop(self):
        while True:
            with self._cv:
                self._inflight = False
                self._cv.notify_all()
                while (not self._queue or self._paused) and not self._stop:
                    self._cv.wait(0.2)
                if self._stop and (not self._queue or self._paused):
                    return
                batch = self._queue[:self._SHIP_BATCH]
                del self._queue[:len(batch)]
                self._inflight = True
            # a backlog (catch-up, a paused burst, a slow remote) ships as
            # one pipelined wave per (node, partition); any failure falls
            # back to the per-mutation retry/skip policy below (shipping
            # is at least once; the remote's timetag resolves overlap)
            shipped_batch = False
            if len(batch) > 1:
                try:
                    shipped_batch = self._ship_window(batch)
                except Exception:  # noqa: BLE001 - the wave failed: retry singly
                    shipped_batch = False
            if shipped_batch:
                self._save_progress()
                continue
            for m in batch:
                try:
                    if not self._ship_one(m):
                        return  # stopped mid-retry: confirm nothing later
                    self._save_progress()
                except Exception as e:  # never let the shipper thread die
                    self.skipped += 1
                    print(f"[duplicator] dropped decree {m.decree}: {e!r}",
                          flush=True)

    def _ship_window(self, ms) -> bool:
        """Ship a window of mutations as batched per-partition waves.
        -> True only when every request landed (the window's decrees are
        then confirmed in order). Per-partition request order is kept."""
        groups = {}   # (addr, pidx) -> ordered call list
        n_skipped = 0  # counted once the whole window lands (a failed
        # wave reruns through _ship_one, which counts for itself)
        for m in ms:
            if m.decree <= self.last_shipped_decree:
                continue
            for code, body in zip(m.codes, m.bodies):
                if code == RPC_DUPLICATE:
                    continue   # never re-duplicate a duplicate (loop guard)
                try:
                    key = _routing_key(code, body)
                except (ValueError, KeyError):
                    n_skipped += 1   # not duplicable (a bulk-load ingest)
                    continue
                req = msg.DuplicateRequest(
                    timestamp=m.timestamp_us, task_code=code,
                    raw_message=body, cluster_id=self.cluster_id,
                    verify_timetag=True)
                h = key_schema.key_hash(key)
                pidx = h % self.resolver.partition_count
                addr = tuple(self.resolver.resolve(pidx))
                groups.setdefault((addr, pidx), []).append(
                    (RPC_DUPLICATE, codec.encode(req),
                     self.resolver.app_id, pidx, h))
        pends = []
        for (addr, pidx), calls in groups.items():
            conn = self.pool.get(addr, shard=pidx)
            pends.append((conn, calls, conn.call_many_send(calls)))
        n = 0
        for conn, calls, handle in pends:
            conn.call_many_collect(handle, calls, 10.0)
            n += len(calls)
        self.shipped += n
        self.skipped += n_skipped
        self.last_shipped_decree = max(self.last_shipped_decree,
                                       ms[-1].decree)
        JOB_TRACER.note("dup.ship_window", job_id=self._trace_job,
                        requests=n, skipped=n_skipped,
                        decree=self.last_shipped_decree)
        return True

    def _ship_one(self, m: LogMutation) -> bool:
        """-> True when the decree is confirmed (shipped, or skipped by
        policy). A stop() during the retries returns False: the decree
        was not delivered and must not be recorded as confirmed."""
        if m.decree <= self.last_shipped_decree:
            return True  # catch_up and live-hook overlap: confirmed already
        for code, body in zip(m.codes, m.bodies):
            if code == RPC_DUPLICATE:
                continue  # never re-duplicate a duplicate (loop guard)
            try:
                key = _routing_key(code, body)
            except (ValueError, KeyError):
                # not duplicable (a bulk-load ingest has no routing key;
                # each cluster loads its own sets)
                self.skipped += 1
                continue
            req = msg.DuplicateRequest(
                timestamp=m.timestamp_us, task_code=code, raw_message=body,
                cluster_id=self.cluster_id, verify_timetag=True)
            attempts = 0
            while True:
                if self._stop:
                    return False  # interrupted mid-retry: not confirmed
                try:
                    self._send(req, key, refresh=attempts > 0)
                    self.shipped += 1
                    break
                except (RpcError, OSError):
                    attempts += 1
                    if self.fail_mode == "skip":
                        self.skipped += 1
                        break
                    # fail_mode 'slow': keep the backlog, retry with
                    # backoff (the reference's dup_fail_mode=slow)
                    time.sleep(min(2.0, 0.05 * attempts))
        self.last_shipped_decree = max(self.last_shipped_decree, m.decree)
        return True

    def _send(self, req: msg.DuplicateRequest, key: bytes,
              refresh: bool = False) -> None:
        if refresh:
            self.resolver.refresh()
        h = key_schema.key_hash(key)
        pidx = h % self.resolver.partition_count
        addr = self.resolver.resolve(pidx)
        try:
            conn = self.pool.get(addr)
            conn.call(RPC_DUPLICATE, codec.encode(req),
                      app_id=self.resolver.app_id, partition_index=pidx,
                      partition_hash=h, timeout=10.0)
        except (RpcError, OSError):
            self.pool.invalidate(addr)
            raise

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until the backlog drained and the in-flight window (if
        any) finished shipping."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._cv:
                if not self._queue and not self._inflight:
                    return True
            time.sleep(0.01)
        return False

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)
        try:
            self._save_progress(force=True)
        except OSError:
            pass
        self.pool.close()
        JOB_TRACER.finish(self._trace_job, shipped=self.shipped,
                          skipped=self.skipped,
                          decree=self.last_shipped_decree)


def _routing_key(code: str, body: bytes) -> bytes:
    """The hash-carrying key of a mutation (the reference's
    get_hash_from_request, pegasus_mutation_duplicator.cpp)."""
    req_cls, _ = WRITE_CODES[code]
    req = codec.decode(req_cls, body)
    if hasattr(req, "key"):
        return req.key
    if hasattr(req, "hash_key"):
        return key_schema.generate_key(req.hash_key, b"")
    raise ValueError(f"cannot route duplicate of {code}")
