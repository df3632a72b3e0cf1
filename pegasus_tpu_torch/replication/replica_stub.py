"""Replica node: hosts PacificA replicas, beacons to meta, serves clients.

Port of the core of pegasus_tpu/replication/replica_stub.py (the rDSN
replica_stub role): one process is one node address; the meta server
opens and closes replicas here (RPC_CONFIG_PROPOSAL_*), client writes
route through the local replica's PacificA 2PC (Replica.client_write,
wired in through ReplicaService.set_write_router), prepares arrive from
peer nodes over RPC (RPC_PREPARE), learners pull checkpoint and log-tail
state over the block-shipped learn (RPC_LEARN_*), and a beacon thread
keeps the meta lease. Every message is byte-identical to the
reference's, so port and reference nodes replicate one partition
together.

The engines default to the cuda backend on the card (EngineOptions()):
every replica's merges and device reads run there, and a failure raises.

The table lifecycle is served as the reference serves it: split
seeding (an open that learns from another partition, once only and
before the child serves), restore at open from a backup through the
block service (runtime/block_service.py), RPC_COLD_BACKUP and
RPC_BULK_LOAD.

The compaction scheduler's delivery surface: `compact-sched-policy`
installs its policy tokens, placements and the node's device-compaction
cap; `compact-sched-status` reads them back with each replica's debt;
the maintenance loop pokes at most one held L0 trigger per tick.

The collector's hotkey loop reaches a partition through
`detect_hotkey` (the server's hotkey collector) and pins a read-hot
partition's runs on the card with `set-read-residency`.

The integrity plane: every engine's corruption hook, the maintenance
loop's background scrub (one replica per tick past its cadence), and
the `scrub-replica`, `quarantine-replica` and `quarantine-status`
commands. A finding quarantines the replica: it leaves the serving path,
its engine closes (on a cuda node that frees its device-resident runs,
and the `engine.hbm.*` gauges stop counting them), its data dir moves
into a bounded forensics dir, and its beacon reports QUARANTINED until
the meta's `repair_quarantined` re-seeds it. Knobs:
PEGASUS_SCRUB_INTERVAL_S (300; 0 turns the background scrub off),
PEGASUS_SCRUB_BPS (0: unthrottled) and PEGASUS_QUARANTINE_KEEP (4).

Duplication: `remote_clusters` (the [pegasus.clusters] section) names
each remote cluster's metas; on every view or env install
_sync_duplications reconciles the replica's shippers with the dup
entries the meta mirrors into the reserved app env. Only a primary
ships; a promoted one builds its shippers at the meta's confirmed decree
and catches them up from its own log. The beacon reports each shipper's
confirmed decree (`dup_progress`) and refreshes its `dup.lag.*` gauge.

Not ported yet (ROADMAP Queue 1): partition groups (a group_spec raises,
naming the module; the socket adoption loop, and with it the scheduler's
per-group split of the device cap).
"""

import json
import os
import threading
import time

from ..base import consts
from ..client import MetaResolver
from ..engine.db import EngineOptions
from ..engine.replica_service import ReplicaService
from ..meta import messages as mm
from ..meta.meta_server import (RPC_BULK_LOAD, RPC_CLOSE_REPLICA,
                                RPC_COLD_BACKUP, RPC_FD_BEACON,
                                RPC_OPEN_REPLICA, RPC_QUERY_REPLICA_INFO,
                                RPC_REPLICA_STATE)
from ..rpc import codec
from ..rpc import messages as rpc_msg
from ..rpc.transport import (ConnectionPool, ERR_INVALID_STATE,
                             ERR_OBJECT_NOT_FOUND, RpcError, RpcServer)
from ..runtime import events
from ..runtime.job_trace import JOB_TRACER
from ..runtime.metric_history import HISTORY
from ..runtime.perf_counters import counters
from ..runtime.remote_command import RemoteCommandService
from ..runtime.table_stats import TABLE_STATS
from ..runtime.tasking import spawn_thread
from .duplicator import DuplicationGap, MutationDuplicator
from .mutation_log import LogMutation
from .replica import GroupView, PRIMARY, PrepareRejected, Replica, ReplicaError

RPC_PREPARE = "RPC_PREPARE"
RPC_LEARN = "RPC_LEARN"
# block-shipped learn plane: manifest-diff handshake, chunked pinned-block
# fetch, log-tail pull, pin release
RPC_LEARN_PREPARE = "RPC_LEARN_PREPARE"
RPC_LEARN_FETCH = "RPC_LEARN_FETCH"
RPC_LEARN_TAIL = "RPC_LEARN_TAIL"
RPC_LEARN_FINISH = "RPC_LEARN_FINISH"
RPC_REMOTE_COMMAND = "RPC_CLI_CLI_CALL"


class _RemotePeer:
    """Peer-node proxy with the Replica peer interface (on_prepare,
    fetch_learn_state, the streamed learn) over the RPC transport."""

    def __init__(self, stub: "ReplicaStub", addr: str, app_id: int, pidx: int):
        self.stub = stub
        self.addr = addr
        self.app_id = app_id
        self.pidx = pidx
        self._learn_src = None

    def _conn(self):
        host, _, port = self.addr.rpartition(":")
        # one sharded connection per (peer, partition), as the reference
        return self.stub.pool.get((host, int(port)),
                                  shard=("rep", self.app_id, self.pidx))

    def _call(self, code, req):
        try:
            _, body = self._conn().call(code, codec.encode(req),
                                        app_id=self.app_id,
                                        partition_index=self.pidx,
                                        timeout=10.0)
            return body
        except (RpcError, OSError) as e:
            raise ConnectionError(str(e))

    def on_prepare(self, ballot, m: LogMutation, committed_decree: int):
        body = self._call(RPC_PREPARE, mm.PrepareRequest(
            app_id=self.app_id, pidx=self.pidx, ballot=ballot,
            committed_decree=committed_decree, mutation=codec.encode(m)))
        resp = codec.decode(mm.PrepareResponse, body)
        if resp.error:
            raise PrepareRejected(resp.reason, resp.last_prepared)

    def on_prepare_batch(self, ballot, ms, committed_decree: int) -> int:
        """Windowed prepare: the whole decree window rides one RPC; the
        peer acks its highest contiguous prepared decree."""
        body = self._call(RPC_PREPARE, mm.PrepareRequest(
            app_id=self.app_id, pidx=self.pidx, ballot=ballot,
            committed_decree=committed_decree,
            mutations=[codec.encode(m) for m in ms]))
        resp = codec.decode(mm.PrepareResponse, body)
        if resp.error:
            raise PrepareRejected(resp.reason, resp.last_prepared)
        return resp.last_prepared

    def on_prepare_windows(self, ballot, windows, committed_decree: int) -> int:
        """Catch-up path: every window of the backlog leaves in one
        coalesced send (call_many), the responses are collected in order.
        -> the peer's final acked decree."""
        reqs = [(RPC_PREPARE, codec.encode(mm.PrepareRequest(
            app_id=self.app_id, pidx=self.pidx, ballot=ballot,
            committed_decree=committed_decree,
            mutations=[codec.encode(m) for m in w])),
            self.app_id, self.pidx, 0) for w in windows]
        try:
            results = self._conn().call_many(reqs, timeout=10.0)
        except (RpcError, OSError) as e:
            raise ConnectionError(str(e))
        last = 0
        for _, body in results:
            resp = codec.decode(mm.PrepareResponse, body)
            if resp.error:
                raise PrepareRejected(resp.reason, resp.last_prepared)
            last = resp.last_prepared
        return last

    def fetch_learn_state(self) -> dict:
        body = self._call(RPC_LEARN, mm.LearnRequest(self.app_id, self.pidx))
        resp = codec.decode(mm.LearnResponse, body)
        if resp.error:
            raise ConnectionError("learn failed")
        return {
            "files": [(f.name, f.data) for f in resp.files],
            "tail": [codec.decode(LogMutation, t) for t in resp.tail],
            "last_committed": resp.last_committed,
            "ballot": resp.ballot,
        }

    # the streamed learn, through the one RPC client of the learn protocol
    def _learn_source(self):
        if self._learn_src is None:
            from .learn import RemoteLearnSource

            self._learn_src = RemoteLearnSource(
                self.stub.pool, self.addr, self.app_id, self.pidx)
        return self._learn_src

    def prepare_learn_state(self, have=None, delta=None) -> dict:
        return self._learn_source().prepare_learn_state(have, delta)

    def fetch_learn_chunks(self, learn_id, reqs) -> list:
        return self._learn_source().fetch_learn_chunks(learn_id, reqs)

    def fetch_learn_tail(self, learn_id) -> dict:
        return self._learn_source().fetch_learn_tail(learn_id)

    def finish_learn(self, learn_id) -> None:
        self._learn_source().finish_learn(learn_id)


class ReplicaStub:
    def __init__(self, root: str, meta_addrs, host: str = "127.0.0.1",
                 port: int = 0, options_factory=None, cluster_id: int = 1,
                 block_service_provider: str = "local_service",
                 group_spec=None, remote_clusters: dict = None):
        if group_spec is not None:
            raise NotImplementedError(
                "group_spec: partition groups (replication/serve_groups.py) "
                "are not ported to pegasus_tpu_torch yet")
        self.root = root
        self.block_service_provider = block_service_provider
        self.meta_addrs = list(meta_addrs)
        self.cluster_id = cluster_id
        # [pegasus.clusters]: remote cluster name -> meta address list, the
        # duplication targets (dup entries name clusters, this resolves them)
        self.remote_clusters = {k: (v if isinstance(v, list) else [v])
                                for k, v in (remote_clusters or {}).items()}
        # the card unless the caller asks otherwise (the reference's stub
        # defaults to the cpu backend)
        self.options_factory = options_factory or EngineOptions
        self.pool = ConnectionPool()
        self._lock = threading.RLock()
        self._replicas = {}      #: guarded_by self._lock
        # the integrity plane: partitions pulled off the serving path
        # after a corruption hit; gpid "a.p" -> forensics record, reported
        # in beacons (status QUARANTINED) until a re-open clears it
        self._quarantined = {}   #: guarded_by self._lock
        # gpids with an async read-path quarantine already in flight
        self._quarantining = set()  #: guarded_by self._lock
        # (app_id, pidx) -> monotonic ts of the last background scrub
        self._last_scrub = {}    #: guarded_by self._lock
        self._scrub_interval = float(
            os.environ.get("PEGASUS_SCRUB_INTERVAL_S", "300"))
        self._scrub_bps = float(os.environ.get("PEGASUS_SCRUB_BPS", "0"))
        self._quarantine_keep = int(
            os.environ.get("PEGASUS_QUARANTINE_KEEP", "4"))
        self._service = ReplicaService()
        self._service.set_write_router(self._route_write)
        self.rpc = RpcServer(host, port)
        self.rpc.register_serverlet(self._service)
        self.rpc.register(RPC_OPEN_REPLICA, self._on_open_replica)
        self.rpc.register(RPC_CLOSE_REPLICA, self._on_close_replica)
        self.rpc.register(RPC_REPLICA_STATE, self._on_replica_state)
        self.rpc.register(RPC_QUERY_REPLICA_INFO, self._on_query_replica_info)
        self.rpc.register(RPC_COLD_BACKUP, self._on_cold_backup)
        self.rpc.register(RPC_BULK_LOAD, self._on_bulk_load)
        self.rpc.register(RPC_PREPARE, self._on_prepare)
        self.rpc.register(RPC_LEARN, self._on_learn)
        self.rpc.register(RPC_LEARN_PREPARE, self._on_learn_prepare)
        self.rpc.register(RPC_LEARN_FETCH, self._on_learn_fetch)
        self.rpc.register(RPC_LEARN_TAIL, self._on_learn_tail)
        self.rpc.register(RPC_LEARN_FINISH, self._on_learn_finish)
        self.commands = RemoteCommandService()
        self.commands.register_defaults(node_kind="replica",
                                        describe=self._describe)
        self.commands.register("manual-compact", self._cmd_manual_compact)
        self.commands.register("batched-manual-compact",
                               self._cmd_batched_manual_compact)
        self.commands.register("replica-disk", self._cmd_replica_disk)
        self.commands.register("query-compact-state", self._cmd_compact_state)
        self.commands.register("detect_hotkey", self._cmd_detect_hotkey)
        self.commands.register("set-read-residency",
                               self._cmd_set_read_residency)
        self.commands.register("flush-log", self._cmd_flush_log)
        self.commands.register("flush-memtable", self._cmd_flush_memtable)
        self.commands.register("trigger-audit", self._cmd_trigger_audit)
        self.commands.register("query-audit", self._cmd_query_audit)
        self.commands.register("learn-status", self._cmd_learn_status)
        self.commands.register("compact-sched-policy",
                               self._cmd_compact_sched_policy)
        self.commands.register("compact-sched-status",
                               self._cmd_compact_sched_status)
        self.commands.register("scrub-replica", self._cmd_scrub_replica)
        self.commands.register("quarantine-replica",
                               self._cmd_quarantine_replica)
        self.commands.register("quarantine-status",
                               self._cmd_quarantine_status)
        self.rpc.register(RPC_REMOTE_COMMAND, self.commands.rpc_handler)
        self.rpc.start()
        self.address = f"{self.rpc.address[0]}:{self.rpc.address[1]}"
        self._stop = threading.Event()
        self._beacon_threads = {}  # meta addr -> in-flight ping thread
        self._beacon_thread = spawn_thread(
            self._beacon_loop, daemon=True, start=False,
            name=f"beacon:{self.address}")
        self._maint_thread = spawn_thread(
            self._maintenance_loop, daemon=True, start=False,
            name=f"maintenance:{self.address}")
        self._catch_up_thread = spawn_thread(
            self._catch_up_loop, daemon=True, start=False,
            name=f"catch-up:{self.address}")

    def start(self, beacon_interval: float = 1.0,
              maintenance_interval: float = 60.0) -> "ReplicaStub":
        self._beacon_interval = beacon_interval
        self._maint_interval = maintenance_interval
        self.send_beacon()
        self._beacon_thread.start()
        self._maint_thread.start()
        self._catch_up_thread.start()
        # every serving process samples its counter registry into the
        # history ring (a refcounted process-wide sampler)
        HISTORY.start()
        return self

    # ------------------------------------------------------- maintenance

    def _maintenance_loop(self):
        """Per-replica timers (the reference's replica-level checkpoint
        timer and manual-compact trigger checks): periodic async
        checkpoint, plog GC behind the durable decree, env-driven
        periodic manual compaction, the idle retry of a held L0 trigger,
        then the background scrub."""
        while not self._stop.wait(self._maint_interval):
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                try:
                    rep.server.engine.async_checkpoint()
                    rep.gc_log()
                    rep.server.manual_compact_service \
                        .start_manual_compact_if_needed(rep.server.app_envs)
                except Exception as e:  # keep the timer alive
                    print(f"[maintenance] {rep.name}: {e!r}", flush=True)
            # debt a lapsed defer token or a freed device gate left above
            # the trigger compacts without waiting for the next flush;
            # after the light per-replica work, and at most ONE compaction
            # per tick, so one merge never stalls every sibling's timers
            for rep in reps:
                try:
                    if rep.server.engine.poke_compaction():
                        break
                except Exception as e:
                    print(f"[maintenance] {rep.name}: {e!r}", flush=True)
            # re-verify on-disk checksums off the serving path, one
            # replica per tick past its cadence (rate-limited inside
            # engine.scrub)
            try:
                self._scrub_tick(reps)
            except Exception as e:
                print(f"[maintenance] scrub: {e!r}", flush=True)

    # ------------------------------------------------------------- beacons

    def _beacon_fragment_locked(self):  #: requires self._lock
        """-> (alive gpids, dup progress, per-replica state JSONs): the
        beacon fields the meta reads."""
        alive = [f"{a}.{p}" for (a, p) in self._replicas]
        progress = []
        states = []
        for (a, p), rep in self._replicas.items():
            # dict() snapshot: _sync_duplications swaps the mapping
            # copy-on-write, so this iteration never sees a resize
            for dupid, d in dict(rep.duplicators).items():
                progress.append(f"{a}.{p}.{dupid}:{d.last_shipped_decree}")
                # the shipper's lag: decrees committed here but not yet
                # confirmed shipped (refreshed every beacon tick)
                counters.number(f"dup.lag.{a}.{p}.{dupid}").set(
                    max(0, rep.last_committed - d.last_shipped_decree))
            st = {"gpid": f"{a}.{p}", "status": rep.status,
                  "ballot": rep.ballot,
                  "committed": rep.last_committed,
                  "applied": rep.server.engine.last_committed_decree(),
                  "prepared": rep.last_prepared,
                  "compact": rep.compact_debt()}
            la = rep.server.last_audit
            if la:
                st["audit"] = {"audit_id": la.get("audit_id", 0),
                               "decree": la.get("decree", 0),
                               "digest": la.get("digest", "")}
            states.append(json.dumps(st))
        # quarantined partitions ride the same list as synthetic entries:
        # the meta's fold sees status QUARANTINED (repair_quarantined) and
        # the doctor names them
        for gpid, q in self._quarantined.items():
            states.append(json.dumps({"gpid": gpid, "status": "QUARANTINED",
                                      "quarantine": q}))
        frag = self._table_stats_fragment_locked()
        if frag is not None:
            states.append(frag)
        return alive, progress, states

    def _table_stats_fragment_locked(self):  #: requires self._lock
        """A beacon entry (JSON) carrying TABLE_STATS.snapshot(), or None
        when no table is wired in this process. The meta diverts status
        TABLE_STATS into its tables-only map (_node_tables), so consumers
        of the replica states never iterate over it. Before the snapshot
        each table's device-resident bytes and its compact jobs' device
        seconds and offload bytes are folded in."""
        if not TABLE_STATS.tables():
            return None
        resident = {}
        for (a, p), rep in self._replicas.items():
            name = TABLE_STATS.table_for_gpid(f"{a}.{p}")
            if name:
                resident[name] = (resident.get(name, 0)
                                  + rep.server.engine.device_resident_bytes())
        for name, nbytes in resident.items():
            TABLE_STATS.ledger(name).set_hbm_resident(nbytes)
        TABLE_STATS.attribute_jobs(JOB_TRACER.window(None))
        return json.dumps({"gpid": f"tables@pid:{os.getpid()}",
                           "status": "TABLE_STATS",
                           "tables": TABLE_STATS.snapshot()})

    def _beacon_loop(self):
        while not self._stop.wait(self._beacon_interval):
            try:
                self.send_beacon()
            except Exception as e:  # a dead beacon thread gets this
                # healthy node declared dead after the grace
                print(f"[beacon] {self.address}: {e!r}", flush=True)

    def _catch_up_loop(self):
        """Each beacon interval, the primaries push the commit point to the
        secondaries a prepare round missed (Replica.catch_up_lagging); a
        thread of its own, so a slow peer never delays a beacon."""
        while not self._stop.wait(self._beacon_interval):
            with self._lock:
                reps = list(self._replicas.values())
            for rep in reps:
                try:
                    rep.catch_up_lagging()
                except Exception as e:  # keep the loop alive
                    print(f"[catch-up] {rep.name}: {e!r}", flush=True)

    def send_beacon(self):
        with self._lock:
            alive, progress, states = self._beacon_fragment_locked()
        body = codec.encode(mm.BeaconRequest(
            node=self.address, alive_replicas=alive, dup_progress=progress,
            replica_states=states))

        # every configured meta: followers absorb beacons too (a warm
        # liveness map makes a takeover instant), concurrently so a
        # black-holed meta cannot eat the grace of the others
        def ping(meta):
            host, _, port = meta.rpartition(":")
            try:
                conn = self.pool.get((host, int(port)))
                conn.call(RPC_FD_BEACON, body, timeout=2.0)
            except (RpcError, OSError):
                pass

        if len(self.meta_addrs) == 1:
            ping(self.meta_addrs[0])
            return
        # at most one in-flight ping per meta
        threads = []
        for m in self.meta_addrs:
            prev = self._beacon_threads.get(m)
            if prev is not None and prev.is_alive():
                continue
            t = spawn_thread(ping, m, daemon=True, start=False,
                             name=f"beacon:{self.address}->{m}")
            self._beacon_threads[m] = t
            threads.append(t)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2.5)

    # ------------------------------------------------- meta-driven lifecycle

    def _on_open_replica(self, header, body) -> bytes:
        req = codec.decode(mm.OpenReplicaRequest, body)
        key = (req.app_id, req.pidx)
        # a CROSS-partition learn is split child seeding (parent history
        # copied once); a same-pidx learn is a repair/failover re-seed
        # from the partition's own authoritative primary
        cross_learn = bool(req.learn_from) and 0 <= req.learn_pidx != req.pidx
        restored = False
        with self._lock:
            rep = self._replicas.get(key)
            if rep is None:
                path = os.path.join(self.root, f"{req.app_id}.{req.pidx}")
                if req.restore_dir and not os.path.exists(
                        os.path.join(path, "data", "MANIFEST")):
                    self._seed_from_restore(path, req.restore_dir)
                    restored = True
                rep = Replica(self.address, path, req.app_id, req.pidx,
                              self.options_factory(),
                              peers=self._peer_factory(req.app_id, req.pidx),
                              cluster_id=self.cluster_id)
                # read-path corruption -> async quarantine; the Replica
                # re-installs the hook on every engine swap (a learn)
                rep.set_corruption_hook(
                    self._corruption_hook(req.app_id, req.pidx))
                self._replicas[key] = rep
                # a re-open after a quarantine is the heal: the meta
                # seeded a fresh dir, and the partition serves again
                self._quarantined.pop(f"{req.app_id}.{req.pidx}", None)
            # Split seeding is ONCE-ONLY and SEED-BEFORE-SERVE:
            #  * once-only: when the meta retries a split whose seeding
            #    failed part-way, a child that did seed and then took
            #    writes must not re-learn from its parent (the parent has
            #    rejected child-half writes since split phase 1, and a
            #    learn replaces the engine wholesale: acked writes would
            #    be lost);
            #  * seed-before-serve: a child pending its seed is registered
            #    only after the learn succeeds, so a child whose learn
            #    fails is never served empty.
            seeded = getattr(rep, "split_seeded", False) \
                or rep.last_committed > 0
            need_seed = cross_learn and not seeded
            if not need_seed:
                # (re-)register: a split changes the count of existing
                # replicas, which drives the misroute rejection
                self._service.add_replica(rep.server, req.partition_count)
        if restored and rep.server.engine.opts.backend == "cuda":
            # the restored runs serve device reads and compactions at once
            # (the reference leaves them to its first flush/compaction)
            rep.server.engine.prime_resident_runs()
        learn_self = (req.learn_from == self.address
                      and (req.learn_pidx < 0 or req.learn_pidx == req.pidx))
        if req.learn_from and not learn_self and (need_seed
                                                  or not cross_learn):
            learn_pidx = req.learn_pidx if req.learn_pidx >= 0 else req.pidx
            if req.learn_from == self.address:
                # in-process parent (split on the same node); a parent in
                # a sibling group executor would be learned over RPC, but
                # partition groups are not ported (the constructor refuses
                # a group_spec)
                with self._lock:
                    peer = self._replicas.get((req.app_id, learn_pidx))
            else:
                peer = _RemotePeer(self, req.learn_from, req.app_id,
                                   learn_pidx)
            if peer is not None:
                if need_seed:
                    events.emit("split.seed_start",
                                gpid=f"{req.app_id}.{req.pidx}",
                                parent=f"{req.app_id}.{learn_pidx}",
                                source=req.learn_from)
                rep.learn_from(peer)
                with self._lock:
                    if cross_learn:
                        # seed complete: a split retry must never learn
                        # this child from its parent again
                        rep.split_seeded = True
                    self._service.remove_replica(req.app_id, req.pidx)
                    self._service.add_replica(rep.server, req.partition_count)
                if need_seed:
                    events.emit("split.seeded",
                                gpid=f"{req.app_id}.{req.pidx}",
                                committed=rep.last_committed)
            elif need_seed:
                # no resolvable seed source: a success reply would let the
                # meta count this child as seeded and spread the GC mask
                # over a hollow, unregistered partition
                raise RpcError(ERR_INVALID_STATE,
                               f"split child {req.app_id}.{req.pidx} cannot "
                               f"seed: parent {req.app_id}.{learn_pidx} not "
                               f"found at {req.learn_from}")
        rep.app_name = req.app_name or rep.app_name
        if rep.app_name:
            rep.server.set_table_name(rep.app_name)
        rep.partition_count = req.partition_count or rep.partition_count
        rep.assume_view(GroupView(req.ballot, req.primary, req.secondaries))
        envs = json.loads(req.envs_json or "{}")
        if envs:
            rep.server.update_app_envs(envs)
        self._sync_duplications(rep)
        return codec.encode(mm.OpenReplicaResponse(
            last_committed=rep.last_committed, last_prepared=rep.last_prepared))

    def _sync_duplications(self, rep) -> None:
        """Reconcile the replica's mutation shippers with the dup entries
        the meta mirrors into the reserved app env. Only the primary
        ships (as the reference's duplication runs on primaries); a
        demoted or removed primary tears its shippers down, a promoted one
        builds them and catches up from its log past the persisted or the
        meta-confirmed decree."""
        try:
            entries = json.loads(
                rep.server.app_envs.get(consts.ENV_DUPLICATION_KEY, "[]"))
        except ValueError:
            entries = []
        is_primary = rep.view is not None and rep.view.primary == rep.name
        want = {}
        if is_primary:
            for e in entries:
                if e.get("status") in ("start", "pause"):
                    want[int(e["dupid"])] = e
        # copy-on-write: the beacon thread and gc_log snapshot the
        # mapping, so reconcile into a copy and swap it in at the end
        dups = dict(rep.duplicators)
        for dupid in list(dups):
            if dupid not in want:
                d = dups.pop(dupid)
                try:
                    rep.commit_hooks.remove(d.on_commit)
                except ValueError:
                    pass
                d.stop()
                counters.remove(f"dup.lag.{rep.app_id}.{rep.pidx}.{dupid}")
        for dupid, e in want.items():
            d = dups.get(dupid)
            if d is None:
                metas = self.remote_clusters.get(e["remote"])
                if not metas:
                    print(f"[dup {dupid}] unknown remote cluster "
                          f"{e['remote']!r} (configure [pegasus.clusters])",
                          flush=True)
                    continue
                try:
                    resolver = MetaResolver(list(metas), rep.app_name)
                except Exception as ex:  # the remote may be down: retried
                    print(f"[dup {dupid}] remote resolve failed: {ex!r}",
                          flush=True)   # on the next view or env install
                    continue
                floor = int(e.get("confirmed", {}).get(str(rep.pidx), 0))
                # born paused: catch_up must order the log's backlog ahead
                # of live hook traffic before anything ships, or a live
                # decree would advance the confirmed point past it
                d = MutationDuplicator(
                    resolver, cluster_id=self.cluster_id,
                    fail_mode=e.get("fail_mode", "slow"), dupid=dupid,
                    progress_dir=os.path.join(rep.path, "dup"),
                    confirmed_floor=floor, paused=True)
                rep.commit_hooks.append(d.on_commit)
                try:
                    d.catch_up(rep.plog, committed=rep.last_committed)
                except DuplicationGap as ex:
                    # never ship past a hole: the shipper is not built, the
                    # confirmed decree stays, and the gap is counted and
                    # reported (retried on the next view or env install)
                    rep.commit_hooks.remove(d.on_commit)
                    d.stop()
                    counters.number("dup.gap_count").increment()
                    events.emit("dup.gap", severity="error",
                                gpid=f"{rep.app_id}.{rep.pidx}", dupid=dupid,
                                error=str(ex))
                    print(f"[dup {dupid}] {rep.app_id}.{rep.pidx}: {ex}",
                          flush=True)
                    continue
                dups[dupid] = d
            d.fail_mode = e.get("fail_mode", "slow")
            d.set_paused(e.get("status") == "pause")
        rep.duplicators = dups

    def _seed_from_restore(self, replica_path: str, restore_dir: str) -> None:
        """Pre-open restore: download the backup's checkpoint files into
        the data dir through the block service (reference restore at
        open, pegasus_server_impl.cpp:1339)."""
        from ..runtime.block_service import create_block_service

        data = os.path.join(replica_path, "data")
        bs = create_block_service(self.block_service_provider, "/")
        bs.download_dir(restore_dir, data)

    def _on_close_replica(self, header, body) -> bytes:
        req = codec.decode(mm.CloseReplicaRequest, body)
        with self._lock:
            rep = self._replicas.pop((req.app_id, req.pidx), None)
            self._service.remove_replica(req.app_id, req.pidx)
            # a close is also the meta's quarantine ack (the re-seed may
            # land on another node): stop beaconing the lost copy
            self._quarantined.pop(f"{req.app_id}.{req.pidx}", None)
            self._quarantining.discard(f"{req.app_id}.{req.pidx}")
        if rep:
            rep.close()
        return b""

    # -------------------------------------------------- integrity plane

    def _corruption_hook(self, app_id: int, pidx: int):
        """The engine's read-path corruption callout for one partition:
        hand off to an async quarantine thread (the engine cannot close
        itself from inside a failing read), deduplicated so a burst of
        reads against one rotten SST starts exactly one quarantine."""
        gpid = f"{app_id}.{pidx}"

        def on_corruption(exc):
            with self._lock:
                if gpid in self._quarantining or gpid in self._quarantined \
                        or (app_id, pidx) not in self._replicas:
                    return
                self._quarantining.add(gpid)
            spawn_thread(self.quarantine_replica, app_id, pidx,
                         str(getattr(exc, "detail", None) or exc), "read",
                         daemon=True, name=f"quarantine.{gpid}")

        return on_corruption

    def quarantine_replica(self, app_id: int, pidx: int, reason: str,
                           source: str = "command") -> dict:
        """Pull one partition off the serving path after a corruption hit
        (read path, scrub finding, or an audit-named mismatch): unregister
        it so clients get typed errors instead of garbage, close it (its
        engine releases every device-resident run, so the node's
        `engine.hbm.*` gauges stop counting them), move its data dir into
        a bounded-retention `quarantine/` forensics dir, and record the
        state so beacons report QUARANTINED: the meta then re-seeds the
        partition like any lost replica."""
        gpid = f"{app_id}.{pidx}"
        key = (app_id, pidx)
        with self._lock:
            rep = self._replicas.pop(key, None)
            if rep is None:
                self._quarantining.discard(gpid)
                prior = self._quarantined.get(gpid)
                return dict(prior) if prior else {"error": f"no replica {gpid}"}
            self._service.remove_replica(app_id, pidx)
            self._last_scrub.pop(key, None)
        try:
            rep.close()
        except Exception as e:  # noqa: BLE001 - the forensics move still runs
            print(f"[quarantine] {gpid}: close failed: {e!r}", flush=True)
        qroot = os.path.join(self.root, "quarantine")
        dest = os.path.join(qroot, f"{gpid}.{int(time.time() * 1000)}")
        try:
            os.makedirs(qroot, exist_ok=True)
            os.rename(rep.path, dest)
        except OSError as e:
            print(f"[quarantine] {gpid}: move failed: {e!r}", flush=True)
            dest = ""
        self._prune_quarantine(qroot)
        record = {"reason": reason, "source": source, "dir": dest,
                  "ts": time.time()}
        with self._lock:
            self._quarantined[gpid] = record
            self._quarantining.discard(gpid)
        counters.rate("replica.quarantine_count").increment()
        events.emit("replica.quarantine", "error", gpid=gpid,
                    node=self.address, reason=reason, source=source)
        return dict(record)

    def _prune_quarantine(self, qroot: str) -> None:
        """Bound the forensics dir: keep the newest PEGASUS_QUARANTINE_KEEP
        quarantined trees, delete the rest oldest-first."""
        import shutil

        try:
            entries = [os.path.join(qroot, n) for n in os.listdir(qroot)]
        except OSError:
            return
        entries.sort(key=lambda p: os.path.getmtime(p)
                     if os.path.exists(p) else 0.0)
        for victim in entries[:max(0, len(entries) - self._quarantine_keep)]:
            shutil.rmtree(victim, ignore_errors=True)

    def _scrub_tick(self, reps) -> None:
        """The maintenance timer's scrub cadence: pick at most ONE replica
        past its PEGASUS_SCRUB_INTERVAL_S (the oldest) and re-verify its
        on-disk checksums."""
        if self._scrub_interval <= 0:
            return
        now = time.monotonic()
        victim = None
        with self._lock:
            oldest = None
            for rep in reps:
                k = (rep.app_id, rep.pidx)
                if k not in self._replicas:
                    continue  # closed or quarantined since the snapshot
                last = self._last_scrub.get(k, 0.0)
                # the OLDEST past-due replica, not the first in dict
                # order: a cadence shorter than the maintenance interval
                # leaves every replica past due at every tick
                if (now - last >= self._scrub_interval
                        and (oldest is None or last < oldest)):
                    oldest = last
                    victim = rep
            if victim is not None:
                self._last_scrub[(victim.app_id, victim.pidx)] = now
        if victim is not None:
            self._scrub_replica(victim)

    def _scrub_replica(self, rep) -> dict:
        """Scrub one replica (the engine's checksum and manifest
        re-verify: host-side file reads; a device-resident run was primed
        before any later rot, so only the scrub or a host read sees it)
        and quarantine it on any finding."""
        res = rep.server.engine.scrub(
            rate_bytes_per_s=self._scrub_bps or None)
        if res["findings"]:
            f0 = res["findings"][0]
            self.quarantine_replica(
                rep.app_id, rep.pidx,
                f"scrub: {f0.get('detail', '?')} ({f0.get('path', '?')})",
                "scrub")
            res["quarantined"] = True
        return res

    def _cmd_scrub_replica(self, args: list) -> str:
        """`scrub-replica [app_id.pidx]`: re-verify hosted replicas'
        on-disk checksums now (every hosted replica, or the named gpid).
        JSON keyed by gpid."""
        with self._lock:
            targets = list(self._replicas.items())
        out = {}
        for (a, p), rep in targets:
            gpid = f"{a}.{p}"
            if args and args[0] != gpid:
                continue
            try:
                res = self._scrub_replica(rep)
            except Exception as e:  # noqa: BLE001 - report, keep the rest
                out[gpid] = {"error": repr(e)}
                continue
            out[gpid] = {"files": res["files"], "bytes": res["bytes"],
                         "findings": res["findings"],
                         "errors": res.get("errors", []),
                         "quarantined": bool(res.get("quarantined"))}
        return json.dumps(out)

    def _cmd_quarantine_replica(self, args: list) -> str:
        """`quarantine-replica <app_id.pidx> [reason...]`: force one
        partition into quarantine (the collector's auto-healer turns an
        audit-named mismatch into a re-seed through this)."""
        if not args:
            return "usage: quarantine-replica <app_id.pidx> [reason]"
        a, _, p = args[0].partition(".")
        try:
            app_id, pidx = int(a), int(p)
        except ValueError:
            return f"bad gpid {args[0]!r}"
        reason = " ".join(args[1:]) or "remote-command"
        rec = self.quarantine_replica(app_id, pidx, reason, "command")
        if "error" in rec:
            return ""  # not hosted here
        return json.dumps({args[0]: rec})

    def _cmd_quarantine_status(self, args: list) -> str:
        """`quarantine-status`: this node's quarantined partitions
        (gpid-keyed JSON)."""
        with self._lock:
            return json.dumps({g: dict(q)
                               for g, q in self._quarantined.items()})

    def _on_replica_state(self, header, body) -> bytes:
        req = codec.decode(mm.ReplicaStateRequest, body)
        with self._lock:
            rep = self._replicas.get((req.app_id, req.pidx))
        if rep is None:
            return codec.encode(mm.ReplicaStateResponse(error=1))
        return codec.encode(mm.ReplicaStateResponse(
            status=rep.status, ballot=rep.ballot,
            last_committed=rep.last_committed, last_prepared=rep.last_prepared,
            last_durable=rep.server.engine.last_durable_decree(),
            last_applied=rep.server.engine.last_committed_decree()))

    def _on_query_replica_info(self, header, body) -> bytes:
        """Everything this node holds (reference query_replica_info)."""
        with self._lock:
            reps = list(self._replicas.values())
        out = [mm.ReplicaInfo(
            app_name=rep.app_name, app_id=rep.app_id, pidx=rep.pidx,
            partition_count=rep.partition_count,
            ballot=rep.ballot, last_committed=rep.last_committed,
            last_prepared=rep.last_prepared,
            last_durable=rep.server.engine.last_durable_decree(),
            envs_json=json.dumps(rep.server.app_envs),
            last_applied=rep.server.engine.last_committed_decree())
            for rep in reps]
        return codec.encode(mm.QueryReplicaInfoResponse(replicas=out))

    # ------------------------------------------------------- replication RPC

    def _peer_factory(self, app_id, pidx):
        def peers(addr: str):
            if addr == self.address:
                raise ConnectionError("self")
            return _RemotePeer(self, addr, app_id, pidx)

        return peers

    def _on_prepare(self, header, body) -> bytes:
        req = codec.decode(mm.PrepareRequest, body)
        with self._lock:
            rep = self._replicas.get((req.app_id, req.pidx))
        if rep is None:
            return codec.encode(mm.PrepareResponse(error=1, reason="no_replica"))
        if req.mutations:  # decree-pipelined window
            ms = [codec.decode(LogMutation, b) for b in req.mutations]
        elif req.mutation:  # single-mutation frame
            ms = [codec.decode(LogMutation, req.mutation)]
        else:              # empty window: pure commit-point broadcast
            ms = []
        try:
            lp = rep.on_prepare_batch(req.ballot, ms, req.committed_decree)
            return codec.encode(mm.PrepareResponse(last_prepared=lp))
        except PrepareRejected as rej:
            return codec.encode(mm.PrepareResponse(
                error=1, reason=rej.reason, last_prepared=rej.last_prepared))

    def _on_learn(self, header, body) -> bytes:
        req = codec.decode(mm.LearnRequest, body)
        with self._lock:
            rep = self._replicas.get((req.app_id, req.pidx))
        if rep is None:
            return codec.encode(mm.LearnResponse(error=1))
        state = rep.fetch_learn_state()
        return codec.encode(mm.LearnResponse(
            files=[mm.FileBlob(n, d) for n, d in state["files"]],
            tail=[codec.encode(m) for m in state["tail"]],
            last_committed=state["last_committed"], ballot=state["ballot"]))

    # -------------------------------------------- block-shipped learn RPCs

    def _learn_replica(self, req):
        with self._lock:
            return self._replicas.get((req.app_id, req.pidx))

    def _on_learn_prepare(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.LearnPrepareRequest, body)
        rep = self._learn_replica(req)
        if rep is None:
            return codec.encode(rpc_msg.LearnPrepareResponse(
                error=1, error_text="no_replica"))
        try:
            st = rep.prepare_learn_state(
                have=[{"name": e.name, "size": e.size, "digest": e.digest}
                      for e in req.have],
                delta=req.delta)
        except Exception as e:  # noqa: BLE001 - the learner retries
            return codec.encode(rpc_msg.LearnPrepareResponse(
                error=1, error_text=repr(e)))
        if req.job:
            # attribute this primary's checkpoint pin to the learner's
            # traced job: opens a remote-view record here; in a onebox
            # the note lands straight in the learn timeline
            JOB_TRACER.note("learn.serve_prepare", job_id=req.job,
                            gpid=f"{req.app_id}.{req.pidx}",
                            blocks=len(st["blocks"]),
                            missing=len(st["missing"]))
        return codec.encode(rpc_msg.LearnPrepareResponse(
            learn_id=st["learn_id"], ckpt_decree=st["ckpt_decree"],
            ballot=st["ballot"], last_committed=st["last_committed"],
            blocks=[rpc_msg.LearnBlockEntry(e["name"], e["size"],
                                            e["digest"])
                    for e in st["blocks"]],
            missing=st["missing"], digest=st["digest"],
            digest_now=st["digest_now"], digest_pmask=st["digest_pmask"]))

    def _on_learn_fetch(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.LearnFetchRequest, body)
        rep = self._learn_replica(req)
        if rep is None:
            return codec.encode(rpc_msg.LearnFetchResponse(
                error=1, error_text="no_replica"))
        try:
            ch = rep.fetch_learn_block(req.learn_id, req.name, req.offset,
                                       req.length)
        except Exception as e:  # noqa: BLE001 - expired pins included
            return codec.encode(rpc_msg.LearnFetchResponse(
                error=1, error_text=repr(e)))
        return codec.encode(rpc_msg.LearnFetchResponse(
            data=ch["data"], crc=ch["crc"], total=ch["total"]))

    def _on_learn_tail(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.LearnTailRequest, body)
        rep = self._learn_replica(req)
        if rep is None:
            return codec.encode(rpc_msg.LearnTailResponse(
                error=1, error_text="no_replica"))
        try:
            st = rep.fetch_learn_tail(req.learn_id)
        except Exception as e:  # noqa: BLE001
            return codec.encode(rpc_msg.LearnTailResponse(
                error=1, error_text=repr(e)))
        return codec.encode(rpc_msg.LearnTailResponse(
            tail=[codec.encode(m) for m in st["tail"]],
            last_committed=st["last_committed"], ballot=st["ballot"]))

    def _on_learn_finish(self, header, body) -> bytes:
        req = codec.decode(rpc_msg.LearnFinishRequest, body)
        rep = self._learn_replica(req)
        if rep is not None:
            rep.finish_learn(req.learn_id)
        return codec.encode(rpc_msg.LearnFetchResponse())

    # ------------------------------------------------ backup and bulk load

    def _on_cold_backup(self, header, body) -> bytes:
        """Checkpoint this partition, then upload it through the block
        service (reference: copy_checkpoint_to_dir -> block service
        upload)."""
        from ..runtime.block_service import create_block_service

        req = codec.decode(mm.OpenReplicaRequest, body)
        with self._lock:
            rep = self._replicas.get((req.app_id, req.pidx))
        if rep is None:
            raise RpcError(ERR_OBJECT_NOT_FOUND, "replica not served here")
        engine = rep.server.engine
        # the checkpoint lock spans create and upload, so a concurrent
        # maintenance checkpoint can neither GC this decree nor swap the
        # directory under the upload
        with engine.checkpoint_lock:
            decree = engine.sync_checkpoint()
            src = engine.get_checkpoint_dir(decree)
            bs = create_block_service(self.block_service_provider, "/")
            bs.upload_dir(src, req.restore_dir)
        return codec.encode(mm.OpenReplicaResponse(last_committed=decree))

    def _on_bulk_load(self, header, body) -> bytes:
        """Ingest this partition's bulk-load set from the provider root
        into the local engine (no replication: the meta's sessions take
        the replicated RPC_BULK_LOAD_INGEST write instead)."""
        from ..engine import bulk_load as bl

        req = codec.decode(mm.OpenReplicaRequest, body)
        with self._lock:
            rep = self._replicas.get((req.app_id, req.pidx))
        if rep is None:
            raise RpcError(ERR_OBJECT_NOT_FOUND, "replica not served here")
        stats = bl.ingest_partition(
            rep.server.engine, req.restore_dir, req.app_name,
            req.partition_count, req.pidx, rep.server._schema)
        return int(stats["records"]).to_bytes(8, "little")

    # ------------------------------------------------------ remote commands

    def _describe(self) -> dict:
        with self._lock:
            return {
                "address": self.address,
                "replicas": {
                    f"{a}.{p}": {
                        "status": r.status, "ballot": r.ballot,
                        "last_committed": r.last_committed,
                        "last_prepared": r.last_prepared,
                        "last_durable": r.server.engine.last_durable_decree(),
                        "last_applied": r.server.engine.last_committed_decree(),
                    }
                    for (a, p), r in self._replicas.items()
                },
            }

    def _cmd_manual_compact(self, args: list) -> str:
        """manual-compact [app_id.pidx ...]: a full compaction now."""
        done = []
        with self._lock:
            targets = list(self._replicas.items())
        for (a, p), rep in targets:
            if args and f"{a}.{p}" not in args:
                continue
            rep.server.manual_compact()
            done.append(f"{a}.{p}")
        return "compacted: " + ", ".join(done) if done else "no matching replica"

    def batched_manual_compact(self, app_id: int = None,
                               now: int = None) -> dict:
        """Node-level manual compaction: every cuda-backend replica of this
        node (optionally of one app) compacts through the batched merge
        kernel (ops.batched_compact.compact_partition_batch), one dispatch
        per group of replicas sharing an ownership mask; a cpu-backend
        replica runs its own manual_compact. Every participating engine's
        compaction lock is held from the file-set snapshot through the
        output install (taken in stable key order), so flush-triggered
        compactions cannot double-merge. One traced "compact" job
        (trigger=batched): an engine.merge hop per group, carrying the
        kernel calls counted during it, and an engine.install hop per
        replica."""
        with JOB_TRACER.job("compact", node=self.address, trigger="batched",
                            app_id=app_id):
            return self._batched_manual_compact_traced(app_id, now)

    def _batched_manual_compact_traced(self, app_id, now) -> dict:
        from ..engine.block import KVBlock
        from ..engine.db import META_LAST_MANUAL_COMPACT_FINISH_TIME
        from ..ops.batched_compact import compact_partition_batch
        from ..ops.merge_path import LAUNCHES

        def mark_done(eng):
            with eng._lock:
                eng._meta[META_LAST_MANUAL_COMPACT_FINISH_TIME] = \
                    int(time.time())
                eng._write_manifest_locked()  # the finish time persists

        with self._lock:
            reps = [(aid, rep)
                    for (aid, p), rep in sorted(self._replicas.items())
                    if app_id is None or aid == app_id]
        groups, fallback = {}, []
        held = set()  # engines whose compaction lock is held

        def release(eng):
            if eng in held:
                held.discard(eng)
                eng._compaction_lock.release()

        stats = {"input_records": 0, "output_records": 0,
                 "partitions": 0, "batched": 0, "fallback": 0}
        try:
            for aid, rep in reps:
                eng = rep.server.engine
                if eng.opts.backend != "cuda":
                    fallback.append(rep)
                    continue
                eng.flush()
                eng._compaction_lock.acquire()
                held.add(eng)
                with eng._lock:
                    all_inputs = list(eng._l0)
                    for lv in sorted(eng._levels):
                        all_inputs.extend(eng._levels[lv])
                inputs = [s for s in all_inputs if s.n]
                if not inputs:
                    # zero-record SSTs are swept as manual_compact would
                    if all_inputs:
                        eng._install_merge_output(all_inputs, [],
                                                  KVBlock.empty(),
                                                  eng.opts.max_levels)
                    mark_done(eng)
                    release(eng)
                    stats["partitions"] += 1
                    stats["batched"] += 1
                    continue
                device_runs = [eng._device_run_budgeted(s) for s in inputs]
                if any(d is None for d in device_runs):
                    release(eng)  # its own manual_compact locks later
                    fallback.append(rep)
                    continue
                groups.setdefault((aid, eng.opts.partition_mask),
                                  []).append((eng, all_inputs, inputs,
                                              device_runs))
            for (aid, pmask), group in groups.items():
                eng0 = group[0][0]
                opts = eng0._compact_options(
                    now=now, bottommost=True, runs_sorted=True,
                    partition_mask=pmask)
                jobs, post_opts = [], []
                for eng, all_inputs, inputs, drs in group:
                    jobs.append(([s.block() for s in inputs], drs,
                                 eng.opts.pidx))
                    post_opts.append(eng._compact_options(
                        now=now, bottommost=True, runs_sorted=True,
                        pidx=eng.opts.pidx, partition_mask=pmask,
                        default_ttl=eng.opts.default_ttl,
                        user_ops=tuple(eng.opts.user_ops)))
                with JOB_TRACER.hop("engine.merge", where="batched",
                                    partitions=len(group)) as jh:
                    l0 = LAUNCHES["merge_path"]
                    outs = compact_partition_batch(jobs, opts,
                                                   post_opts=post_opts)
                    # the kernel calls this process counted during the hop
                    jh["launches"] = LAUNCHES["merge_path"] - l0
                for (eng, all_inputs, inputs, _), out in zip(group, outs):
                    n_in = sum(s.n for s in inputs)
                    with JOB_TRACER.hop("engine.install", pidx=eng.opts.pidx):
                        eng._install_merge_output(all_inputs, [], out,
                                                  eng.opts.max_levels)
                    mark_done(eng)
                    release(eng)
                    stats["input_records"] += n_in
                    stats["output_records"] += out.n
                    stats["partitions"] += 1
                    stats["batched"] += 1
        finally:
            for eng in list(held):
                release(eng)
        for rep in fallback:
            fs = rep.server.engine.manual_compact(now=now)
            stats["input_records"] += fs.get("input_records", 0)
            stats["output_records"] += fs.get("output_records", 0)
            stats["partitions"] += 1
            stats["fallback"] += 1
        return stats

    def _cmd_batched_manual_compact(self, args) -> str:
        app_id = int(args[0]) if args else None
        return json.dumps(self.batched_manual_compact(app_id=app_id))

    def _cmd_replica_disk(self, args) -> str:
        """Per-replica on-disk footprint."""
        with self._lock:
            reps = list(self._replicas.items())
        out = {}
        for (aid, pidx), rep in reps:
            eng = rep.server.engine
            with eng._lock:
                files = list(eng._l0) + [f for fs in eng._levels.values()
                                         for f in fs]
            out[f"{aid}.{pidx}"] = {
                "sst_bytes": sum(f.data_bytes for f in files),
                "sst_files": len(files),
                "records": sum(f.n for f in files),
                "primary": rep.status == PRIMARY,
            }
        return json.dumps(out)

    def _cmd_compact_state(self, args: list) -> str:
        with self._lock:
            targets = list(self._replicas.items())
        return "\n".join(
            f"{a}.{p}: {rep.server.manual_compact_service.query_compact_state()}"
            for (a, p), rep in targets)

    def _cmd_detect_hotkey(self, args: list) -> str:
        """detect_hotkey <app_id.pidx> <read|write> <start|stop|query>."""
        if len(args) < 3:
            return ("usage: detect_hotkey <app_id.pidx> <read|write> "
                    "<start|stop|query>")
        gpid, kind, action = args[0], args[1], args[2]
        a, _, p = gpid.partition(".")
        with self._lock:
            rep = self._replicas.get((int(a), int(p)))
        if rep is None:
            return f"no replica {gpid}"
        return rep.server.on_detect_hotkey(kind, action)

    def _cmd_set_read_residency(self, args: list) -> str:
        """set-read-residency <app_id.pidx> <on|off>: pin or unpin one
        partition's SSTs on the card for its batched reads (the
        collector's hotkey loop drives this from read-hot verdicts). On a
        cuda node the pin primes on the card; a failed prime raises to
        the next read that needs the run."""
        if len(args) < 2 or args[1] not in ("on", "off"):
            return "usage: set-read-residency <app_id.pidx> <on|off>"
        gpid = args[0]
        a, _, p = gpid.partition(".")
        with self._lock:
            rep = self._replicas.get((int(a), int(p)))
        if rep is None:
            return f"no replica {gpid}"
        on = args[1] == "on"
        rep.server.engine.set_read_residency(on)
        return f"read residency {'on' if on else 'off'} for {gpid}"

    def _cmd_trigger_audit(self, args: list) -> str:
        """trigger-audit <app_id.pidx> [audit_id] [now=<epoch>]: ride a
        no-op mutation through the partition's PacificA prepare path so
        every replica computes a consistency digest anchored at the same
        applied decree, then broadcast the commit point so idle
        secondaries apply it now. Runs on the primary; returns its digest
        as JSON, or "" when the partition is not served here."""
        from ..base.utils import epoch_now
        from ..engine.server_impl import RPC_TRIGGER_AUDIT

        now_arg = next((int(x[4:]) for x in args if x.startswith("now=")),
                       None)
        pos = [x for x in args if not x.startswith("now=")]
        if not pos:
            return ("usage: trigger-audit <app_id.pidx> [audit_id] "
                    "[now=<epoch>]")
        a, _, p = pos[0].partition(".")
        with self._lock:
            rep = self._replicas.get((int(a), int(p)))
        if rep is None:
            return ""
        if rep.status != PRIMARY:
            return json.dumps({"error": f"not primary ({rep.status})",
                               "gpid": pos[0], "node": self.address})
        audit_id = int(pos[1]) if len(pos) > 1 else int(time.time() * 1000)
        # partition_count - 1 is the ownership mask, carried in the
        # mutation so every replica digests against the same mask
        pmask = max(0, rep.partition_count - 1)
        req = rpc_msg.TriggerAuditRequest(
            audit_id=audit_id,
            now=epoch_now() if now_arg is None else now_arg, pmask=pmask)
        try:
            resp = rep.client_write(RPC_TRIGGER_AUDIT, req)
        except ReplicaError as e:
            return json.dumps({"error": str(e), "gpid": pos[0],
                               "node": self.address})
        if resp.error or not resp.digest:
            return json.dumps({"error": f"digest failed ({resp.server})",
                               "gpid": pos[0], "node": self.address})
        rep.broadcast_commit_point()
        return json.dumps({"gpid": pos[0], "audit_id": audit_id,
                           "decree": resp.decree, "digest": resp.digest,
                           "records": resp.records, "node": self.address})

    def _cmd_query_audit(self, args: list) -> str:
        """query-audit [app_id.pidx]: each hosted (or the named) replica's
        latest decree-anchored digest and its committed/applied decrees,
        keyed by gpid."""
        with self._lock:
            targets = list(self._replicas.items())
        out = {}
        for (a, p), rep in targets:
            gpid = f"{a}.{p}"
            if args and args[0] != gpid:
                continue
            ent = {"status": rep.status,
                   "committed": rep.last_committed,
                   "applied": rep.server.engine.last_committed_decree(),
                   "node": self.address}
            la = rep.server.last_audit
            if la:
                ent["audit"] = dict(la)
            out[gpid] = ent
        return json.dumps(out)

    def _cmd_learn_status(self, args: list) -> str:
        """learn-status: this process's block-ship totals plus each hosted
        replica's learning flag and primary-side learn pins."""
        with self._lock:
            targets = list(self._replicas.items())
        out = {
            "ship.blocks": counters.rate("learn.ship.blocks").total(),
            "ship.bytes": counters.rate("learn.ship.bytes").total(),
            "ship.delta_skipped_blocks": counters.rate(
                "learn.ship.delta_skipped_blocks").total(),
            "ship.replay_mutations": counters.rate(
                "learn.replay.mutations").total(),
        }
        for (a, p), rep in targets:
            ent = rep.learn_state()
            ent["pins"] = rep.learn_pins()
            ent["node"] = self.address
            out[f"replica.{a}.{p}"] = ent
        return json.dumps(out)

    def _cmd_flush_log(self, args: list) -> str:
        """flush-log: fsync every hosted replica's mutation log."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            rep.plog.flush()
        return f"flushed {len(reps)} logs"

    def _cmd_compact_sched_policy(self, args: list) -> str:
        """compact-sched-policy <json>: the compaction scheduler's
        delivery surface. The body is ``{"ttl_s": s, "decisions":
        {"<app>.<pidx>": {"policy": defer|normal|urgent, "reasons": [...],
        "where": addr?, "job": id?}}, "max_device": n?}``: each hosted
        partition named installs the policy token (and, with "where", the
        offload placement) on its engine, both expiring after ttl_s;
        max_device caps this node's concurrent device compactions under
        the same lease. -> {gpid: policy} for what applied."""
        if not args:
            return "usage: compact-sched-policy <json>"
        try:
            req = json.loads(" ".join(args))
        except ValueError as e:
            return f"bad policy json: {e}"
        ttl = req.get("ttl_s")
        if "max_device" in req:
            from ..engine.db import SCHED_GATE

            SCHED_GATE.set_max(max(0, int(req["max_device"])), ttl_s=ttl)
        with self._lock:
            reps = dict(self._replicas)
        applied = {}
        for gpid, dec in sorted((req.get("decisions") or {}).items()):
            a, _, p = gpid.partition(".")
            try:
                rep = reps.get((int(a), int(p)))
            except ValueError:
                continue
            if rep is None:
                continue
            policy = dec.get("policy", "normal")
            try:
                rep.server.engine.set_compact_policy(
                    policy, reasons=dec.get("reasons", ()), ttl_s=ttl,
                    job=dec.get("job", ""))
            except ValueError as e:
                applied[gpid] = f"error: {e}"
                continue
            if "where" in dec:
                rep.server.engine.set_offload_target(dec.get("where") or "",
                                                     ttl_s=ttl)
            applied[gpid] = policy
        return json.dumps(applied)

    def _cmd_compact_sched_status(self, args: list) -> str:
        """compact-sched-status [gpid]: each hosted (or the named)
        partition's live scheduler token (policy, reasons, seconds to
        expiry), its offload placement and its compaction debt, keyed by
        gpid."""
        with self._lock:
            targets = list(self._replicas.items())
        out = {}
        for (a, p), rep in targets:
            gpid = f"{a}.{p}"
            if args and args[0] != gpid:
                continue
            engine = rep.server.engine
            policy, reasons, expires_in = engine.compact_policy()
            debt = engine.compaction_debt()
            out[gpid] = {"policy": policy, "reasons": reasons,
                         "expires_in_s": round(expires_in, 3),
                         "offload": engine.offload_target() or "",
                         "l0_files": debt["l0_files"],
                         "debt_bytes": debt["debt_bytes"],
                         "pending_installs": debt["pending_installs"],
                         "ceiling_files": debt["ceiling_files"],
                         "node": self.address}
        return json.dumps(out)

    def _cmd_flush_memtable(self, args: list) -> str:
        """flush-memtable [app_id.pidx ...]: flush every hosted (or each
        named) replica's memtable into an SST now. Port-only: a caller in
        another process (chip_smoke.py's cluster phase) snapshots a
        replica's runs just before a manual compaction with it."""
        with self._lock:
            targets = list(self._replicas.items())
        done = []
        for (a, p), rep in targets:
            if args and f"{a}.{p}" not in args:
                continue
            rep.server.engine.flush()
            done.append(f"{a}.{p}")
        return f"flushed {len(done)} memtables"

    # ------------------------------------------------------------ write path

    def _route_write(self, server, code, req):
        with self._lock:
            rep = self._replicas.get((server.app_id, server.pidx))
        if rep is None:
            raise RpcError(ERR_OBJECT_NOT_FOUND, "replica closed")
        if rep.status != PRIMARY:
            raise RpcError(ERR_INVALID_STATE, f"not primary ({rep.status})")
        try:
            return rep.client_write(code, req)
        except ReplicaError as e:
            raise RpcError(ERR_INVALID_STATE, str(e))

    # -------------------------------------------------------------- control

    def stop(self):
        if not self._stop.is_set():
            # drop the refcounted sampler reference once: a node kill and
            # a harness teardown may both call stop()
            HISTORY.stop()
        self._stop.set()
        self.rpc.stop()
        for t in (self._beacon_thread, self._maint_thread,
                  self._catch_up_thread):
            if t.is_alive():
                t.join(timeout=5.0)
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
        for r in reps:
            r.close()
        self.pool.close()
