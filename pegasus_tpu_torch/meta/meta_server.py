"""Meta server: table DDL, partition->replica mapping, beacon FD, failover.

Port of the core of pegasus_tpu/meta/meta_server.py (the rDSN
meta-server role): app state and partition configs live here, persisted
to a JSON state file that both packages read and write (a port meta
loads a reference meta's state.json and the other way round); replica
nodes register via beacons with lease/grace semantics, and node death
triggers reconfiguration: promote the surviving secondary with the
longest prepared log, then rebuild the replica count by seeding a
learner on an under-loaded node.

Served: create, drop, list and query-config of apps, app envs, list
nodes, the meta level and the beacon. Not ported yet, so their codes
stay unregistered and answer ERR_HANDLER_NOT_FOUND: split, backup and
restore, bulk-load sessions, duplication, backup policies, recall and
purge of dropped apps, recover, ddd_diagnose, query_cluster_state, the
quarantine repair, balance and propose. The state file's entries for
those planes (duplications, backup policies, soft-dropped apps) are
kept as loaded and written back unchanged.
"""

import json
import os
import threading
import time

from ..rpc import codec
from ..rpc.transport import (ConnectionPool, ERR_FORWARD_TO_PRIMARY,
                             ERR_INVALID_STATE, RpcError)
from . import messages as mm

RPC_CM_CREATE_APP = "RPC_CM_START_CREATE_APP"
RPC_CM_DROP_APP = "RPC_CM_START_DROP_APP"
RPC_CM_LIST_APPS = "RPC_CM_LIST_APPS"
RPC_CM_QUERY_CONFIG = "RPC_CM_QUERY_PARTITION_CONFIG_BY_INDEX"
RPC_CM_SET_APP_ENVS = "RPC_CM_UPDATE_APP_ENV"
RPC_CM_LIST_NODES = "RPC_CM_LIST_NODES"
RPC_CM_SPLIT_APP = "RPC_CM_START_PARTITION_SPLIT"
RPC_CM_BACKUP_APP = "RPC_CM_START_BACKUP_APP"
RPC_CM_RESTORE_APP = "RPC_CM_START_RESTORE"
RPC_CM_START_BULK_LOAD = "RPC_CM_START_BULK_LOAD"
RPC_CM_QUERY_BULK_LOAD = "RPC_CM_QUERY_BULK_LOAD_STATUS"
RPC_CM_CONTROL_BULK_LOAD = "RPC_CM_CONTROL_BULK_LOAD"
RPC_CM_QUERY_RESTORE = "RPC_CM_QUERY_RESTORE_STATUS"
RPC_CM_PROPOSE = "RPC_CM_PROPOSE_BALANCER"
RPC_CM_BALANCE = "RPC_CM_START_BALANCE"
RPC_CM_ADD_DUPLICATION = "RPC_CM_ADD_DUPLICATION"
RPC_CM_QUERY_DUPLICATION = "RPC_CM_QUERY_DUPLICATION"
RPC_CM_MODIFY_DUPLICATION = "RPC_CM_MODIFY_DUPLICATION"
RPC_CM_ADD_BACKUP_POLICY = "RPC_CM_ADD_BACKUP_POLICY"
RPC_CM_LS_BACKUP_POLICY = "RPC_CM_QUERY_BACKUP_POLICY"
RPC_CM_MODIFY_BACKUP_POLICY = "RPC_CM_MODIFY_BACKUP_POLICY"
RPC_CM_RECOVER = "RPC_CM_START_RECOVERY"
RPC_CM_RECALL_APP = "RPC_CM_RECALL_APP"
RPC_CM_CONTROL_META = "RPC_CM_CONTROL_META"

# meta function levels (reference meta_function_level enum, shell
# rebalance.cpp:27-31: stopped/blind/freezed/steady/lively; get/set_meta_level)
META_LEVELS = ("stopped", "blind", "freezed", "steady", "lively")
# stopped: reject everything, queries included — full operator lockdown;
#          only control_meta (the way out) and beacons (liveness must
#          never be blinded) still served
# blind:   reject every state-changing DDL (reference meta_function_level
#          FL_blind); reads/queries still served
# freezed: DDL allowed but no meta-initiated data movement (no learner
#          rebuild on node death)
# steady:  failover rebuild but no balancing
# lively:  everything, including balance
RPC_CM_DDD_DIAGNOSE = "RPC_CM_DDD_DIAGNOSE"
RPC_CM_QUERY_CLUSTER_STATE = "RPC_CM_QUERY_CLUSTER_STATE"
RPC_FD_BEACON = "RPC_FD_FAILURE_DETECTOR_PING"

# meta -> replica node
RPC_OPEN_REPLICA = "RPC_CONFIG_PROPOSAL_OPEN_REPLICA"
RPC_CLOSE_REPLICA = "RPC_CONFIG_PROPOSAL_CLOSE_REPLICA"
RPC_REPLICA_STATE = "RPC_QUERY_REPLICA_STATE"
RPC_COLD_BACKUP = "RPC_COLD_BACKUP"
RPC_BULK_LOAD = "RPC_BULK_LOAD"
RPC_QUERY_REPLICA_INFO = "RPC_QUERY_REPLICA_INFO"


class MetaServer:
    REPAIR_WORKERS = 8   # partitions seeding a learner at once

    def __init__(self, state_path: str, fd_grace_seconds: float = 22.0,
                 replica_count: int = 3, election=None):
        self.state_path = state_path
        self.fd_grace = fd_grace_seconds
        self.default_replica_count = replica_count
        # meta HA (meta/election.py): state_path must live on storage every
        # meta shares; None = single-meta mode, always leader
        self.election = election
        self._lock = threading.RLock()
        self._apps = {}          # name -> AppInfo
        self._parts = {}         # app_id -> list[PartitionConfig]
        self._nodes = {}         # addr -> last_beacon_monotonic
        self._node_replicas = {} # addr -> ["app_id.pidx"] from the last beacon
        self._node_states = {}   # addr -> {gpid: lag/audit state} (beacon)
        self._node_tables = {}   # addr -> {tables@pid:N: tenant-ledger frag}
        # planes not ported yet, kept as loaded so the state file
        # round-trips: duplication entries, backup policies, soft drops
        self._dups = {}          # app_id -> list[dict] duplication entries
        self._policies = {}      # name -> dict (BackupPolicyInfo fields)
        self._dropped = {}       # app_id -> {"app","parts","expire_ts"}
        self.level = "lively"    # freezed | steady | lively (see META_LEVELS)
        self._next_app_id = 1
        self._next_dupid = 1
        self._state_epoch = 0    # epoch the loaded state file was written under
        self._state_fp = None    # (ino, mtime_ns, size) of the state file as
                                 # last read/written by THIS process — guards
                                 # the cached epoch (no full json re-parse
                                 # per acked DDL)
        self.pool = ConnectionPool()
        self._load()

    # ----------------------------------------------------------- serverlet

    # codes still served at level "blind" (pure queries + liveness):
    # everything read-only, the beacon (liveness must not be blinded), and
    # control_meta itself (the way back out)
    _BLIND_ALLOWED = frozenset({
        RPC_CM_LIST_APPS, RPC_CM_QUERY_CONFIG, RPC_CM_LIST_NODES,
        RPC_CM_QUERY_DUPLICATION, RPC_CM_LS_BACKUP_POLICY,
        RPC_CM_QUERY_BULK_LOAD, RPC_CM_QUERY_RESTORE, RPC_CM_CONTROL_META,
        RPC_CM_QUERY_CLUSTER_STATE, RPC_FD_BEACON,
    })

    # codes still served at level "stopped" (full lockdown): only the way
    # back out and liveness
    _STOPPED_ALLOWED = frozenset({RPC_CM_CONTROL_META, RPC_FD_BEACON})

    def _guard_level(self, code, fn):
        def wrapped(header, body):
            if (self.election is not None and not self.election.is_leader()
                    and code != RPC_FD_BEACON):
                # followers still absorb beacons (a warm liveness map makes
                # takeover instant); everything else goes to the leader —
                # clients/shell/replicas fall through their meta list
                leader = self.election.leader()
                raise RpcError(ERR_FORWARD_TO_PRIMARY,
                               f"not the meta leader (leader: "
                               f"{leader or 'unknown'})")
            if self.level == "stopped" and code not in self._STOPPED_ALLOWED:
                raise RpcError(ERR_INVALID_STATE,
                               f"meta level is stopped; {code} refused "
                               "(set_meta_level to unlock)")
            if self.level == "blind" and code not in self._BLIND_ALLOWED:
                raise RpcError(ERR_INVALID_STATE,
                               f"meta level is blind; {code} refused "
                               "(set_meta_level to unlock)")
            return fn(header, body)
        return wrapped

    def rpc_handlers(self) -> dict:
        handlers = self._raw_rpc_handlers()
        return {code: self._guard_level(code, fn)
                for code, fn in handlers.items()}

    def _raw_rpc_handlers(self) -> dict:
        return {
            RPC_CM_CREATE_APP: self._on_create_app,
            RPC_CM_DROP_APP: self._on_drop_app,
            RPC_CM_LIST_APPS: self._on_list_apps,
            RPC_CM_QUERY_CONFIG: self._on_query_config,
            RPC_CM_SET_APP_ENVS: self._on_set_app_envs,
            RPC_CM_LIST_NODES: self._on_list_nodes,
            RPC_CM_CONTROL_META: self._on_control_meta,
            RPC_FD_BEACON: self._on_beacon,
        }

    # ----------------------------------------------------------------- DDL

    def _on_create_app(self, header, body) -> bytes:
        req = codec.decode(mm.CreateAppRequest, body)
        with self._lock:
            if req.app_name in self._apps:
                app = self._apps[req.app_name]
                return codec.encode(mm.CreateAppResponse(app_id=app.app_id))
            alive = self._alive_nodes_locked()
            if not alive:
                return codec.encode(mm.CreateAppResponse(
                    error=1, error_text="no alive replica nodes"))
            # partition counts are powers of two: split doubles them and the
            # ownership filter is a bit mask (hash & (count-1) == pidx), so
            # mask and modulo must agree (reference requires the same)
            pcount = 1
            while pcount < max(1, req.partition_count):
                pcount <<= 1
            app = mm.AppInfo(app_name=req.app_name, app_id=self._next_app_id,
                             partition_count=pcount,
                             replica_count=min(req.replica_count, len(alive)),
                             envs_json=req.envs_json)
            self._next_app_id += 1
            self._apps[req.app_name] = app
            parts = []
            for pidx in range(pcount):
                members = self._pick_nodes_locked(app.replica_count, pidx)
                pc = mm.PartitionConfig(pidx=pidx, ballot=1,
                                        primary=members[0],
                                        secondaries=members[1:])
                parts.append(pc)
            self._parts[app.app_id] = parts
            self._persist_locked()
        for pc in parts:
            self._install_partition(app, pc, learners=())
        return codec.encode(mm.CreateAppResponse(app_id=app.app_id))

    def _on_drop_app(self, header, body) -> bytes:
        """drop [-r reserve_seconds]: reserve_seconds > 0 soft-drops — the
        app disappears from routing/DDL but its replicas' data stays on
        disk and a recall can restore it until the hold expires
        (reference drop/recall with hold_seconds_for_dropped_app; the
        port records the soft drop in the state file and does not serve
        the recall yet)."""
        req = codec.decode(mm.DropAppRequest, body)
        with self._lock:
            app = self._apps.pop(req.app_name, None)
            if app is None:
                return codec.encode(mm.DropAppResponse(
                    error=1, error_text="no such app"))
            parts = self._parts.pop(app.app_id, [])
            if req.reserve_seconds > 0:
                app.status = "AS_DROPPED"
                self._dropped[app.app_id] = {
                    "app": vars(app), "parts": [vars(pc) for pc in parts],
                    "expire_ts": int(time.time()) + req.reserve_seconds}
            self._persist_locked()
        for pc in parts:
            for node in [pc.primary] + pc.secondaries:
                self._send_to_node(node, RPC_CLOSE_REPLICA,
                                   mm.CloseReplicaRequest(app.app_id, pc.pidx),
                                   ignore_errors=True)
        return codec.encode(mm.DropAppResponse())

    def _on_control_meta(self, header, body) -> bytes:
        """get/set the meta function level (reference meta_function_level
        + shell get_meta_level/set_meta_level): `freezed` stops every
        meta-initiated data movement (balancing AND redundancy rebuild —
        primaries still promote so writes survive), `steady` allows
        failover rebuild but no balancing, `lively` enables auto-balance."""
        req = codec.decode(mm.ControlMetaRequest, body)
        with self._lock:
            if req.set_level:
                if req.set_level not in META_LEVELS:
                    return codec.encode(mm.ControlMetaResponse(
                        error=1,
                        error_text=f"bad level {req.set_level} "
                                   f"(choose from {'/'.join(META_LEVELS)})"))
                self.level = req.set_level
                self._persist_locked()
            return codec.encode(mm.ControlMetaResponse(level=self.level))

    def _on_list_apps(self, header, body) -> bytes:
        with self._lock:
            return codec.encode(mm.ListAppsResponse(
                apps=list(self._apps.values())))

    def _on_query_config(self, header, body) -> bytes:
        req = codec.decode(mm.QueryConfigRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.QueryConfigResponse(
                    error=1, error_text=f"no app {req.app_name}"))
            return codec.encode(mm.QueryConfigResponse(
                app=app, partitions=list(self._parts[app.app_id])))

    def _on_set_app_envs(self, header, body) -> bytes:
        req = codec.decode(mm.SetAppEnvsRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.SetAppEnvsResponse(
                    error=1, error_text="no such app"))
            envs = json.loads(app.envs_json)
            envs.update(json.loads(req.envs_json))
            app.envs_json = json.dumps(envs)
            parts = list(self._parts[app.app_id])
            self._persist_locked()
        self._push_app_envs(app, parts)
        return codec.encode(mm.SetAppEnvsResponse())

    def _push_app_envs(self, app, parts) -> None:
        """Spread app envs to every serving node (reference: meta spreads
        app envs to replicas which hot-apply them,
        pegasus_server_impl.cpp:2406). The nodes are pushed to at once,
        each node's partitions in order: an env that triggers a manual
        compaction runs it inside the node's open RPC, so a sequential
        push would compact the whole cluster one replica at a time."""
        per_node = {}
        for pc in parts:
            req = mm.OpenReplicaRequest(
                app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
                ballot=pc.ballot, primary=pc.primary,
                secondaries=pc.secondaries, envs_json=app.envs_json,
                partition_count=app.partition_count)
            for node in [pc.primary] + pc.secondaries:
                if node:
                    per_node.setdefault(node, []).append(req)
        if not per_node:
            return

        def push(node):
            for req in per_node[node]:
                self._send_to_node(node, RPC_OPEN_REPLICA, req,
                                   ignore_errors=True)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(per_node),
                                thread_name_prefix="meta-push") as ex:
            list(ex.map(push, per_node))

    def _on_list_nodes(self, header, body) -> bytes:
        with self._lock:
            nodes = []
            now = time.monotonic()
            for addr, last in self._nodes.items():
                nodes.append(mm.NodeInfo(
                    address=addr, alive=(now - last) < self.fd_grace,
                    last_beacon_ms=int(last * 1000),
                    replica_count=sum(
                        1 for parts in self._parts.values() for pc in parts
                        if pc.primary == addr or addr in pc.secondaries)))
            return codec.encode(mm.ListNodesResponse(nodes=nodes))

    # ------------------------------------------------------------------- FD

    def _on_beacon(self, header, body) -> bytes:
        req = codec.decode(mm.BeaconRequest, body)
        with self._lock:
            self._nodes[req.node] = time.monotonic()
            # what the node actually holds
            self._node_replicas[req.node] = set(req.alive_replicas)
            # per-replica lag/audit states (the cluster doctor's input);
            # in-memory only, like the liveness map — re-beacons rebuild it
            states = {}
            tables = {}
            for item in req.replica_states:
                try:
                    st = json.loads(item)
                    if st.get("status") == "TABLE_STATS":
                        # tenant-ledger fragments of a node ride the
                        # beacon but are NOT replica states — divert them
                        # so every per-gpid consumer (doctor lag fold,
                        # quarantine repair, scheduler debt) keeps its
                        # replicas-only invariant
                        tables[st["gpid"]] = st
                    else:
                        states[st["gpid"]] = st
                except (ValueError, KeyError, TypeError):
                    continue
            self._node_states[req.node] = states
            self._node_tables[req.node] = tables
        # deliberately NO _persist() here: beacons reach followers too
        # (the leader-only RPC guard exempts RPC_FD_BEACON so takeover
        # starts with a warm liveness map), and _load() rebuilds _nodes
        # from re-beacons anyway — a follower persisting its stale DDL
        # snapshot on first sight of a node would clobber every DDL the
        # leader acked since the follower's last reload
        return codec.encode(mm.BeaconResponse(allowed=True))

    def reload_state(self) -> None:
        """Takeover path: re-read the shared state file so every DDL the
        previous leader acknowledged (persist-before-ack) is visible here.
        The liveness map is kept — followers absorb beacons, so takeover
        does not re-declare every node dead."""
        with self._lock:
            nodes, node_reps = self._nodes, self._node_replicas
            self._apps, self._parts = {}, {}
            self._dups, self._policies, self._dropped = {}, {}, {}
            self._load()
            self._nodes, self._node_replicas = nodes, node_reps

    def check_leases(self) -> list:
        """Expire dead nodes and reconfigure their partitions. Returns the
        list of nodes declared dead. Call from a timer (or tests)."""
        if self.level == "stopped":
            return []
        now = time.monotonic()
        with self._lock:
            dead = [a for a, last in self._nodes.items()
                    if (now - last) >= self.fd_grace]
        for node in dead:
            self._handle_node_death(node)
        return dead

    def mark_node_dead(self, addr: str) -> None:
        """Force-expire (tests / admin)."""
        with self._lock:
            if addr in self._nodes:
                self._nodes[addr] = -1e18
        self._handle_node_death(addr)

    def forget_node(self, addr: str) -> None:
        """Drop a DEAD node from the liveness map entirely (admin /
        chaos heal): the node was replaced by one on a new address
        rather than restarted, so its tombstone must not read as a
        permanent 'node dead' health cause. A forgotten node that
        beacons again simply re-registers."""
        with self._lock:
            self._nodes.pop(addr, None)
            self._node_replicas.pop(addr, None)
            self._node_states.pop(addr, None)
            self._node_tables.pop(addr, None)

    # ---------------------------------------------------------- failover

    def _handle_node_death(self, node: str) -> None:
        with self._lock:
            # drop the dead node's beacon-folded lag/audit states: frozen
            # values would otherwise feed the doctor's lag fold forever
            # (a rejoining node re-beacons them). _node_replicas is KEPT —
            # ddd_diagnose hunts candidates on dead nodes through it.
            self._node_states.pop(node, None)
            self._node_tables.pop(node, None)
            moves = []
            for app in self._apps.values():
                for pc in self._parts[app.app_id]:
                    if pc.primary == node or node in pc.secondaries:
                        moves.append((app, pc))
        for app, pc in moves:
            self._reconfigure_partition(app, pc, dead=node)

    def _reconfigure_partition(self, app: mm.AppInfo, pc: mm.PartitionConfig,
                               dead: str) -> None:
        with self._lock:
            members = [m for m in [pc.primary] + pc.secondaries if m != dead]
            if not members:
                pc.primary = ""
                pc.secondaries = []
                self._persist_locked()
                return
            pc.ballot += 1
            if pc.primary == dead:
                # promote the secondary with the longest prepared log
                best, best_state = None, (-1, -1)
                for m in members:
                    st = self._query_replica_state(m, app.app_id, pc.pidx)
                    if st is not None and (st.ballot, st.last_prepared) > best_state:
                        best, best_state = m, (st.ballot, st.last_prepared)
                pc.primary = best or members[0]
            pc.secondaries = [m for m in members if m != pc.primary]
            # rebuild replica count on a fresh node — unless the operator
            # froze meta-initiated data movement (get/set_meta_level)
            learners = []
            alive = self._alive_nodes_locked()
            candidates = [n for n in alive if n not in members]
            if (self.level != "freezed"
                    and len(members) < app.replica_count and candidates):
                new_node = min(candidates, key=self._node_load_locked)
                learners = [new_node]
            self._persist_locked()
        self._install_partition(app, pc, learners=learners)
        if learners:
            with self._lock:
                for ln in learners:
                    if ln not in pc.secondaries:
                        pc.secondaries.append(ln)
                self._persist_locked()
            # Re-push the updated view so the primary's in-memory membership
            # includes the new member and it starts receiving prepares;
            # without this the learner is fresh only as of the learn snapshot
            # while meta reports it as a full secondary.
            self._install_partition(app, pc)

    def repair_under_replication(self) -> int:
        """Re-seed lost replicas onto alive nodes — the healing half of
        `_reconfigure_partition`'s learner path (reference meta's
        partition-guardian cure role). A node death with no spare node
        leaves partitions under-replicated: at death time every alive
        node was already a member, and nothing re-examines the partition
        when a replacement (or the restarted node itself) later joins.
        The port's MetaApp runs this on its failure-detector tick, so a
        restarted node is re-added and relearns. Partitions repair
        concurrently (REPAIR_WORKERS at a time): each seed is a whole
        learn inside one open RPC. Returns the number of partitions a
        learner was seeded for."""
        if self.level in ("stopped", "blind", "freezed"):
            return 0
        with self._lock:
            work = [(app, pc) for app in self._apps.values()
                    for pc in self._parts[app.app_id]]
        if not work:
            return 0
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(self.REPAIR_WORKERS, len(work)),
                                thread_name_prefix="meta-repair") as ex:
            return sum(ex.map(lambda w: self._repair_partition(*w), work))

    def _repair_partition(self, app, pc: mm.PartitionConfig) -> int:
        """One partition's repair pass: -> 1 if a learner was admitted."""
        with self._lock:
            alive = self._alive_nodes_locked()
            if not pc.primary or pc.primary not in alive:
                return 0  # dead primary is _handle_node_death's job
            members = [m for m in [pc.primary] + pc.secondaries if m]
            live = [m for m in members if m in alive]
            candidates = [n for n in alive if n not in members]
            if len(live) >= app.replica_count or not candidates:
                return 0
            new_node = min(candidates, key=self._node_load_locked)
            pc.ballot += 1
            self._persist_locked()
        # learn is synchronous inside the open RPC: the learner copies
        # the primary's checkpoint + log tail before we admit it — a
        # failed seed (target mid-restart) must NOT be admitted, or a
        # hollow "secondary" reads as healthy and a later promotion
        # loses acked writes; the next repair pass retries
        if not self._install_partition(app, pc, learners=[new_node]):
            return 0
        with self._lock:
            if new_node not in pc.secondaries:
                pc.secondaries.append(new_node)
            self._persist_locked()
        # re-push the view so the primary's in-memory membership
        # includes the admitted member (same reason as the failover
        # learner path above)
        self._install_partition(app, pc)
        return 1

    def _install_partition(self, app, pc: mm.PartitionConfig, learners=()):
        """Push the view to every member (primary first), seed learners.
        -> True when every learner's seeding open succeeded (the learn is
        synchronous inside the open RPC, so a non-error reply means the
        checkpoint + log tail were copied); member pushes stay
        best-effort."""
        req = mm.OpenReplicaRequest(
            app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
            ballot=pc.ballot, primary=pc.primary, secondaries=pc.secondaries,
            envs_json=app.envs_json, partition_count=app.partition_count)
        for node in [pc.primary] + pc.secondaries:
            if node:
                self._send_to_node(node, RPC_OPEN_REPLICA, req,
                                   ignore_errors=True)
        seeded = True
        for node in learners:
            lreq = mm.OpenReplicaRequest(
                app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
                ballot=pc.ballot, primary=pc.primary,
                secondaries=pc.secondaries + [node],
                learn_from=pc.primary, envs_json=app.envs_json,
                partition_count=app.partition_count)
            try:
                self._send_to_node(node, RPC_OPEN_REPLICA, lreq)
            except (RpcError, OSError) as e:
                # seed failures are retried by the caller's next pass, but
                # never silently: an operator chasing "why does this
                # partition stay under-replicated" needs the learner's
                # actual error (PEGASUS_REPAIR_DEBUG=1)
                if os.environ.get("PEGASUS_REPAIR_DEBUG"):
                    print(f"[meta] seed {app.app_name}.{pc.pidx} learner "
                          f"{node} failed: {e!r}"[:400], flush=True)
                seeded = False
        return seeded

    # ------------------------------------------------------------- helpers

    def _query_replica_state(self, node, app_id, pidx):
        try:
            body = self._send_to_node(node, RPC_REPLICA_STATE,
                                      mm.ReplicaStateRequest(app_id, pidx))
            return codec.decode(mm.ReplicaStateResponse, body)
        except (RpcError, OSError):
            return None

    def _send_to_node(self, node: str, code: str, req, ignore_errors=False,
                      app_id: int = 0, pidx: int = 0):
        # per-partition lifecycle requests carry their own (app_id, pidx);
        # lift them into the RPC header so a partition-group serving node
        # (replication/serve_groups.py) routes the frame without decoding
        # the body
        if app_id == 0 and pidx == 0:
            app_id = getattr(req, "app_id", 0) or 0
            pidx = getattr(req, "pidx", 0) or 0
        host, _, port = node.rpartition(":")
        try:
            conn = self.pool.get((host, int(port)))
            _, body = conn.call(code, codec.encode(req), timeout=60.0,
                                app_id=app_id, partition_index=pidx)
            return body
        except (RpcError, OSError):
            if ignore_errors:
                return None
            raise

    def _alive_nodes_locked(self) -> list:
        now = time.monotonic()
        return sorted(a for a, last in self._nodes.items()
                      if (now - last) < self.fd_grace)

    def _node_load_locked(self, addr: str) -> int:
        return sum(1 for parts in self._parts.values() for pc in parts
                   if pc.primary == addr or addr in pc.secondaries)

    def _pick_nodes_locked(self, count: int, seed: int) -> list:
        alive = self._alive_nodes_locked()
        ordered = sorted(alive, key=lambda a: (self._node_load_locked(a), a))
        rot = ordered[seed % len(ordered):] + ordered[:seed % len(ordered)]
        return rot[:count]

    # ------------------------------------------------------------ persistence

    def _persist(self):
        with self._lock:
            self._persist_locked()

    def _persist_locked(self):
        if self.election is not None:
            # fencing: a leader stalled past its lease (GIL pause, NFS
            # hang) must not clobber state a newer leader wrote. Re-verify
            # the lease at the last moment, and refuse to overwrite a
            # state file carrying a newer epoch than ours. Both fences
            # RAISE: the caller is an acking DDL handler and persist-
            # before-ack is the HA contract — a swallowed fence would ack
            # a write that never became durable. The RPC layer turns the
            # raise into an error reply; clients retry against the real
            # leader.
            if not self.election.verify_for_persist():
                print(f"[meta] {self.election.my_addr}: persist fenced — "
                      "lease lost", flush=True)
                raise RuntimeError("meta persist fenced: lease lost")
            disk_epoch = self._disk_state_epoch_locked()
            if disk_epoch > self.election.epoch:
                print(f"[meta] {self.election.my_addr}: persist fenced — "
                      f"state epoch {disk_epoch} > lease epoch "
                      f"{self.election.epoch}", flush=True)
                self.election._set_leader(False)
                # release the lease carrying the NEWER lineage forward so
                # the next claim (ours or anyone's) exceeds the state
                # epoch and can persist again — fence-and-hold would
                # livelock: the lease still names us, every tick would
                # re-promote, every persist would re-fence
                self.election.release_lease(disk_epoch)
                raise RuntimeError(
                    f"meta persist fenced: state epoch {disk_epoch} newer")
        state = {
            "epoch": (self.election.epoch if self.election is not None
                      else self._state_epoch),
            "next_app_id": self._next_app_id,
            "next_dupid": self._next_dupid,
            "apps": {n: vars(a) for n, a in self._apps.items()},
            "parts": {str(aid): [vars(pc) for pc in parts]
                      for aid, parts in self._parts.items()},
            "nodes": list(self._nodes),
            "dups": {str(aid): entries for aid, entries in self._dups.items()},
            "policies": self._policies,
            "dropped": {str(aid): e for aid, e in self._dropped.items()},
            "level": self.level,
        }
        tmp = self.state_path + ".tmp"
        os.makedirs(os.path.dirname(self.state_path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            st = os.fstat(f.fileno())
        os.replace(tmp, self.state_path)
        self._state_epoch = int(state["epoch"])
        # fingerprint from the fd we WROTE, never a path re-stat: a racer's
        # replace landing between our os.replace and a stat would get
        # fingerprinted with OUR cached epoch and permanently disarm the
        # persist fence (rename keeps tmp's inode, so fstat matches the
        # file now at state_path — unless someone else already replaced it,
        # which is exactly the case that must MISS the cache)
        self._state_fp = (st.st_ino, st.st_mtime_ns, st.st_size)

    def _disk_state_epoch_locked(self) -> int:
        """The on-disk state epoch for the persist fence, WITHOUT re-parsing
        the whole state file on every acked DDL (ADVICE r5: that parse is
        O(state size) per persist). The cached epoch is valid as long as the
        file's stat fingerprint still matches what this process last
        read/wrote; any external write (a newer leader's persist, a manual
        edit) changes inode/mtime/size and forces one full re-read — so the
        epoch fence still catches exactly the writes it existed for."""
        try:
            st = os.stat(self.state_path)
            fp = (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            return 0
        if fp != self._state_fp:
            self._state_epoch = self._read_state_epoch()
            self._state_fp = fp
        return self._state_epoch

    def _read_state_epoch(self) -> int:
        try:
            with open(self.state_path) as f:
                return int(json.load(f).get("epoch", 0))
        except (OSError, ValueError):
            return 0

    def _load(self):
        if not os.path.exists(self.state_path):
            return
        with open(self.state_path) as f:
            state = json.load(f)
            st = os.fstat(f.fileno())  # the file we READ, race-free
        self._state_epoch = int(state.get("epoch", 0))
        self._state_fp = (st.st_ino, st.st_mtime_ns, st.st_size)
        self._next_app_id = state["next_app_id"]
        self._next_dupid = state.get("next_dupid", 1)
        self._apps = {n: mm.AppInfo(**a) for n, a in state["apps"].items()}
        self._parts = {int(aid): [mm.PartitionConfig(**pc) for pc in parts]
                       for aid, parts in state["parts"].items()}
        self._dups = {int(aid): entries
                      for aid, entries in state.get("dups", {}).items()}
        self._policies = state.get("policies", {})
        self._dropped = {int(aid): e
                         for aid, e in state.get("dropped", {}).items()}
        self.level = state.get("level", "lively")
        # nodes must re-beacon after a meta restart
        self._nodes = {}
