"""Meta server: table DDL, partition->replica mapping, beacon FD, failover.

Port of pegasus_tpu/meta/meta_server.py (the rDSN meta-server role): app
state and partition configs live here, persisted to a JSON state file
that both packages read and write (a port meta loads a reference meta's
state.json and the other way round); replica nodes register via beacons
with lease/grace semantics, and node death triggers reconfiguration:
promote the surviving secondary with the longest prepared log, then
rebuild the replica count by seeding a learner on an under-loaded node.

Served: create, drop, list and query-config of apps, app envs, list
nodes, the meta level, the beacon, the cluster-state snapshot the doctor
and the compaction scheduler fold, and the table lifecycle: partition
split, cold backup and restore, meta-driven bulk-load sessions and
backup policies (run by the meta app's policy timer). Not ported yet, so
their codes stay unregistered and answer ERR_HANDLER_NOT_FOUND:
duplication, recall and purge of dropped apps, recover, ddd_diagnose,
balance and propose. The
state file's entries for those planes (duplications, soft-dropped apps)
are kept as loaded and written back unchanged.
"""

import json
import os
import threading
import time

from ..rpc import codec
from ..rpc.transport import (ConnectionPool, ERR_FORWARD_TO_PRIMARY,
                             ERR_INVALID_STATE, RpcError)
from ..runtime.tasking import spawn_thread
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
    # split children seeding at once, each in its own order (primary,
    # then its secondaries); the reference seeds one child after another
    SPLIT_SEED_WORKERS = 8
    # partitions a bulk-load session ingests at once; the reference walks
    # them one by one
    BULK_LOAD_WORKERS = 8

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
        self._policies = {}      # name -> dict (BackupPolicyInfo fields)
        self._bulk_loads = {}    # app_id -> bulk-load session dict
        self._restores = {}      # new_app_name -> restore status dict
        # planes not ported yet, kept as loaded so the state file
        # round-trips: duplication entries, soft drops
        self._dups = {}          # app_id -> list[dict] duplication entries
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
            RPC_CM_QUERY_CLUSTER_STATE: self._on_query_cluster_state,
            RPC_CM_SET_APP_ENVS: self._on_set_app_envs,
            RPC_CM_LIST_NODES: self._on_list_nodes,
            RPC_CM_SPLIT_APP: self._on_split_app,
            RPC_CM_BACKUP_APP: self._on_backup_app,
            RPC_CM_RESTORE_APP: self._on_restore_app,
            RPC_CM_START_BULK_LOAD: self._on_start_bulk_load,
            RPC_CM_QUERY_BULK_LOAD: self._on_query_bulk_load,
            RPC_CM_CONTROL_BULK_LOAD: self._on_control_bulk_load,
            RPC_CM_QUERY_RESTORE: self._on_query_restore,
            RPC_CM_ADD_BACKUP_POLICY: self._on_add_backup_policy,
            RPC_CM_LS_BACKUP_POLICY: self._on_ls_backup_policy,
            RPC_CM_MODIFY_BACKUP_POLICY: self._on_modify_backup_policy,
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

    def _on_query_cluster_state(self, header, body) -> bytes:
        """One-RPC cluster snapshot: node liveness, every app's partition
        config and the beacon-folded per-replica lag, audit and compaction
        debt states; what the cluster doctor and the compaction scheduler
        fold. Served at level `blind` too (a pure query). `dups` stays {}
        until duplication is ported."""
        with self._lock:
            now = time.monotonic()
            nodes = {addr: {"alive": (now - last) < self.fd_grace,
                            "last_beacon_ago_s": round(now - last, 3)}
                     for addr, last in self._nodes.items()}
            apps = {}
            for app in self._apps.values():
                apps[app.app_name] = {
                    "app_id": app.app_id,
                    "partition_count": app.partition_count,
                    "replica_count": app.replica_count,
                    "partitions": [{
                        "pidx": pc.pidx, "ballot": pc.ballot,
                        "primary": pc.primary,
                        "secondaries": list(pc.secondaries)}
                        for pc in self._parts[app.app_id]]}
            state = {"nodes": nodes, "apps": apps,
                     "replica_states": {n: dict(s) for n, s
                                        in self._node_states.items()},
                     "dups": {},
                     "meta_level": self.level}
        return codec.encode(mm.QueryClusterStateResponse(
            state_json=json.dumps(state)))

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

    # ------------------------------------------------------ split/backup/load

    def _on_split_app(self, header, body) -> bytes:
        """Online partition split: double the partition count (SURVEY §2.4
        'Partition split'; reference meta split + engine-side stale-key GC).
        Child partition pidx+n is seeded from parent pidx via the learn
        path on the same member set; every replica then gets
        partition_version = 2n-1 so compaction GCs keys it no longer owns
        (key_ttl_compaction_filter.h:107 analogue)."""
        req = codec.decode(mm.SplitAppRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.SplitAppResponse(error=1,
                                                        error_text="no such app"))
            parts = self._parts[app.app_id]
            envs = json.loads(app.envs_json)
            pending = envs.get("replica.split_pending")
            if pending is not None:
                # RESUME an incomplete split (the retry the seeding-failure
                # error text promises): the count is already doubled and
                # the child configs installed — re-drive phase 2 for the
                # existing children instead of doubling again
                old_n, new_n = int(pending), app.partition_count
                children = [(parts[p - old_n], parts[p])
                            for p in range(old_n, new_n)]
            else:
                old_n = app.partition_count
                new_n = 2 * old_n
                children = []
                for pidx in range(old_n, new_n):
                    parent = parts[pidx - old_n]
                    pc = mm.PartitionConfig(
                        pidx=pidx, ballot=1, primary=parent.primary,
                        secondaries=list(parent.secondaries))
                    parts.append(pc)
                    children.append((parent, pc))
                app.partition_count = new_n
                # the resume marker rides the app envs (persisted with
                # the config) until phase 3 declares seeding complete
                envs["replica.split_pending"] = str(old_n)
                app.envs_json = json.dumps(envs)
            parents = list(parts[:old_n])
            self._persist_locked()
        n = old_n
        from ..runtime import events

        events.emit("split.phase", severity="warn",
                    phase="resume" if pending is not None else "start",
                    app=req.app_name, old_n=old_n, new_n=2 * old_n)
        # Phase 1: parents learn the NEW partition count FIRST, so any write
        # still routed with the old count but belonging to a child half is
        # rejected from here on (client re-resolves). Writes accepted before
        # this point precede the child learn below and are carried by it —
        # no write can fall between the two.
        for pc in parents:
            self._install_partition(app, pc)
        # Phase 2: seed each child's PRIMARY from the parent's primary
        # (full-copy learn), then each child SECONDARY from the child
        # primary — ONE history source. Seeding every member from the
        # parent directly looks equivalent but is not under live load:
        # the parent advances between the independent learns, so two
        # members could snapshot different parent decrees and the gap
        # mutations exist in neither the later learner's checkpoint nor
        # the child primary's plog — decrees align again through the
        # prepare stream while the CONTENT stays divergent forever (the
        # decree-anchored audit caught exactly this under chaos load).
        # Failures are fatal for the split: the stale-key GC mask must
        # not spread unless every child holds its half.
        def seed(item) -> bool:
            parent, pc = item
            req_primary = mm.OpenReplicaRequest(
                app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
                ballot=pc.ballot, primary=pc.primary,
                secondaries=pc.secondaries, envs_json=app.envs_json,
                partition_count=2 * n, learn_from=parent.primary,
                learn_pidx=parent.pidx)
            if self._send_to_node(pc.primary, RPC_OPEN_REPLICA, req_primary,
                                  ignore_errors=True) is None:
                return False
            req_secondary = mm.OpenReplicaRequest(
                app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
                ballot=pc.ballot, primary=pc.primary,
                secondaries=pc.secondaries, envs_json=app.envs_json,
                partition_count=2 * n, learn_from=pc.primary,
                learn_pidx=pc.pidx)
            ok = True
            for node in pc.secondaries:
                if self._send_to_node(node, RPC_OPEN_REPLICA, req_secondary,
                                      ignore_errors=True) is None:
                    ok = False
            return ok

        # each seed is whole learns inside open RPCs: a child's learns run
        # beside other children's, across the nodes
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(1, min(self.SPLIT_SEED_WORKERS,
                                           len(children))),
                                thread_name_prefix="meta-split") as ex:
            seeded = all(list(ex.map(seed, children)))
        if not seeded:
            events.emit("split.phase", severity="error",
                        phase="seed_incomplete", app=req.app_name,
                        new_n=2 * n)
            return codec.encode(mm.SplitAppResponse(
                error=1, new_partition_count=2 * n,
                error_text="child seeding incomplete; GC mask withheld — "
                           "re-run split to retry"))
        # Phase 3: with every child seeded, spread the ownership mask so
        # compaction GCs keys each partition no longer owns.
        with self._lock:
            envs = json.loads(app.envs_json)
            envs.pop("replica.split_pending", None)
            envs["replica.partition_version"] = str(2 * n - 1)
            app.envs_json = json.dumps(envs)
            all_parts = list(self._parts[app.app_id])
            self._persist_locked()
        for pc in all_parts:
            self._install_partition(app, pc)
        events.emit("split.phase", phase="complete", app=req.app_name,
                    new_n=2 * n)
        return codec.encode(mm.SplitAppResponse(new_partition_count=2 * n))

    def _on_backup_app(self, header, body) -> bytes:
        """Cold backup: every partition primary checkpoints into the backup
        root (block-service local-FS provider), then backup metadata lands
        beside them (reference cold backup to block service, SURVEY §2.4)."""
        req = codec.decode(mm.BackupAppRequest, body)
        err, backup_id = self._do_backup(req.app_name, req.backup_root)
        if err:
            return codec.encode(mm.BackupAppResponse(error=1, error_text=err))
        return codec.encode(mm.BackupAppResponse(backup_id=backup_id))

    def _do_backup(self, app_name: str, backup_root: str,
                   backup_id: int = None):
        """-> (error_text or None, backup_id). One full app backup into
        backup_root/<backup_id>/<app_name>/<pidx>/ + backup_metadata."""
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return "no such app", 0
            parts = list(self._parts[app.app_id])
        backup_id = backup_id or int(time.time() * 1000)
        # replicas resolve this path through a block service rooted at "/";
        # absolutize here so a relative root means the same tree everywhere
        base = os.path.join(os.path.abspath(backup_root),
                            str(backup_id), app_name)
        for pc in parts:
            dest = os.path.join(base, str(pc.pidx))
            out = self._send_to_node(pc.primary, RPC_COLD_BACKUP,
                                     mm.OpenReplicaRequest(
                                         app_id=app.app_id, pidx=pc.pidx,
                                         restore_dir=dest),
                                     ignore_errors=True)
            if out is None:
                return f"partition {pc.pidx} backup failed", 0
        with open(os.path.join(base, "backup_metadata"), "w") as f:
            json.dump({"app_name": app.app_name, "app_id": app.app_id,
                       "partition_count": app.partition_count,
                       "backup_id": backup_id, "envs_json": app.envs_json}, f)
        return None, backup_id

    def _on_restore_app(self, header, body) -> bytes:
        """Restore a backup into a NEW table: create the app with the
        backed-up partition count, each replica seeding its engine from the
        backup dir at open (reference restore envs ROCKSDB_ENV_RESTORE_*,
        pegasus_server_impl.cpp:1339-1393)."""
        req = codec.decode(mm.RestoreAppRequest, body)
        backup_root = os.path.abspath(req.backup_root)
        meta_file = os.path.join(backup_root, str(req.backup_id),
                                 req.old_app_name, "backup_metadata")
        try:
            with open(meta_file) as f:
                bmeta = json.load(f)
        except OSError:
            return codec.encode(mm.RestoreAppResponse(
                error=1, error_text=f"no backup metadata at {meta_file}"))
        with self._lock:
            if req.new_app_name in self._apps:
                return codec.encode(mm.RestoreAppResponse(
                    error=1, error_text="app exists"))
            alive = self._alive_nodes_locked()
            if not alive:
                return codec.encode(mm.RestoreAppResponse(
                    error=1, error_text="no alive nodes"))
            app = mm.AppInfo(app_name=req.new_app_name,
                             app_id=self._next_app_id,
                             partition_count=bmeta["partition_count"],
                             replica_count=min(3, len(alive)),
                             envs_json=bmeta.get("envs_json", "{}"))
            self._next_app_id += 1
            self._apps[req.new_app_name] = app
            parts = []
            for pidx in range(app.partition_count):
                members = self._pick_nodes_locked(app.replica_count, pidx)
                parts.append(mm.PartitionConfig(pidx=pidx, ballot=1,
                                                primary=members[0],
                                                secondaries=members[1:]))
            self._parts[app.app_id] = parts
            self._persist_locked()
        self._restores[app.app_name] = {
            "status": "restoring", "backup_id": req.backup_id,
            "old_app": req.old_app_name, "done": 0,
            "total": app.partition_count}
        # every node restores its replicas in partition order, the nodes
        # at once (the reference opens one replica after another)
        per_node = {}
        for pc in parts:
            src = os.path.join(backup_root, str(req.backup_id),
                               req.old_app_name, str(pc.pidx))
            req_open = mm.OpenReplicaRequest(
                app_name=app.app_name, app_id=app.app_id, pidx=pc.pidx,
                ballot=pc.ballot, primary=pc.primary,
                secondaries=pc.secondaries, envs_json=app.envs_json,
                partition_count=app.partition_count, restore_dir=src)
            for node in [pc.primary] + pc.secondaries:
                per_node.setdefault(node, []).append(req_open)

        def restore(node):
            for req_open in per_node[node]:
                self._send_to_node(node, RPC_OPEN_REPLICA, req_open,
                                   ignore_errors=True)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max(1, len(per_node)),
                                thread_name_prefix="meta-restore") as ex:
            list(ex.map(restore, per_node))
        self._restores[app.app_name]["done"] = app.partition_count
        self._restores[app.app_name]["status"] = "ok"
        return codec.encode(mm.RestoreAppResponse(app_id=app.app_id))

    def _on_start_bulk_load(self, header, body) -> bytes:
        """Meta-driven bulk load: validate provider metadata, then each
        partition primary ingests its set (reference bulk-load DDL,
        SURVEY §2.4 'Bulk load framework'). async_start runs the partition
        walk as a controllable session (pause/restart/cancel/query, the
        reference's bulk-load state machine surface, shell bulk_load.cpp);
        the default stays synchronous."""
        from ..engine import bulk_load as bl

        req = codec.decode(mm.StartBulkLoadRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.StartBulkLoadResponse(
                    error=1, error_text="no such app"))
            sess = self._bulk_loads.get(app.app_id)
            if sess and sess["status"] in ("downloading", "ingesting",
                                           "paused"):
                return codec.encode(mm.StartBulkLoadResponse(
                    error=1, error_text="bulk load already in progress"))
        provider_root = os.path.abspath(req.provider_root)
        try:
            with open(bl.metadata_path(provider_root, req.app_name)) as f:
                bmeta = json.load(f)
        except OSError:
            return codec.encode(mm.StartBulkLoadResponse(
                error=1, error_text="no bulk_load_metadata"))
        if bmeta["partition_count"] != app.partition_count:
            return codec.encode(mm.StartBulkLoadResponse(
                error=1, error_text="partition count mismatch"))
        sess = {"status": "ingesting", "done": 0, "next": 0,
                "total": app.partition_count, "ingested": 0,
                "error_text": "", "provider_root": provider_root,
                "app_name": req.app_name}
        with self._lock:
            self._bulk_loads[app.app_id] = sess
        if req.async_start:
            spawn_thread(self._bulk_load_worker, app, sess, daemon=True,
                         name=f"bulk-load:{app.app_name}")
            return codec.encode(mm.StartBulkLoadResponse())
        self._bulk_load_worker(app, sess)
        if sess["status"] != "succeed":
            return codec.encode(mm.StartBulkLoadResponse(
                error=1, error_text=sess["error_text"] or sess["status"]))
        return codec.encode(mm.StartBulkLoadResponse(
            ingested_records=sess["ingested"]))

    def _bulk_load_worker(self, app, sess) -> None:
        """Walk the partitions, BULK_LOAD_WORKERS at a time, honoring
        pause/cancel between them (an ingest that started finishes)."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.BULK_LOAD_WORKERS,
                                thread_name_prefix="bulk-load") as ex:
            list(ex.map(lambda _: self._bulk_load_walk(app, sess),
                        range(self.BULK_LOAD_WORKERS)))
        with self._lock:
            if sess["status"] == "ingesting" and \
                    sess["done"] >= sess["total"]:
                sess["status"] = "succeed"

    def _bulk_load_walk(self, app, sess) -> None:
        """One of the session's walkers: take the next partition, ingest
        it through its primary, until none is left or the session stops."""
        from ..rpc import messages as rpc_msg
        from ..rpc.task_codes import RPC_BULK_LOAD_INGEST

        while True:
            with self._lock:
                status = sess["status"]
                if status in ("canceled", "failed"):
                    return
                if status != "paused":
                    if sess["next"] >= sess["total"]:
                        return
                    pc = self._parts[app.app_id][sess["next"]]
                    sess["next"] += 1
            if status == "paused":
                time.sleep(0.05)
                continue
            ingest = rpc_msg.BulkLoadIngestRequest(
                provider_root=sess["provider_root"],
                app_name=sess["app_name"],
                partition_count=app.partition_count)
            # route through the primary's WRITE path: the ingestion command
            # replicates via PacificA so every replica loads the set at the
            # same decree (survives failover)
            out = self._send_to_node(pc.primary, RPC_BULK_LOAD_INGEST, ingest,
                                     app_id=app.app_id, pidx=pc.pidx,
                                     ignore_errors=True)
            resp = (codec.decode(rpc_msg.BulkLoadIngestResponse, out)
                    if out is not None else None)
            with self._lock:
                if resp is None or resp.error:
                    if sess["status"] != "failed":
                        sess["status"] = "failed"
                        sess["error_text"] = (f"partition {pc.pidx} ingest "
                                              + ("failed" if resp is None
                                                 else "error"))
                    return
                sess["ingested"] += resp.ingested_records
                sess["done"] += 1

    def _on_query_bulk_load(self, header, body) -> bytes:
        req = codec.decode(mm.QueryBulkLoadRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.QueryBulkLoadResponse(
                    error=1, error_text="no such app"))
            sess = self._bulk_loads.get(app.app_id)
            if sess is None:
                return codec.encode(mm.QueryBulkLoadResponse(status="none"))
            return codec.encode(mm.QueryBulkLoadResponse(
                status=sess["status"], done_partitions=sess["done"],
                total_partitions=sess["total"],
                ingested_records=sess["ingested"],
                error_text=sess["error_text"]))

    def _on_query_restore(self, header, body) -> bytes:
        """query_restore_status <new_app> (reference restore.cpp
        query_restore_status)."""
        req = codec.decode(mm.QueryRestoreRequest, body)
        with self._lock:
            info = self._restores.get(req.app_name)
        if info is None:
            return codec.encode(mm.QueryRestoreResponse(status="none"))
        return codec.encode(mm.QueryRestoreResponse(
            status=info["status"], backup_id=info["backup_id"],
            old_app_name=info["old_app"], done_partitions=info["done"],
            total_partitions=info["total"]))

    def _on_control_bulk_load(self, header, body) -> bytes:
        """pause_bulk_load / restart_bulk_load / cancel_bulk_load
        (reference shell bulk_load.cpp control verbs)."""
        req = codec.decode(mm.ControlBulkLoadRequest, body)
        with self._lock:
            app = self._apps.get(req.app_name)
            if app is None:
                return codec.encode(mm.ControlBulkLoadResponse(
                    error=1, error_text="no such app"))
            sess = self._bulk_loads.get(app.app_id)
            if sess is None:
                return codec.encode(mm.ControlBulkLoadResponse(
                    error=1, error_text="no bulk load session"))
            cur = sess["status"]
            if req.action == "pause":
                if cur != "ingesting":
                    return codec.encode(mm.ControlBulkLoadResponse(
                        error=1, error_text=f"cannot pause ({cur})"))
                sess["status"] = "paused"
            elif req.action == "restart":
                if cur != "paused":
                    return codec.encode(mm.ControlBulkLoadResponse(
                        error=1, error_text=f"cannot restart ({cur})"))
                sess["status"] = "ingesting"
            elif req.action == "cancel":
                if cur not in ("ingesting", "paused", "failed"):
                    return codec.encode(mm.ControlBulkLoadResponse(
                        error=1, error_text=f"cannot cancel ({cur})"))
                sess["status"] = "canceled"
            else:
                return codec.encode(mm.ControlBulkLoadResponse(
                    error=1, error_text=f"unknown action {req.action!r}"))
        return codec.encode(mm.ControlBulkLoadResponse())

    # ------------------------------------------------------- backup policies

    def _on_add_backup_policy(self, header, body) -> bytes:
        req = codec.decode(mm.AddBackupPolicyRequest, body)
        p = req.policy
        with self._lock:
            if p.name in self._policies:
                return codec.encode(mm.AddBackupPolicyResponse(
                    error=1, error_text=f"policy {p.name} exists"))
            if not p.name or not p.backup_root or not p.apps:
                return codec.encode(mm.AddBackupPolicyResponse(
                    error=1, error_text="name, backup_root and apps required"))
            missing = [a for a in p.apps if a not in self._apps]
            if missing:
                return codec.encode(mm.AddBackupPolicyResponse(
                    error=1, error_text=f"no such app(s): {missing}"))
            self._policies[p.name] = {
                "name": p.name, "backup_root": p.backup_root,
                "apps": list(p.apps),
                "interval_seconds": max(1, p.interval_seconds),
                "history_count": max(1, p.history_count),
                "enabled": bool(p.enabled),
                "next_backup_ts": int(p.next_backup_ts),
                "recent_backup_ids": []}
            self._persist_locked()
        return codec.encode(mm.AddBackupPolicyResponse())

    def _on_ls_backup_policy(self, header, body) -> bytes:
        req = codec.decode(mm.LsBackupPolicyRequest, body)
        with self._lock:
            if req.name:
                pols = [self._policies[req.name]] \
                    if req.name in self._policies else []
                if not pols:
                    return codec.encode(mm.LsBackupPolicyResponse(
                        error=1, error_text=f"no policy {req.name}"))
            else:
                pols = list(self._policies.values())
            return codec.encode(mm.LsBackupPolicyResponse(
                policies=[mm.BackupPolicyInfo(**p) for p in pols]))

    def _on_modify_backup_policy(self, header, body) -> bytes:
        req = codec.decode(mm.ModifyBackupPolicyRequest, body)
        with self._lock:
            p = self._policies.get(req.name)
            if p is None:
                return codec.encode(mm.ModifyBackupPolicyResponse(
                    error=1, error_text=f"no policy {req.name}"))
            if req.enabled in (0, 1):
                p["enabled"] = bool(req.enabled)
            if req.interval_seconds > 0:
                p["interval_seconds"] = req.interval_seconds
            if req.history_count > 0:
                p["history_count"] = req.history_count
            for a in req.add_apps:
                if a not in self._apps:
                    return codec.encode(mm.ModifyBackupPolicyResponse(
                        error=1, error_text=f"no such app {a}"))
                if a not in p["apps"]:
                    p["apps"].append(a)
            for a in req.remove_apps:
                if a in p["apps"]:
                    p["apps"].remove(a)
            self._persist_locked()
        return codec.encode(mm.ModifyBackupPolicyResponse())

    def run_backup_policies(self, now: int = None) -> list:
        """Execute every enabled policy that is due; prune history beyond
        history_count (reference policy scheduler in meta backup_service,
        SURVEY §2.4 'Cold backup'). Called from the meta app's timer (and
        directly by tests with a pinned `now`). Returns [(policy, app,
        backup_id or None)]."""
        import shutil

        now = int(time.time()) if now is None else now
        ran = []
        with self._lock:
            due = [dict(p) for p in self._policies.values()
                   if p["enabled"] and p["next_backup_ts"] <= now]
        for p in due:
            # one backup_id per policy run, shared by all its apps (the
            # reference's per-policy backup_id), so retention prunes runs;
            # derived from `now` so tests with a pinned clock stay stable.
            # Each policy backs up under backup_root/<policy_name>/ so two
            # policies sharing a root can never collide on a run id and
            # retention-prune each other's trees.
            run_id = now * 1000
            root = os.path.join(p["backup_root"], p["name"])
            new_ids = []
            for app_name in p["apps"]:
                err, bid = self._do_backup(app_name, root,
                                           backup_id=run_id)
                ran.append((p["name"], app_name, None if err else bid))
                if err:
                    print(f"[backup-policy {p['name']}] {app_name}: {err}",
                          flush=True)
                else:
                    new_ids.append(bid)
            with self._lock:
                live = self._policies.get(p["name"])
                if live is None:
                    continue
                ids = sorted(set(live["recent_backup_ids"]) | set(new_ids))
                # retention: newest history_count backups stay on disk
                while len(ids) > live["history_count"]:
                    victim = ids.pop(0)
                    shutil.rmtree(os.path.join(
                        os.path.abspath(live["backup_root"]), live["name"],
                        str(victim)), ignore_errors=True)
                live["recent_backup_ids"] = ids
                live["next_backup_ts"] = now + live["interval_seconds"]
                self._persist_locked()
        return ran

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

    def table_stats(self, k: int = 5) -> dict:
        """The cluster-wide per-table view: the TABLE_STATS fragments the
        nodes' beacons carry (one per serving process, keyed
        tables@pid:<pid>), folded (totals sum, percentiles MAX), with the
        top-k tables on each resource axis."""
        from ..runtime.table_stats import fold_snapshots, top_k

        with self._lock:
            frags = [st.get("tables", {})
                     for tables in self._node_tables.values()
                     for st in tables.values()]
        folded = fold_snapshots(frags)
        return {"tables": folded, "top": top_k(folded, k)}

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

    def repair_quarantined(self) -> int:
        """Heal quarantined replicas: a beacon state with
        status QUARANTINED means that node pulled its copy off the
        serving path after a corruption hit and moved the data dir into
        forensics — the copy is gone. Treat it exactly like a lost
        replica: drop the node from the partition's membership
        (`_reconfigure_partition`), which re-seeds a learner from the
        healthy primary via the block-shipped learn. The quarantined
        node itself is alive and now a non-member, so it is usually the
        re-seed target — the heal lands a fresh dir on the same node.
        Membership is the dedup: once dropped, the still-QUARANTINED
        beacon state no longer names a member, so a heal fires once.
        Returns the number of partitions reconfigured."""
        if self.level in ("stopped", "blind", "freezed"):
            return 0
        with self._lock:
            apps_by_id = {app.app_id: app for app in self._apps.values()}
            hits = []
            for node, states in self._node_states.items():
                for gpid, st in states.items():
                    if st.get("status") != "QUARANTINED":
                        continue
                    a, _, p = gpid.partition(".")
                    try:
                        app_id, pidx = int(a), int(p)
                    except ValueError:
                        continue
                    app = apps_by_id.get(app_id)
                    pcs = self._parts.get(app_id) or []
                    if app is None or pidx >= len(pcs):
                        continue
                    pc = pcs[pidx]
                    if pc.primary == node or node in pc.secondaries:
                        hits.append((app, pc, node))
        from ..runtime import events

        healed = 0
        for app, pc, node in hits:
            events.emit("meta.heal_quarantine", "warn",
                        gpid=f"{app.app_id}.{pc.pidx}", node=node)
            # ack the quarantine BEFORE reconfiguring: the close clears
            # the node's beaconed QUARANTINED record (otherwise it
            # reports the lost copy forever and the doctor stays
            # degraded on a healed partition). The quarantined node is
            # alive and usually the reconfigure's re-seed target — an
            # after-the-fact close would tear down the replica the
            # re-seed just landed on that same node.
            self._send_to_node(node, RPC_CLOSE_REPLICA,
                               mm.CloseReplicaRequest(app.app_id, pc.pidx),
                               ignore_errors=True)
            with self._lock:
                # drop the folded state we just acted on: a second
                # repair tick inside one beacon interval must not read
                # the stale QUARANTINED entry and nuke the re-seeded
                # copy; the next beacon repopulates the truth
                st = self._node_states.get(node)
                if st:
                    st.pop(f"{app.app_id}.{pc.pidx}", None)
            self._reconfigure_partition(app, pc, dead=node)
            healed += 1
        return healed

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
