"""Meta-server wire messages (the replication_ddl_client / meta surface).

Port of pegasus_tpu/meta/messages.py, every class. The codec is
positional, so each class keeps the reference's field order, types and
defaults: a pegasus_tpu peer and a pegasus_tpu_torch peer read each
other's bytes (tests/test_torch_meta.py). Covers table DDL,
partition-config queries, app envs, the beacon failure detector, the
meta-to-replica lifecycle proposals and the replication prepare and
learn frames, and the duplication, backup, bulk-load, recovery,
balance and diagnosis messages. Addresses travel as "host:port" strings.
"""

from dataclasses import dataclass, field
from typing import List


@dataclass
class PartitionConfig:
    pidx: int = 0
    ballot: int = 0
    primary: str = ""                 # "" = unassigned
    secondaries: List[str] = field(default_factory=list)


@dataclass
class AppInfo:
    app_name: str = ""
    app_id: int = 0
    partition_count: int = 0
    replica_count: int = 3
    status: str = "AS_AVAILABLE"
    envs_json: str = "{}"


@dataclass
class CreateAppRequest:
    app_name: str = ""
    partition_count: int = 8
    replica_count: int = 3
    envs_json: str = "{}"


@dataclass
class CreateAppResponse:
    error: int = 0
    error_text: str = ""
    app_id: int = 0


@dataclass
class DropAppRequest:
    app_name: str = ""
    reserve_seconds: int = 0          # >0: soft-drop, recallable this long


@dataclass
class DropAppResponse:
    error: int = 0
    error_text: str = ""


@dataclass
class ControlMetaRequest:
    set_level: str = ""               # "" = just read; freezed|steady|lively


@dataclass
class ControlMetaResponse:
    error: int = 0
    error_text: str = ""
    level: str = ""


@dataclass
class RecallAppRequest:
    app_id: int = 0
    new_app_name: str = ""            # "" = original name


@dataclass
class RecallAppResponse:
    error: int = 0
    error_text: str = ""
    app_name: str = ""


@dataclass
class ListAppsRequest:
    pass


@dataclass
class ListAppsResponse:
    error: int = 0
    apps: List[AppInfo] = field(default_factory=list)


@dataclass
class QueryConfigRequest:
    app_name: str = ""


@dataclass
class QueryConfigResponse:
    error: int = 0
    error_text: str = ""
    app: AppInfo = field(default_factory=AppInfo)
    partitions: List[PartitionConfig] = field(default_factory=list)


@dataclass
class SetAppEnvsRequest:
    app_name: str = ""
    envs_json: str = "{}"


@dataclass
class SetAppEnvsResponse:
    error: int = 0
    error_text: str = ""


@dataclass
class BeaconRequest:
    node: str = ""                    # replica node address
    alive_replicas: List[str] = field(default_factory=list)  # "app_id.pidx"
    # per-partition duplication confirmed decrees from this node's primaries:
    # "app_id.pidx.dupid:decree" — the meta folds them into its dup entries
    # (the reference's duplication_info.progress sync)
    dup_progress: List[str] = field(default_factory=list)
    # per-replica lag/audit state, one JSON object per hosted replica
    # ({"gpid","status","ballot","committed","applied","prepared",
    #   "audit":{...}}) — the meta folds these into its cluster-state view
    # so the doctor reads lag AND decree-anchored digests from ONE place
    replica_states: List[str] = field(default_factory=list)


@dataclass
class BeaconResponse:
    error: int = 0
    allowed: bool = True              # lease granted


@dataclass
class ProposeRequest:
    """Move a partition's primary (the balancer's move_primary action)."""

    app_name: str = ""
    pidx: int = 0
    target: str = ""                  # must be a current secondary


@dataclass
class ProposeResponse:
    error: int = 0
    error_text: str = ""


@dataclass
class BalanceRequest:
    pass


@dataclass
class BalanceResponse:
    error: int = 0
    error_text: str = ""
    moved: int = 0


@dataclass
class NodeInfo:
    address: str = ""
    alive: bool = True
    last_beacon_ms: int = 0
    replica_count: int = 0


@dataclass
class ListNodesRequest:
    pass


@dataclass
class ListNodesResponse:
    error: int = 0
    nodes: List[NodeInfo] = field(default_factory=list)


@dataclass
class SplitAppRequest:
    app_name: str = ""


@dataclass
class SplitAppResponse:
    error: int = 0
    error_text: str = ""
    new_partition_count: int = 0


@dataclass
class BackupAppRequest:
    app_name: str = ""
    backup_root: str = ""             # block-service path (local FS provider)


@dataclass
class BackupAppResponse:
    error: int = 0
    error_text: str = ""
    backup_id: int = 0


@dataclass
class RestoreAppRequest:
    backup_root: str = ""
    backup_id: int = 0
    old_app_name: str = ""
    new_app_name: str = ""


@dataclass
class RestoreAppResponse:
    error: int = 0
    error_text: str = ""
    app_id: int = 0


@dataclass
class StartBulkLoadRequest:
    app_name: str = ""
    provider_root: str = ""
    # async session (reference semantics): the response reports the session
    # started; progress comes from query_bulk_load_status. Default stays
    # synchronous for in-process callers.
    async_start: bool = False


@dataclass
class StartBulkLoadResponse:
    error: int = 0
    error_text: str = ""
    ingested_records: int = 0


@dataclass
class QueryBulkLoadRequest:
    app_name: str = ""


@dataclass
class QueryBulkLoadResponse:
    error: int = 0
    error_text: str = ""
    # downloading | ingesting | paused | canceled | failed | succeed | none
    status: str = "none"
    done_partitions: int = 0
    total_partitions: int = 0
    ingested_records: int = 0


@dataclass
class QueryRestoreRequest:
    app_name: str = ""


@dataclass
class QueryRestoreResponse:
    error: int = 0
    error_text: str = ""
    status: str = "none"   # restoring | ok | none
    backup_id: int = 0
    old_app_name: str = ""
    done_partitions: int = 0
    total_partitions: int = 0


@dataclass
class ControlBulkLoadRequest:
    app_name: str = ""
    action: str = ""      # pause | restart | cancel


@dataclass
class ControlBulkLoadResponse:
    error: int = 0
    error_text: str = ""


# --- meta -> replica node commands ---

@dataclass
class OpenReplicaRequest:
    app_name: str = ""
    app_id: int = 0
    pidx: int = 0
    ballot: int = 0
    primary: str = ""
    secondaries: List[str] = field(default_factory=list)
    learn_from: str = ""              # non-empty: seed from this node first
    envs_json: str = "{}"
    partition_count: int = 0          # for partition-hash routing checks
    learn_pidx: int = -1              # learn from a DIFFERENT pidx (split)
    restore_dir: str = ""             # seed a fresh engine from this dir


@dataclass
class OpenReplicaResponse:
    error: int = 0
    error_text: str = ""
    last_committed: int = 0
    last_prepared: int = 0


@dataclass
class CloseReplicaRequest:
    app_id: int = 0
    pidx: int = 0


@dataclass
class ReplicaStateRequest:
    app_id: int = 0
    pidx: int = 0


@dataclass
class ReplicaStateResponse:
    error: int = 0
    status: str = ""
    ballot: int = 0
    last_committed: int = 0
    last_prepared: int = 0
    last_durable: int = 0
    # what the ENGINE applied — diverges from last_committed exactly when
    # the replica is behind on apply (appended last: codec append-only rule)
    last_applied: int = 0


# --- replica <-> replica (2PC + learn) ---

@dataclass
class PrepareRequest:
    app_id: int = 0
    pidx: int = 0
    ballot: int = 0
    committed_decree: int = 0
    mutation: bytes = b""             # codec-encoded LogMutation
    # decree-pipelined window [d1..dk]: one prepare RPC carries every
    # mutation of the round (codec-encoded LogMutations, decree order).
    # Appended last per the codec's append-only evolution rule; when
    # non-empty it supersedes `mutation`.
    mutations: List[bytes] = field(default_factory=list)


@dataclass
class PrepareResponse:
    error: int = 0
    reason: str = ""                  # "", "gap", "stale_ballot"
    last_prepared: int = 0


@dataclass
class FileBlob:
    name: str = ""
    data: bytes = b""


@dataclass
class LearnRequest:
    app_id: int = 0
    pidx: int = 0


@dataclass
class LearnResponse:
    error: int = 0
    files: List[FileBlob] = field(default_factory=list)
    tail: List[bytes] = field(default_factory=list)   # encoded LogMutations
    last_committed: int = 0
    ballot: int = 0


# --- duplication lifecycle DDL (reference duplication.cpp:32-260) ---

@dataclass
class DupEntry:
    dupid: int = 0
    remote: str = ""                  # remote cluster name
    status: str = "init"              # init | start | pause  (removed = gone)
    fail_mode: str = "slow"           # slow | skip
    create_ts_ms: int = 0


@dataclass
class AddDuplicationRequest:
    app_name: str = ""
    remote_cluster: str = ""
    freeze: bool = False              # start in DS_INIT (no shipping yet)


@dataclass
class AddDuplicationResponse:
    error: int = 0
    error_text: str = ""
    app_id: int = 0
    dupid: int = 0


@dataclass
class QueryDuplicationRequest:
    app_name: str = ""


@dataclass
class QueryDuplicationResponse:
    error: int = 0
    error_text: str = ""
    app_id: int = 0
    entries: List[DupEntry] = field(default_factory=list)


@dataclass
class ModifyDuplicationRequest:
    app_name: str = ""
    dupid: int = 0
    status: str = ""                  # "" = keep; start | pause | removed
    fail_mode: str = ""               # "" = keep; slow | skip


@dataclass
class ModifyDuplicationResponse:
    error: int = 0
    error_text: str = ""


# --- periodic backup policies (reference cold_backup.cpp policy surface) ---

@dataclass
class BackupPolicyInfo:
    name: str = ""
    backup_root: str = ""
    apps: List[str] = field(default_factory=list)
    interval_seconds: int = 86400
    history_count: int = 3            # retention: newest N backups kept
    enabled: bool = True
    next_backup_ts: int = 0           # unix seconds; 0 = due immediately
    recent_backup_ids: List[int] = field(default_factory=list)


@dataclass
class AddBackupPolicyRequest:
    policy: BackupPolicyInfo = field(default_factory=BackupPolicyInfo)


@dataclass
class AddBackupPolicyResponse:
    error: int = 0
    error_text: str = ""


@dataclass
class LsBackupPolicyRequest:
    name: str = ""                    # "" = all


@dataclass
class LsBackupPolicyResponse:
    error: int = 0
    error_text: str = ""
    policies: List[BackupPolicyInfo] = field(default_factory=list)


@dataclass
class ModifyBackupPolicyRequest:
    name: str = ""
    enabled: int = -1                 # -1 keep, 0 disable, 1 enable
    interval_seconds: int = 0         # 0 = keep
    history_count: int = 0            # 0 = keep
    add_apps: List[str] = field(default_factory=list)
    remove_apps: List[str] = field(default_factory=list)


@dataclass
class ModifyBackupPolicyResponse:
    error: int = 0
    error_text: str = ""


# --- disaster recovery (reference recovery.cpp `recover`, ddd_diagnose) ---

@dataclass
class ReplicaInfo:
    """One replica as reported by a node (RPC_QUERY_REPLICA_INFO)."""

    app_name: str = ""
    app_id: int = 0
    pidx: int = 0
    partition_count: int = 0
    ballot: int = 0
    last_committed: int = 0
    last_prepared: int = 0
    last_durable: int = 0
    envs_json: str = "{}"
    # engine-applied decree (appended last: codec append-only evolution)
    last_applied: int = 0


@dataclass
class QueryReplicaInfoRequest:
    pass


@dataclass
class QueryReplicaInfoResponse:
    error: int = 0
    replicas: List[ReplicaInfo] = field(default_factory=list)


@dataclass
class RecoverRequest:
    nodes: List[str] = field(default_factory=list)   # addr list to rebuild from


@dataclass
class RecoverResponse:
    error: int = 0
    error_text: str = ""
    recovered_apps: List[str] = field(default_factory=list)


@dataclass
class DddPartitionInfo:
    app_name: str = ""
    pidx: int = 0
    reason: str = ""
    candidates: List[str] = field(default_factory=list)  # "addr ballot=N lc=N"
    action: str = ""                  # "" or "promoted <addr>"


@dataclass
class QueryClusterStateRequest:
    """Cluster-observability snapshot: liveness + partition
    configs + the beacon-folded per-replica lag/audit states, in one RPC
    — the cluster doctor's primary input."""

    pass


@dataclass
class QueryClusterStateResponse:
    error: int = 0
    # {"nodes": {addr: {"alive", "last_beacon_ago_s"}},
    #  "apps": {name: {"app_id", "partition_count",
    #                  "partitions": [{"pidx","ballot","primary",
    #                                  "secondaries"}]}},
    #  "replica_states": {addr: {gpid: state}}}
    state_json: str = "{}"


@dataclass
class DddDiagnoseRequest:
    app_name: str = ""                # "" = all apps
    force: bool = False               # actually promote the best candidate


@dataclass
class DddDiagnoseResponse:
    error: int = 0
    error_text: str = ""
    partitions: List[DddPartitionInfo] = field(default_factory=list)
