"""Server roles the port's entry point (server/__main__.py) can start.

Port of pegasus_tpu/runtime/service_app.py's MetaApp, ReplicaApp and
CompactOffloadApp: each reads its [apps.<name>] section (and the shared
[pegasus.server] and [failure_detector] sections) of an ini config.

    [apps.meta1]
    type = meta
    port = 34601
    state_dir = pegasus-data/meta     ; shared by every meta (election)

    [apps.replica1]
    type = replica
    port = 34801                      ; fixed: the node's identity
    data_dir = pegasus-data/replica1

    [pegasus.server]
    meta_servers = 127.0.0.1:34601
    compaction_backend = cuda         ; cuda (default) | cpu

    [core]
    toollets = tracer, profiler       ; RPC middlewares on every app

Every role samples the process's counters into the metric history
(runtime/metric_history.py; refcounted, one sampler per process).

Not ported yet (ROADMAP Queue 1): http_port reporters, serve groups,
sharded compaction and the collector role. A config that asks for one
of them raises, naming it.
"""

import os
import threading

from .config import Config
from .metric_history import HISTORY
from .toollets import install_toollets


def _refuse_unported(config: Config, section: str) -> None:
    """Raise when the config asks for a plane the port does not have."""
    asked = []
    if config.get_int(section, "http_port", -1) >= 0:
        asked.append(f"[{section}] http_port")
    if config.get_int(section, "serve_groups", 1) > 1 or int(
            os.environ.get("PEGASUS_SERVE_GROUPS") or 1) > 1:
        asked.append(f"[{section}] serve_groups")
    if config.get_bool("pegasus.server", "sharded_compaction", False):
        asked.append("[pegasus.server] sharded_compaction")
    if asked:
        raise ValueError(f"{', '.join(asked)}: not ported to "
                         f"pegasus_tpu_torch yet (ROADMAP Queue 1)")


class MetaApp:
    """The meta server on its own RpcServer. With more than one meta in
    [pegasus.server] meta_servers, the metas elect a leader over the
    shared state_dir (meta/election.py); followers redirect. A timer
    every [failure_detector] check_interval_seconds expires dead nodes
    (check_leases) and re-seeds partitions below their replica count
    (repair_under_replication), so a restarted node is re-added. A
    second timer, every max(check_interval_seconds, 5) s, runs the
    backup policies that are due (run_backup_policies): a long backup
    must not stall lease checks. The reference's timer also purges
    expired soft drops and refreshes duplication envs; the port serves
    neither plane yet."""

    def __init__(self, name, config: Config, section: str):
        from ..meta.meta_server import MetaServer
        from ..rpc.transport import RpcServer

        _refuse_unported(config, section)
        state_dir = config.get_string(section, "state_dir",
                                      os.path.join("pegasus-data", "meta"))
        state_path = os.path.join(state_dir, "state.json")
        self.rpc = RpcServer(config.get_string(section, "host", "127.0.0.1"),
                             config.get_int(section, "port", 34601))
        metas = config.get_list("pegasus.server", "meta_servers", ())
        self.election = None
        if len(metas) > 1:
            from ..meta.election import MetaElection

            self.election = MetaElection(
                state_path + ".lock", self.address,
                lease_seconds=config.get_float(section,
                                               "election_lease_seconds", 6.0),
                on_acquire=lambda: self.meta.reload_state(),
                # claims exceed the durable state epoch even when the
                # lease file's lineage was lost
                claim_floor=lambda: self.meta._read_state_epoch())
        self.meta = MetaServer(
            state_path,
            fd_grace_seconds=config.get_float("failure_detector",
                                              "grace_seconds", 22.0),
            election=self.election)
        for code, fn in self.meta.rpc_handlers().items():
            self.rpc.register(code, fn)
        install_toollets(self.rpc, config.get_list("core", "toollets", ()))
        self._fd_timer = None
        self._policy_timer = None
        self._stopped = False
        self._history_ref = False
        self._fd_interval = config.get_float("failure_detector",
                                             "check_interval_seconds", 5.0)

    @property
    def address(self):
        return f"{self.rpc.address[0]}:{self.rpc.address[1]}"

    def start(self):
        self._stopped = False
        self.rpc.start()
        if self.election is not None:
            self.election.start()
        self._arm_fd()
        self._arm_policy()
        HISTORY.start()
        self._history_ref = True
        return self

    def _is_leader(self) -> bool:
        return self.election is None or self.election.is_leader()

    def _arm_fd(self):
        self._fd_timer = threading.Timer(self._fd_interval, self._fd_tick)
        self._fd_timer.daemon = True
        self._fd_timer.start()

    def _fd_tick(self):
        try:
            if self._is_leader():  # followers watch, never act
                self.meta.check_leases()
                self.meta.repair_under_replication()
        except Exception as e:  # a fenced persist (or any failure) must
            # not kill the timer for the process lifetime
            print(f"[meta] fd tick failed: {e!r}", flush=True)
        if not self._stopped:
            self._arm_fd()

    def _arm_policy(self):
        self._policy_timer = threading.Timer(max(self._fd_interval, 5.0),
                                             self._policy_tick)
        self._policy_timer.daemon = True
        self._policy_timer.start()

    def _policy_tick(self):
        try:
            if self._is_leader():
                self.meta.run_backup_policies()
        except Exception as e:  # a policy failure must not kill the timer
            print(f"[meta] maintenance tick failed: {e!r}", flush=True)
        if not self._stopped:
            self._arm_policy()

    def stop(self):
        self._stopped = True
        if self._fd_timer:
            self._fd_timer.cancel()
        if self._policy_timer:
            self._policy_timer.cancel()
        if self.election is not None:
            self.election.stop()
        self.rpc.stop()
        if self._history_ref:
            self._history_ref = False
            HISTORY.stop()


class ReplicaApp:
    """One replica node (replication/replica_stub.ReplicaStub). Its
    engines take [pegasus.server] compaction_backend, cuda by default
    (the reference defaults to cpu); `device` in the app's section or in
    [pegasus.server] names the card, or `cpu` to run the cuda backend's
    plain versions on the CPU."""

    def __init__(self, name, config: Config, section: str):
        from ..engine.db import EngineOptions
        from ..replication.replica_stub import ReplicaStub

        _refuse_unported(config, section)
        metas = config.get_list("pegasus.server", "meta_servers",
                                ["127.0.0.1:34601"])
        backend = config.get_string("pegasus.server", "compaction_backend",
                                    "cuda")
        if backend not in ("cuda", "cpu"):
            raise ValueError(f"compaction_backend = {backend}: the port's "
                             f"engines are cuda or cpu")
        compression = config.get_string("pegasus.server", "sst_compression",
                                        "none")
        device = config.get_string(
            section, "device",
            config.get_string("pegasus.server", "device", "")) or None
        data_dir = config.get_string(section, "data_dir",
                                     os.path.join("pegasus-data", name))

        def options_factory():
            return EngineOptions(backend=backend, compression=compression,
                                 device=device)

        self.stub = ReplicaStub(
            data_dir, list(metas),
            host=config.get_string(section, "host", "127.0.0.1"),
            port=config.get_int(section, "port", 0),
            options_factory=options_factory,
            cluster_id=config.get_int("pegasus.server", "cluster_id", 1))
        self._beacon = config.get_float("failure_detector",
                                        "beacon_interval_seconds", 1.0)
        # the stub starts and stops the metric history itself
        install_toollets(self.stub.rpc,
                         config.get_list("core", "toollets", ()),
                         command_service=self.stub.commands)

    @property
    def address(self):
        return self.stub.address

    def start(self):
        self.stub.start(self._beacon)
        return self

    def stop(self):
        self.stub.stop()


class CompactOffloadApp:
    """One card-owning compaction service per GPU host, serving many
    cpu-only replica nodes. Config:

        [apps.offload]
        type = compact_offload
        port = 34901            ; what nodes' placement leases dial
        backend = cuda          ; cuda | cpu; default: [pegasus.server]
                                ; compaction_backend, else cuda
        device = cuda:0         ; the card to merge on (default: cuda)
        job_dir = ...           ; staged-run + job spool (default per-app)
    """

    def __init__(self, name, config: Config, section: str):
        from ..replication.compact_offload import CompactOffloadService

        backend = config.get_string(
            section, "backend",
            config.get_string("pegasus.server", "compaction_backend", "cuda"))
        root = config.get_string(section, "job_dir",
                                 os.path.join("pegasus-data", name))
        self.svc = CompactOffloadService(
            root,
            host=config.get_string(section, "host", "127.0.0.1"),
            port=config.get_int(section, "port", 0),
            backend=backend,
            device=config.get_string(section, "device", None))

    @property
    def address(self):
        return self.svc.address

    def start(self):
        self.svc.start()
        HISTORY.start()
        self._history_ref = True
        print(f"[pegasus-tpu] compaction offload service on "
              f"{self.svc.address} (backend {self.svc.backend})", flush=True)
        return self

    def stop(self):
        self.svc.stop()
        if getattr(self, "_history_ref", False):
            self._history_ref = False
            HISTORY.stop()


APP_TYPES = {"meta": MetaApp, "replica": ReplicaApp,
             "compact_offload": CompactOffloadApp}
