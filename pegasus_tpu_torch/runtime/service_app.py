"""Server roles the port's entry point (server/__main__.py) can start.

Port of pegasus_tpu/runtime/service_app.py's MetaApp, ReplicaApp,
CollectorApp and CompactOffloadApp: each reads its [apps.<name>] section
(and the shared [pegasus.server] and [failure_detector] sections) of an
ini config.

    [apps.meta1]
    type = meta
    port = 34601
    state_dir = pegasus-data/meta     ; shared by every meta (election)
    http_port = 0                     ; optional: /metrics, /meta/..., /tables

    [apps.replica1]
    type = replica
    port = 34801                      ; fixed: the node's identity
    data_dir = pegasus-data/replica1
    http_port = 0                     ; optional: /metrics, /replica/info

    [apps.collector]
    type = collector
    port = 34901
    interval_seconds = 10             ; the info collector's round
    detect_interval_seconds = 2       ; the availability canary's probe
    available_detect_app = test       ; created 8 x 3 when missing

    [pegasus.server]
    meta_servers = 127.0.0.1:34601
    compaction_backend = cuda         ; cuda (default) | cpu

    [core]
    toollets = tracer, profiler       ; RPC middlewares on every app

Every role samples the process's counters into the metric history
(runtime/metric_history.py; refcounted, one sampler per process), and
with `http_port` >= 0 serves its counters and routes over HTTP
(collector/reporter.py CounterReporter; 0 picks a free port).

The meta's failure-detector tick also heals quarantined replicas
(MetaServer.repair_quarantined); the meta and the collector serve the
flight recorder's `/incidents`, and the collector its
`trigger-incident` command.

Not ported yet (ROADMAP Queue 1): serve groups and sharded compaction.
A config that asks for either raises, naming it.
"""

import json
import os
import threading
import time
from urllib.parse import parse_qs, urlparse

from .config import Config
from .metric_history import HISTORY
from .toollets import install_toollets


def _refuse_unported(config: Config, section: str) -> None:
    """Raise when the config asks for a plane the port does not have."""
    asked = []
    if config.get_int(section, "serve_groups", 1) > 1 or int(
            os.environ.get("PEGASUS_SERVE_GROUPS") or 1) > 1:
        asked.append(f"[{section}] serve_groups")
    if config.get_bool("pegasus.server", "sharded_compaction", False):
        asked.append("[pegasus.server] sharded_compaction")
    if asked:
        raise ValueError(f"{', '.join(asked)}: not ported to "
                         f"pegasus_tpu_torch yet (ROADMAP Queue 1)")


# ------------------------------------------------------ http info routes


def _version_info(kind: str) -> dict:
    from .remote_command import _START_TIME, VERSION

    return {"version": VERSION, "server_type": kind,
            "uptime_seconds": int(time.time() - _START_TIME)}


def _int_arg(q: dict, key: str, default: int) -> int:
    try:
        return int((q.get(key) or [str(default)])[0])
    except ValueError:
        return default


def _compact_trace_route(path: str) -> dict:
    """GET /compact/trace[?last=N]: the compaction stage-span ring plus
    the device watchdog's liveness state, the JSON twin of the
    `compact-trace-dump` remote command."""
    from ..ops.device_watchdog import health_watchdog
    from .tracing import COMPACT_TRACER

    last = _int_arg(parse_qs(urlparse(path).query), "last", 100)
    return {"watchdog": health_watchdog().state(),
            "spans": COMPACT_TRACER.trace(last)}


def _request_trace_route(path: str) -> dict:
    """GET /requests/trace[?last=N][&slow=1][&id=<hex>]: the serving
    path's request tracer: sampled completed traces plus the slow-request
    ledger (?slow=1: the ledger only; ?id=: one trace by its id)."""
    from .tracing import REQUEST_TRACER

    q = parse_qs(urlparse(path).query)
    last = _int_arg(q, "last", 50)
    trace_id = (q.get("id") or [""])[0]
    if trace_id:
        return {"trace": REQUEST_TRACER.find(trace_id)}
    if (q.get("slow") or ["0"])[0] not in ("0", ""):
        return {"slow_requests": REQUEST_TRACER.slow_requests(last)}
    return {"traces": REQUEST_TRACER.trace(last),
            "slow_requests": REQUEST_TRACER.slow_requests(last)}


def _jobs_route(path: str) -> dict:
    """GET /jobs[?last=N][&id=<j...>][&active=0]: the background-job
    tracer's completed and still-open timelines (?id=: one job;
    ?active=0: completed jobs only)."""
    from .job_trace import JOB_TRACER

    q = parse_qs(urlparse(path).query)
    job_id = (q.get("id") or [""])[0]
    if job_id:
        return {"job": JOB_TRACER.find(job_id)}
    active = (q.get("active") or ["1"])[0] not in ("0", "")
    return {"jobs": JOB_TRACER.jobs(last=_int_arg(q, "last", 50),
                                    active=active)}


def _events_route(path: str) -> dict:
    """GET /events[?last=N][&prefix=p][&since=ts]: the process-wide
    structured event ring, the twin of the `events-dump` command."""
    from .events import EVENTS

    q = parse_qs(urlparse(path).query)

    def _num(key, cast):
        try:
            return cast((q.get(key) or [""])[0])
        except ValueError:
            return None

    return {"events": EVENTS.snapshot(last=_num("last", int),
                                      since=_num("since", float),
                                      prefix=(q.get("prefix") or [None])[0])}


def _metrics_history_route(path: str) -> dict:
    """GET /metrics/history[?seconds=N][&prefix=p][&deltas=1]: the
    metric history ring, queryable by window."""
    q = parse_qs(urlparse(path).query)
    try:
        seconds = float((q.get("seconds") or [""])[0])
    except ValueError:
        seconds = None
    return HISTORY.window(
        seconds=seconds, prefix=(q.get("prefix") or [None])[0],
        deltas=(q.get("deltas") or ["0"])[0] not in ("0", ""))


def _incidents_route(path: str) -> dict:
    """GET /incidents[?id=<incident>]: the flight recorder's retained
    incident artifacts: the list, or one full artifact by id."""
    from ..collector.flight_recorder import RECORDER

    q = parse_qs(urlparse(path).query)
    incident_id = (q.get("id") or [""])[0]
    if incident_id:
        return {"incident": RECORDER.load(incident_id)}
    return {"incidents": RECORDER.list_incidents()}


def _health_cluster_route(meta_addrs):
    """GET /health/cluster[?scrape=0][&last=N]: the cluster doctor's one
    verdict, the twin of the `cluster-doctor` command (?scrape=0 skips
    the per-node scrapes; ?last=N bounds the slow-request rollup)."""
    def route(path):
        from ..collector.cluster_doctor import run_cluster_doctor

        q = parse_qs(urlparse(path).query)
        scrape = (q.get("scrape") or ["1"])[0] not in ("0",)
        return run_cluster_doctor(list(meta_addrs), scrape=scrape,
                                  slow_last=_int_arg(q, "last", 10))

    return route


def _slo_route(path: str) -> dict:
    """GET /slo: the per-table SLO verdicts this process computed last
    ({} where nothing evaluates them: the collector is the evaluator)."""
    from ..collector.info_collector import latest_slo

    return {"slo": latest_slo()}


def _tables_meta_route(meta):
    """GET /tables on the meta: the beacons' per-table ledger fragments
    folded into one cluster-wide view plus the top-k attribution."""
    def route(path):
        from .table_stats import fold_snapshots, top_k

        frags = []
        with meta._lock:
            for tables in meta._node_tables.values():
                for st in tables.values():
                    frags.append(st.get("tables", {}))
        folded = fold_snapshots(frags)
        return {"tables": folded,
                "top": top_k(folded,
                             int(os.environ.get("PEGASUS_TABLE_TOPK", "5")))}

    return route


def _meta_http_routes(meta) -> dict:
    """The meta's routes: /version, /meta/cluster_info, /meta/apps,
    /meta/app?name=<app>, the tracing planes, /tables and /slo."""
    def cluster_info(path):
        with meta._lock:
            alive = meta._alive_nodes_locked()
            return {"meta_server": "self", "app_count": len(meta._apps),
                    "node_count": len(meta._nodes), "alive_nodes": alive}

    def apps(path):
        with meta._lock:
            return [{"app_name": a.app_name, "app_id": a.app_id,
                     "partition_count": a.partition_count,
                     "replica_count": a.replica_count, "status": a.status}
                    for a in meta._apps.values()]

    def app(path):
        name = (parse_qs(urlparse(path).query).get("name") or [""])[0]
        with meta._lock:
            a = meta._apps.get(name)
            if a is None:
                return {"error": f"no app {name!r}"}
            return {"app_name": a.app_name, "app_id": a.app_id,
                    "partition_count": a.partition_count,
                    "envs": a.envs_json,
                    "partitions": [{
                        "pidx": pc.pidx, "ballot": pc.ballot,
                        "primary": pc.primary,
                        "secondaries": list(pc.secondaries)}
                        for pc in meta._parts[a.app_id]]}

    return {"/version": lambda p: _version_info("meta"),
            "/meta/cluster_info": cluster_info,
            "/meta/apps": apps,
            "/meta/app": app,
            "/compact/trace": _compact_trace_route,
            "/requests/trace": _request_trace_route,
            "/jobs": _jobs_route,
            "/events": _events_route,
            "/metrics/history": _metrics_history_route,
            "/incidents": _incidents_route,
            "/tables": _tables_meta_route(meta),
            "/slo": _slo_route}


def _replica_http_routes(stub) -> dict:
    """/version, /replica/info and the tracing planes on replica nodes."""
    def info(path):
        with stub._lock:
            reps = list(stub._replicas.values())
        return [{"app_name": r.app_name, "app_id": r.app_id, "pidx": r.pidx,
                 "status": r.status, "ballot": r.ballot,
                 "last_committed": r.last_committed,
                 "last_prepared": r.last_prepared,
                 "last_durable": r.server.engine.last_durable_decree()}
                for r in reps]

    return {"/version": lambda p: _version_info("replica"),
            "/replica/info": info,
            "/compact/trace": _compact_trace_route,
            "/requests/trace": _request_trace_route,
            "/jobs": _jobs_route,
            "/events": _events_route,
            "/metrics/history": _metrics_history_route}


def _reporter(config: Config, section: str, routes_fn):
    """A started CounterReporter on [section] http_port, or None when
    http_port < 0 (the default). Started at construction, not in
    start(): ThreadingHTTPServer.shutdown() waits for serve_forever, so
    an app whose start() died before the reporter ran would hang in
    stop()."""
    http_port = config.get_int(section, "http_port", -1)
    if http_port < 0:
        return None
    from ..collector.reporter import CounterReporter

    return CounterReporter(port=http_port, routes=routes_fn()).start()


# ---------------------------------------------------------- built-in apps


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
        self.reporter = _reporter(config, section, lambda: dict(
            _meta_http_routes(self.meta),
            **{"/health/cluster": _health_cluster_route([self.address])}))
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
                # a beacon reporting QUARANTINED is a lost copy:
                # reconfigure and re-seed on the lease cadence
                self.meta.repair_quarantined()
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
        if self.reporter:
            self.reporter.stop()
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
        self.reporter = _reporter(config, section,
                                  lambda: _replica_http_routes(self.stub))

    @property
    def address(self):
        return self.stub.address

    def start(self):
        self.stub.start(self._beacon)
        return self

    def stop(self):
        if self.reporter:
            self.reporter.stop()
        self.stub.stop()


class CollectorApp:
    """The collector role (upstream info_collector_app): the info
    collector's rounds (scrapes, the closed hotkey loop, the cluster
    rollups, the SLO evaluator) and the availability canary, with its
    own RPC port for the shell and the tests. Under PEGASUS_SCHED=1 it
    also runs the compaction scheduler on the collector's pool, fed the
    hotkey loop's read-residency pins and the slow-request rollup. The
    canary's table (`available_detect_app`, default `test`) is created
    8 partitions x 3 replicas until a meta acknowledges it."""

    def __init__(self, name, config: Config, section: str):
        from ..collector.available_detector import AvailableDetector
        from ..collector.info_collector import InfoCollector
        from ..rpc.transport import RpcServer
        from .remote_command import RemoteCommandService

        self.metas = config.get_list("pegasus.server", "meta_servers",
                                     ["127.0.0.1:34601"])
        self._stopping = False
        self._history_ref = False
        self.detect_table = config.get_string(section, "available_detect_app",
                                              "test")
        self.collector = InfoCollector(
            list(self.metas),
            interval_seconds=config.get_float(section, "interval_seconds",
                                              10.0))
        self.scheduler = None
        if os.environ.get("PEGASUS_SCHED", "") == "1":
            from ..collector.compact_scheduler import CompactScheduler

            def _hot_gpids():
                # read_residency publishes copy-on-write: lock-free
                # iteration sees a stable snapshot
                return {t["gpid"]
                        for t in dict(self.collector.read_residency).values()}

            self.scheduler = CompactScheduler(
                list(self.metas), pool=self.collector.pool,
                hot_fn=_hot_gpids,
                slow_fn=lambda: len(self.collector.cluster_slow_requests))
        self.detector = AvailableDetector(
            list(self.metas), table_name=self.detect_table,
            interval_seconds=config.get_float(section,
                                              "detect_interval_seconds", 1.0))
        self.rpc = RpcServer(config.get_string(section, "host", "127.0.0.1"),
                             config.get_int(section, "port", 0))
        self.commands = RemoteCommandService()
        self.commands.register_defaults(node_kind="collector",
                                        describe=lambda: "collector")
        self.commands.register("collector-info", self._cmd_info)
        self.commands.register("compact-sched-status",
                               self._cmd_compact_sched_status)
        self.commands.register("cluster-doctor", self._cmd_cluster_doctor)
        self.commands.register("trigger-audit", self._cmd_trigger_audit)
        self.commands.register("trigger-incident",
                               self._cmd_trigger_incident)
        self.rpc.register("RPC_CLI_CLI_CALL", self.commands.rpc_handler)
        self.reporter = _reporter(config, section, self._routes)

    def _routes(self) -> dict:
        def tables_route(path):
            # the collector's own cluster fold, published copy-on-write
            return {"tables": self.collector.table_stats,
                    "top": self.collector.table_top}

        return {"/compact/trace": _compact_trace_route,
                "/requests/trace": _request_trace_route,
                "/jobs": _jobs_route,
                "/events": _events_route,
                "/metrics/history": _metrics_history_route,
                "/incidents": _incidents_route,
                "/tables": tables_route,
                "/slo": _slo_route,
                "/health/cluster": _health_cluster_route(self.metas)}

    def _sched_status(self) -> dict:
        if self.scheduler is None:
            return {"enabled": False}
        return dict(self.scheduler.status(), enabled=True)

    def _cmd_info(self, args) -> str:
        """collector-info: the canary's availability, the hotspots and
        hotkey verdicts, and every rollup of the last round."""
        return json.dumps({
            "availability": self.detector.report(),
            "hotspots": self.collector.hotspots,
            "hotkeys": self.collector.hotkey_results,
            "app_stats": self.collector.app_stats,
            "compact_stats": self.collector.compact_stats,
            "lag_stats": self.collector.lag_stats,
            "slow_requests": self.collector.cluster_slow_requests,
            "compact_sched": self._sched_status(),
        })

    def _cmd_compact_sched_status(self, args) -> str:
        """compact-sched-status: the scheduler's last decision round (the
        replica command of the same name shows the engines' tokens)."""
        if self.scheduler is None:
            return json.dumps({"enabled": False})
        return json.dumps(self._sched_status(), indent=1)

    def _cmd_cluster_doctor(self, args) -> str:
        """cluster-doctor [last]: one structured cluster-health verdict."""
        from ..collector.cluster_doctor import run_cluster_doctor

        last = int(args[0]) if args else 10
        return json.dumps(run_cluster_doctor(
            list(self.metas), pool=self.collector.pool, slow_last=last),
            indent=1)

    def _cmd_trigger_audit(self, args) -> str:
        """trigger-audit [app ...]: the decree-anchored consistency audit
        across every (or the named) app."""
        from ..collector.cluster_doctor import run_cluster_audit

        return json.dumps(run_cluster_audit(
            list(self.metas), pool=self.collector.pool,
            apps=list(args) or None), indent=1)

    def _cmd_trigger_incident(self, args) -> str:
        """trigger-incident [reason]: capture a flight-recorder incident
        now (every alive node's event ring, metric history, slow ledger
        and recent traces, aligned on one anchor, first cause found,
        artifact retained; served as GET /incidents and the shell's
        flight_recorder)."""
        from ..collector.flight_recorder import RECORDER

        reason = " ".join(args) if args else "manual trigger"
        inc = RECORDER.capture(list(self.metas), reason=reason,
                               trigger="manual", pool=self.collector.pool)
        return json.dumps({"incident": inc["id"],
                           "path": inc.get("path", ""),
                           "first_cause": inc.get("first_cause")}, indent=1)

    @property
    def address(self):
        return f"{self.rpc.address[0]}:{self.rpc.address[1]}"

    def _ensure_probe_table(self) -> bool:
        """Create the canary's table through the first meta that answers.
        -> True once a meta acknowledged it (an existing table answers
        its id). The reference also takes a refusal ("no alive replica
        nodes", a follower's redirect) as done, so a collector that boots
        with the nodes never gets its table; the port retries those."""
        from ..meta import messages as mm
        from ..meta.meta_server import RPC_CM_CREATE_APP
        from ..rpc import codec
        from ..rpc.transport import RpcConnection, RpcError

        for m in self.metas:
            host, _, port = m.rpartition(":")
            try:
                conn = RpcConnection((host, int(port)))
                try:
                    _, body = conn.call(RPC_CM_CREATE_APP, codec.encode(
                        mm.CreateAppRequest(self.detect_table, 8, 3)),
                        timeout=10.0)
                    if codec.decode(mm.CreateAppResponse, body).error == 0:
                        return True
                finally:
                    conn.close()
            except (OSError, RpcError):
                continue
        return False

    def _ensure_probe_table_loop(self):
        """The collector may boot before the meta, or restart on its
        own: keep trying until a create lands, with no deadline."""
        while not self._stopping:
            try:
                if self._ensure_probe_table():
                    return
            except Exception:  # noqa: BLE001 - retried next second
                pass
            time.sleep(1.0)

    def start(self):
        from .tasking import spawn_thread

        self._stopping = False
        self.rpc.start()
        HISTORY.start()
        self._history_ref = True
        spawn_thread(self._ensure_probe_table_loop, daemon=True,
                     name="collector-probe-table")
        self.collector.start()
        if self.scheduler is not None:
            self.scheduler.start()
        self.detector.start()
        print(f"[pegasus-tpu] collector rpc on {self.address}", flush=True)
        return self

    def stop(self):
        if self._history_ref:
            self._history_ref = False
            HISTORY.stop()
        self._stopping = True
        if self.reporter:
            self.reporter.stop()
        self.detector.stop()
        if self.scheduler is not None:
            self.scheduler.stop()  # before the collector closes its pool
        self.collector.stop()
        self.rpc.stop()


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
             "collector": CollectorApp,
             "compact_offload": CompactOffloadApp}
