"""Flight recorder: automatic incident capture + first-cause correlation.

Port of pegasus_tpu/collector/flight_recorder.py, whole. The event ring
(runtime/events.py) and the metric-history ring
(runtime/metric_history.py) give every PROCESS a recorded past; this
module is the cluster-level consumer that turns them into ONE retained
artifact the moment something goes wrong, instead of asking an operator
to re-reproduce a transient:

  * ``capture()`` pulls every alive node's event ring (``events-dump``),
    metric-history window (``metrics-history``), slow-request ledger,
    recent request traces and job timelines, adds the CAPTURING
    process's own ring (the doctor/audit verdict events land there),
    aligns everything on one wall-clock anchor, runs the first-cause
    heuristic (the EARLIEST event inside the window from the classes
    that start failure cascades: fail-point arm, breaker trip,
    scheduler-lease expiry, meta election/epoch bump) and writes one
    JSON artifact into the retained incident directory (bounded: oldest
    pruned past ``PEGASUS_INCIDENT_KEEP``).

  * ``observe_verdict()`` is the doctor hook: a healthy -> degraded /
    critical transition auto-captures (cooldown-bounded so a flapping
    cluster cannot spam artifacts), and the incident id is embedded in
    the doctor's verdict so every surface that shows the verdict points
    at the evidence bundle.

The port has no lane guard, so no port node emits
``lane.breaker_trip``; the name stays in FIRST_CAUSE_NAMES, unchanged,
for a reference node's ring. The chaos journal's hook waits for the
chaos harness (ROADMAP Queue 1).

Surfaces: ``GET /incidents`` (meta + collector http), the collector's
``trigger-incident`` remote command, the shell's ``flight_recorder``.
Counters: ``incident.capture_count``.
"""

import json
import os
import tempfile
import time

from ..rpc.transport import RpcError
from ..runtime import events, lockrank
from ..runtime.job_trace import JOB_TRACER
from ..runtime.perf_counters import counters
from .cluster_doctor import ClusterCaller

# event names that START failure cascades, in no particular order — the
# heuristic picks the EARLIEST one inside the window, which is exactly
# what "first cause" means on an aligned timeline
FIRST_CAUSE_NAMES = frozenset((
    "failpoint.arm",
    "lane.breaker_trip",
    "sched.token_expired",
    "meta.election",
    "meta.epoch_bump",
))


def _incident_dir() -> str:
    return os.environ.get("PEGASUS_INCIDENT_DIR") or os.path.join(
        tempfile.gettempdir(), "pegasus-incidents")


def _keep() -> int:
    return max(1, int(os.environ.get("PEGASUS_INCIDENT_KEEP", "16")))


def _window_s() -> float:
    return float(os.environ.get("PEGASUS_INCIDENT_WINDOW_S", "120"))


def _cooldown_s() -> float:
    return float(os.environ.get("PEGASUS_INCIDENT_COOLDOWN_S", "30"))


class FlightRecorder:
    def __init__(self):
        self._lock = lockrank.named_lock("flight.recorder")
        self._seq = 0                 #: guarded_by self._lock
        self._last_verdict = None     #: guarded_by self._lock
        self._last_capture_ts = 0.0   #: guarded_by self._lock
        self._last_incident_id = None  #: guarded_by self._lock
        self._c_capture = counters.rate("incident.capture_count")

    # ------------------------------------------------------------- capture

    def capture(self, meta_addrs, reason: str, trigger: str = "manual",
                pool=None, caller: ClusterCaller = None,
                window_s: float = None) -> dict:
        """Pull, align, conclude, retain. Never raises on a partially
        reachable cluster — whatever could not be scraped is listed under
        ``errors`` and the artifact still lands (a flight recorder that
        needs a healthy cluster to record records nothing useful)."""
        window_s = _window_s() if window_s is None else float(window_s)
        anchor = time.time()
        own = caller is None
        caller = caller or ClusterCaller(meta_addrs, pool=pool, timeout=3.0)
        nodes_detail, errors, timeline = {}, [], []
        try:
            state = caller.meta_state()
            alive = sorted(a for a, n in (state or {}).get("nodes", {}).items()
                           if n.get("alive"))
            if state is None:
                errors.append("no meta reachable: artifact holds the "
                              "capturing process's ring only")
            for node in alive:
                nodes_detail[node] = self._pull_node(
                    caller, node, window_s, anchor, timeline, errors)
        finally:
            if own:
                caller.close()
        # the capturing process's own ring: audit/doctor verdict events,
        # plus (in an in-process onebox harness) every local subsystem
        local = f"local:{os.getpid()}"
        local_events = events.EVENTS.snapshot(since=anchor - window_s)
        for ev in local_events:
            timeline.append(dict(ev, node=local, pid=f"pid:{os.getpid()}"))
        timeline.sort(key=lambda e: (e["ts"], e.get("node", ""),
                                     e.get("seq", 0)))
        # dedup by (pid, seq, name, ts): in an in-process onebox every
        # "node" answers events-dump from the SAME ring, and the
        # capturing process's own snapshot is that ring again — one copy
        # of each event keeps the timeline honest (the surviving node
        # label says which scrape reached the shared process first).
        # name+ts stay in the key so two HOSTS whose OS pids happen to
        # collide never collapse distinct events into one.
        seen, deduped = set(), []
        for ev in timeline:
            key = (ev.get("pid"), ev.get("seq"), ev.get("name"),
                   ev.get("ts"))
            if key in seen:
                continue
            seen.add(key)
            deduped.append(ev)
        timeline = deduped
        for ev in timeline:
            ev["t_rel"] = round(ev["ts"] - anchor, 3)
        first_cause = next((e for e in timeline
                            if e["name"] in FIRST_CAUSE_NAMES), None)
        with self._lock:
            self._seq += 1
            incident_id = f"inc-{int(anchor)}-{os.getpid()}-{self._seq}"
        incident = {
            "id": incident_id,
            "anchor_ts": anchor,
            "window_s": window_s,
            "reason": reason,
            "trigger": trigger,
            "first_cause": first_cause,
            "timeline": timeline,
            "nodes": nodes_detail,
            "local_events": len(local_events),
            # the capturing process's own in-window job timelines — in an
            # in-process onebox this is every plane's shared tracer view
            "jobs": JOB_TRACER.window(window_s),
            "errors": errors,
        }
        # tenant plane: when a table is burning its SLO, the
        # artifact embeds that table's in-window series (the ledger's
        # table.<name>.* charges plus the evaluator's slo.<name>.* burn
        # gauges from the local history ring) — the incident names the
        # tenant AND carries the numbers that convicted it
        try:
            from ..runtime.metric_history import HISTORY
            from .info_collector import latest_slo

            slo_tables = {}
            for table, v in latest_slo().items():
                if v.get("verdict") != "burning":
                    continue
                slo_tables[table] = {
                    "verdict": v,
                    "series": HISTORY.window(seconds=window_s,
                                             prefix=f"table.{table}."),
                    "slo_series": HISTORY.window(seconds=window_s,
                                                 prefix=f"slo.{table}."),
                }
            if slo_tables:
                incident["slo_tables"] = slo_tables
        except Exception as e:  # noqa: BLE001 - embed is best-effort
            errors.append(f"slo_tables: {e!r}")
        incident["path"] = self._retain(incident)
        self._c_capture.increment()
        events.emit("incident.captured", severity="warn", id=incident_id,
                    reason=reason[:200], trigger=trigger,
                    first_cause=(first_cause or {}).get("name", ""))
        with self._lock:
            self._last_capture_ts = anchor
            self._last_incident_id = incident_id
        return incident

    def _pull_node(self, caller, node, window_s, anchor, timeline,
                   errors) -> dict:
        """One node's share of the artifact: events merged into the
        timeline, history/slow/trace kept per node."""
        detail = {}
        try:
            dumped = json.loads(caller.remote_command(
                node, "events-dump", []))
            n_events = 0
            for pid_key, evs in dumped.items():
                for ev in evs:
                    if ev.get("ts", 0) >= anchor - window_s:
                        timeline.append(dict(ev, node=node, pid=pid_key))
                        n_events += 1
            detail["events"] = n_events
        except (RpcError, OSError, ValueError) as e:
            errors.append(f"{node}: events-dump: {e}")
        try:
            detail["history"] = json.loads(caller.remote_command(
                node, "metrics-history", [str(window_s)]))
        except (RpcError, OSError, ValueError) as e:
            errors.append(f"{node}: metrics-history: {e}")
        try:
            detail["slow_requests"] = json.loads(caller.remote_command(
                node, "slow-requests", ["10"]))
        except (RpcError, OSError, ValueError) as e:
            errors.append(f"{node}: slow-requests: {e}")
        try:
            detail["traces"] = json.loads(caller.remote_command(
                node, "request-trace-dump", ["10"]))
        except (RpcError, OSError, ValueError) as e:
            errors.append(f"{node}: request-trace-dump: {e}")
        try:
            # the background-job timelines: a first-cause
            # event can name the compaction/offload/learn job it wedged
            detail["jobs"] = json.loads(caller.remote_command(
                node, "job-trace", ["20"]))
        except (RpcError, OSError, ValueError) as e:
            errors.append(f"{node}: job-trace: {e}")
        return detail

    # ----------------------------------------------------------- retention

    def _retain(self, incident: dict) -> str:
        """Write the artifact; prune to the newest PEGASUS_INCIDENT_KEEP.
        A failed write degrades to an unretained (in-memory) incident —
        the capture still returns."""
        d = _incident_dir()
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, incident["id"] + ".json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(incident, f, indent=1, default=str)
            os.replace(tmp, path)
            kept = sorted(
                (p for p in os.listdir(d) if p.endswith(".json")),
                key=lambda p: os.path.getmtime(os.path.join(d, p)))
            for stale in kept[:-_keep()]:
                try:
                    os.unlink(os.path.join(d, stale))
                except OSError:
                    pass
            return path
        except OSError as e:
            incident["errors"].append(f"retention failed: {e}")
            return ""

    def list_incidents(self) -> list:
        """Retained artifacts, newest first: [{id, ts, reason, trigger,
        first_cause}] — the light listing GET /incidents serves."""
        d = _incident_dir()
        out = []
        try:
            names = sorted(
                (p for p in os.listdir(d) if p.endswith(".json")),
                key=lambda p: os.path.getmtime(os.path.join(d, p)),
                reverse=True)
        except OSError:
            return out
        for name in names:
            try:
                with open(os.path.join(d, name)) as f:
                    inc = json.load(f)
            except (OSError, ValueError):
                continue
            out.append({"id": inc.get("id", name[:-5]),
                        "ts": inc.get("anchor_ts"),
                        "reason": inc.get("reason"),
                        "trigger": inc.get("trigger"),
                        "first_cause": (inc.get("first_cause") or {}
                                        ).get("name")})
        return out

    def load(self, incident_id: str):
        """One full artifact by id, or None. The id is caller-supplied
        (GET /incidents?id=...), so anything that could escape the
        incident dir is rejected, not joined."""
        if (not incident_id or ".." in incident_id
                or incident_id != os.path.basename(incident_id)):
            return None
        path = os.path.join(_incident_dir(), incident_id + ".json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ---------------------------------------------------------- auto-wire

    def observe_verdict(self, verdict: dict, meta_addrs,
                        caller: ClusterCaller = None):
        """The cluster doctor's hook: capture on a healthy→degraded/
        critical transition (cooldown-bounded); while the cluster STAYS
        unhealthy inside the cooldown the last incident's id keeps
        riding the verdict, so a second doctor run minutes into the same
        incident points at the same artifact. -> incident id or None."""
        v = verdict.get("verdict")
        now = time.time()
        with self._lock:
            prev, self._last_verdict = self._last_verdict, v
            if v not in ("degraded", "critical"):
                return None
            if prev in ("degraded", "critical"):
                # the SAME incident continuing: keep pointing at it
                return self._last_incident_id
            if now - self._last_capture_ts < _cooldown_s():
                # a FRESH transition inside the cooldown (flapping
                # cluster): no capture — and no id either, because the
                # last artifact documents a different excursion and
                # attaching it here would mislabel the evidence
                return None
        inc = self.capture(meta_addrs,
                           reason="doctor verdict "
                                  f"{prev or 'unseen'} -> {v}: "
                           + "; ".join(c["cause"] for c in
                                       verdict.get("causes", [])[:3]),
                           trigger="doctor", caller=caller)
        return inc["id"]

    def reset(self) -> None:
        """Test hook: forget verdict/cooldown state (artifacts stay)."""
        with self._lock:
            self._last_verdict = None
            self._last_capture_ts = 0.0
            self._last_incident_id = None


# process-wide recorder (verdict-transition state is per process, like
# the event ring it correlates)
RECORDER = FlightRecorder()
