"""Cluster doctor: fold what the cluster exports into ONE verdict.

Port of pegasus_tpu/collector/cluster_doctor.py. Consumers of the
cluster's RPC surfaces:

- ``run_cluster_audit``: the decree-anchored consistency audit.
  For every partition it fires the ``trigger-audit`` remote command on
  the primary (a no-op mutation riding the PacificA prepare path, so the
  primary and every secondary digest their state at the SAME applied
  decree), then collects each secondary's digest via ``query-audit`` and
  compares AT EQUAL DECREES ONLY. A node that cannot report (dead,
  reconfiguring, never applied) makes that partition *inconclusive*,
  never a false mismatch. The port audits AUDIT_WORKERS partitions at
  once where the reference walks them one by one; the report is the
  serial walk's, entry for entry.

- ``run_cluster_doctor``: one verdict (``healthy | degraded | critical
  | inconclusive``) with named causes and evidence, folded from the
  meta's one-RPC cluster-state snapshot (liveness, partition configs,
  the beacon-folded lag and audit states) plus per-node scrapes (lane
  breakers, dispatch queue depth) and the cluster-wide slow-request
  rollup. The shell's ``cluster_doctor`` prints it.

- ``run_cross_cluster_audit``: a duplication leg's table-level compare
  between two clusters, anchored at the duplicator's confirmed decree
  (the source's audit, a wait until the meta's beacon-folded confirmed
  decree reaches every anchor, the destination's audit, and the folded
  digests compared). The shell's ``cross_cluster_audit`` prints it.

All are plain functions over RPC surfaces, so the shell, tests and
chip_smoke.py call the same code against either package's cluster.

After each verdict the doctor runs the reference's two hooks: the
flight recorder (collector/flight_recorder.py) captures an incident on
a healthy -> degraded / critical transition, and the auto-healer
(collector/auto_heal.py) quarantines the one replica an audit isolates;
their results ride the verdict as ``incident`` and ``autoheal``.

The port has no lane guard, so no port node exports
``*.lane.breaker_open`` and the breaker check never fires against one.
"""

import json
import os
import threading
import time

from ..base.utils import epoch_now
from ..meta import messages as mm
from ..meta.meta_server import RPC_CM_QUERY_CLUSTER_STATE
from ..rpc import codec
from ..rpc.transport import ConnectionPool, RpcError
from ..runtime import events
from ..runtime.perf_counters import counters
from ..runtime.remote_command import (RemoteCommandRequest,
                                      RemoteCommandResponse)

# partitions audited at once: each digest costs a replica O(its records)
# in its apply path, and one partition at a time would wait out every
# digest of a large table in turn
AUDIT_WORKERS = 8

HEALTHY = "healthy"
DEGRADED = "degraded"
CRITICAL = "critical"
INCONCLUSIVE = "inconclusive"
_VERDICT_GAUGE = {HEALTHY: 0, DEGRADED: 1, CRITICAL: 2, INCONCLUSIVE: -1}


class ClusterCaller:
    """Thin RPC helper the audit, the doctor and the scheduler share: the
    meta's cluster-state query and remote commands against nodes. Pass an
    existing pool or let it own one (one-shot callers)."""

    def __init__(self, meta_addrs, pool: ConnectionPool = None,
                 timeout: float = 5.0):
        self.meta_addrs = list(meta_addrs)
        self._own_pool = pool is None
        self.pool = pool or ConnectionPool()
        self.timeout = timeout

    def close(self):
        if self._own_pool:
            self.pool.close()

    def _call(self, addr: str, code: str, body: bytes) -> bytes:
        host, _, port = addr.rpartition(":")
        conn = self.pool.get((host, int(port)))
        _, out = conn.call(code, body, timeout=self.timeout)
        return out

    def meta_state(self):
        """The meta's cluster-state snapshot, or None when no meta
        answers (the doctor then reports inconclusive, not healthy)."""
        body = codec.encode(mm.QueryClusterStateRequest())
        for m in self.meta_addrs:
            try:
                resp = codec.decode(mm.QueryClusterStateResponse,
                                    self._call(m, RPC_CM_QUERY_CLUSTER_STATE,
                                               body))
                return json.loads(resp.state_json)
            except (RpcError, OSError, ValueError):
                continue
        return None

    def remote_command(self, addr: str, command: str, args) -> str:
        body = self._call(addr, "RPC_CLI_CLI_CALL", codec.encode(
            RemoteCommandRequest(command, list(args))))
        return codec.decode(RemoteCommandResponse, body).output


# ================================================================= audit


def run_cluster_audit(meta_addrs, pool: ConnectionPool = None,
                      apps: list = None, wait_s: float = 5.0,
                      caller: ClusterCaller = None, now: int = None) -> dict:
    """Trigger and verify a decree-anchored consistency audit across every
    partition of every (or each named) app. -> report dict:

    ``{"partitions": N, "ok": [gpid...], "mismatches": [{app, app_id,
    pidx, gpid, node, decree, digest, expected}...], "inconclusive":
    [{gpid, node?, reason}...], "digests": {gpid: {node: {decree,
    digest}}}, "primaries": {gpid: {node, decree, digest, records}}}``

    Zero mismatches with every partition in ``ok`` means every replica
    held the same logical state at the same applied decree. `now` (epoch
    seconds) overrides each primary's own expiry clock."""
    from concurrent.futures import ThreadPoolExecutor

    own = caller is None
    caller = caller or ClusterCaller(meta_addrs, pool=pool)
    report = {"partitions": 0, "ok": [], "mismatches": [],
              "inconclusive": [], "digests": {}, "primaries": {}}

    def audit(job):
        sub = {"ok": [], "mismatches": [], "inconclusive": [],
               "digests": {}, "primaries": {}}
        _audit_partition(caller, sub, *job, wait_s, now)
        return sub

    try:
        state = caller.meta_state()
        if state is None:
            report["inconclusive"].append(
                {"gpid": "*", "reason": "no meta reachable"})
            return report
        jobs = [(app_name, app["app_id"], pc)
                for app_name, app in sorted(state.get("apps", {}).items())
                if not apps or app_name in apps
                for pc in app.get("partitions", [])]
        report["partitions"] = len(jobs)
        with ThreadPoolExecutor(max(1, min(AUDIT_WORKERS, len(jobs))),
                                thread_name_prefix="audit") as ex:
            for sub in ex.map(audit, jobs):  # in the serial walk's order
                for k in ("ok", "mismatches", "inconclusive"):
                    report[k].extend(sub[k])
                report["digests"].update(sub["digests"])
                report["primaries"].update(sub["primaries"])
    finally:
        if own:
            caller.close()
    return report


def _audit_partition(caller, report, app_name, app_id, pc, wait_s, now=None):
    gpid = f"{app_id}.{pc['pidx']}"
    if not pc.get("primary"):
        report["inconclusive"].append(
            {"gpid": gpid, "reason": "no primary assigned"})
        return
    args = [gpid] if now is None else [gpid, f"now={int(now)}"]
    try:
        out = caller.remote_command(pc["primary"], "trigger-audit", args)
    except (RpcError, OSError) as e:
        report["inconclusive"].append(
            {"gpid": gpid, "node": pc["primary"],
             "reason": f"primary unreachable: {e}"})
        return
    try:
        primary_audit = json.loads(out) if out else {}
    except ValueError:
        primary_audit = {}
    if not primary_audit or primary_audit.get("error"):
        report["inconclusive"].append(
            {"gpid": gpid, "node": pc["primary"],
             "reason": primary_audit.get("error", "no trigger-audit reply")})
        return
    decree = primary_audit["decree"]
    expected = primary_audit["digest"]
    digests = {pc["primary"]: {"decree": decree, "digest": expected}}
    report["digests"][gpid] = digests
    report["primaries"][gpid] = {
        "node": pc["primary"], "decree": decree, "digest": expected,
        "records": primary_audit.get("records", 0)}
    clean = True
    for node in pc.get("secondaries", []):
        got = _poll_secondary_audit(caller, node, gpid, decree, wait_s)
        if got is None:
            report["inconclusive"].append(
                {"gpid": gpid, "node": node,
                 "reason": f"no digest at decree {decree} within "
                           f"{wait_s:.1f}s (dead / reconfiguring / "
                           "superseded)"})
            clean = False
            continue
        digests[node] = got
        if got["digest"] != expected:
            report["mismatches"].append(
                {"app": app_name, "app_id": app_id, "pidx": pc["pidx"],
                 "gpid": gpid, "node": node, "decree": decree,
                 "digest": got["digest"], "expected": expected})
            events.emit("audit.mismatch", severity="error", gpid=gpid,
                        node=node, decree=decree)
            clean = False
    if clean:
        report["ok"].append(gpid)


def _poll_secondary_audit(caller, node, gpid, decree, wait_s):
    """-> {"decree", "digest"} once the node reports an audit AT `decree`,
    or None on timeout, unreachable or superseded. Comparing at EQUAL
    decrees only is what turns a kill into inconclusive instead of a
    false mismatch."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            out = caller.remote_command(node, "query-audit", [gpid])
            ent = json.loads(out).get(gpid, {})
            audit = ent.get("audit")
            if audit and audit.get("decree", 0) >= decree:
                if audit["decree"] != decree:
                    return None  # superseded by a newer audit
                if not audit.get("digest"):
                    return None  # the digest computation failed
                return {"decree": audit["decree"],
                        "digest": audit["digest"]}
        except (RpcError, OSError, ValueError):
            pass
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)


def fold_table_digest(entries) -> dict:
    """Commutative table-level fold of per-partition engine digests. Each
    digest is ``{xor:016x}{add:016x}`` over one crc64 per live record
    (engine.state_digest); both combines are commutative and associative,
    so folding partitions (xor of xors, sum of adds, sum of counts)
    yields the digest of the table's record SET, however it is
    partitioned. `entries`: (digest, records) pairs."""
    xor = add = n = 0
    for digest, records in entries:
        xor ^= int(digest[:16], 16)
        add = (add + int(digest[16:32], 16)) & 0xFFFFFFFFFFFFFFFF
        n += int(records)
    return {"digest": f"{xor:016x}{add:016x}", "records": n}


def run_cross_cluster_audit(src_meta_addrs, dst_meta_addrs, app: str,
                            dupid: int = None, wait_s: float = 20.0,
                            confirm_wait_s: float = 30.0,
                            pool: ConnectionPool = None,
                            timeout: float = 5.0) -> dict:
    """Cross-CLUSTER consistency compare for a duplication leg,
    anchored at the duplicator's confirmed decree. Requires the
    caller to have QUIESCED writes to `app` (the chaos harness runs it
    after the load stops): shipping is asynchronous, so the compare
    waits for the duplicators to confirm through the anchor rather than
    assuming they are caught up.

    Protocol:

    1. decree-anchored audit on the SOURCE cluster: every partition's
       primary digests its owned live state at an anchor decree;
    2. wait until the meta's beacon-folded dup ``confirmed`` decree
       reaches each partition's anchor — every mutation below the
       anchor has then been shipped AND acked by the remote cluster
       (the remote acks only after its own PacificA commit+apply);
    3. decree-anchored audit on the DESTINATION cluster;
    4. fold both sides' per-partition digests into one table-level
       digest each (fold_table_digest) and compare.

    -> ``{"app", "match": True|False|None, "src", "dst",
    "anchors": {gpid: decree}, "confirmed": {pidx: decree},
    "inconclusive": [reason...], "mismatches": [...]}`` — ``match`` is
    None when any step was inconclusive (never a false mismatch).
    The port adds ``"seconds": {"source_audit", "confirm_wait",
    "destination_audit"}``, each step's wall time as far as the compare
    got, and `timeout`, which bounds each meta query and remote command
    of both audits, as ClusterCaller's does: a primary's trigger-audit
    digests its whole partition inside the call."""
    report = {"app": app, "match": None, "src": None, "dst": None,
              "anchors": {}, "confirmed": {}, "inconclusive": [],
              "mismatches": []}
    caller = ClusterCaller(src_meta_addrs, pool=pool, timeout=timeout)
    try:
        state = caller.meta_state()
        if state is None or app not in state.get("apps", {}):
            report["inconclusive"].append(
                f"source cluster state unavailable or no app {app!r}")
            return report
        app_id = state["apps"][app]["app_id"]
        entry = _pick_dup_entry(state, app_id, dupid)
        if entry is None:
            report["inconclusive"].append(
                f"no active duplication on {app!r} "
                f"(dupid={dupid if dupid is not None else 'any'})")
            return report
        report["dupid"] = entry["dupid"]
        # ONE expiry anchor for both sides: the audits run seconds apart,
        # and a TTL record expiring in between would otherwise diverge
        # the two digests on byte-identical data (false mismatch)
        audit_now = epoch_now()
        t0 = time.perf_counter()
        src_audit = run_cluster_audit(src_meta_addrs, apps=[app],
                                      wait_s=wait_s, caller=caller,
                                      now=audit_now)
        seconds = report["seconds"] = {
            "source_audit": time.perf_counter() - t0}
        if len(src_audit["ok"]) != src_audit["partitions"] \
                or not src_audit["primaries"]:
            report["inconclusive"].append(
                "source audit incomplete: "
                f"{len(src_audit['ok'])}/{src_audit['partitions']} "
                "partitions conclusive")
            report["src_audit"] = {k: src_audit[k]
                                   for k in ("mismatches", "inconclusive")}
            return report
        report["anchors"] = {g: p["decree"]
                             for g, p in src_audit["primaries"].items()}
        t0 = time.perf_counter()
        lagging = _wait_confirmed(caller, app, app_id, entry["dupid"],
                                  src_audit["primaries"], confirm_wait_s,
                                  report)
        seconds["confirm_wait"] = time.perf_counter() - t0
        if lagging:
            report["inconclusive"].append(
                "duplicator confirmed decree never reached the anchor "
                f"within {confirm_wait_s:.0f}s for partition(s) {lagging}")
            return report
    finally:
        caller.close()
    dst_caller = ClusterCaller(dst_meta_addrs, pool=pool, timeout=timeout)
    t0 = time.perf_counter()
    try:
        dst_audit = run_cluster_audit(dst_meta_addrs, apps=[app],
                                      wait_s=wait_s, caller=dst_caller,
                                      now=audit_now)
    finally:
        dst_caller.close()
    seconds["destination_audit"] = time.perf_counter() - t0
    if len(dst_audit["ok"]) != dst_audit["partitions"] \
            or not dst_audit["primaries"]:
        report["inconclusive"].append(
            "destination audit incomplete: "
            f"{len(dst_audit['ok'])}/{dst_audit['partitions']} "
            "partitions conclusive")
        return report
    report["src"] = fold_table_digest(
        (p["digest"], p["records"]) for p in src_audit["primaries"].values())
    report["dst"] = fold_table_digest(
        (p["digest"], p["records"]) for p in dst_audit["primaries"].values())
    report["match"] = report["src"]["digest"] == report["dst"]["digest"] \
        and report["src"]["records"] == report["dst"]["records"]
    if not report["match"]:
        report["mismatches"].append(
            {"app": app, "src": report["src"], "dst": report["dst"],
             "anchors": report["anchors"]})
    return report


def _pick_dup_entry(state, app_id: int, dupid):
    for e in state.get("dups", {}).get(str(app_id), []):
        if dupid is not None and e.get("dupid") != dupid:
            continue
        if dupid is not None or e.get("status") == "start":
            return e
    return None


def _wait_confirmed(caller, app, app_id, dupid, primaries, confirm_wait_s,
                    report):
    """Poll the source meta until the dup entry's beacon-folded confirmed
    decree reaches every partition's anchor. -> list of lagging pidx
    (empty = fully confirmed)."""
    anchors = {int(g.split(".")[1]): p["decree"] for g, p in primaries.items()}
    deadline = time.monotonic() + confirm_wait_s
    while True:
        state = caller.meta_state()
        conf = {}
        if state is not None:
            e = _pick_dup_entry(state, app_id, dupid)
            conf = (e or {}).get("confirmed", {})
        report["confirmed"] = conf
        lagging = [p for p, d in sorted(anchors.items())
                   if int(conf.get(str(p), 0)) < d]
        if not lagging or time.monotonic() >= deadline:
            return lagging
        time.sleep(0.2)


# ===================================================== periodic audit rounds


class AuditRounds:
    """A periodic audit cadence for runs under load: a background thread
    audits every `every_s` seconds and books each round conclusive
    (every partition in ``ok``) or vacuous (zero mismatches without full
    coverage says nothing). Counters: ``audit.round.count`` /
    ``.conclusive`` / ``.vacuous`` / ``.mismatch_count``.

    `journal` is any object with ``record(kind, **fields)`` and
    ``fail(name, **fields)``; None = no journaling."""

    def __init__(self, meta_addrs, apps=None, every_s: float = 5.0,
                 wait_s: float = 5.0, journal=None,
                 pool: ConnectionPool = None):
        from ..runtime import lockrank
        from ..runtime.tasking import spawn_thread

        self.meta_addrs = list(meta_addrs)
        self.apps = list(apps) if apps else None
        self.every_s = every_s
        self.wait_s = wait_s
        self.journal = journal
        self.pool = pool
        self._lock = lockrank.named_lock("audit.rounds")
        self.rounds = []   #: guarded_by self._lock
        self._stop = threading.Event()
        self._thread = spawn_thread(self._loop, daemon=True, start=False,
                                    name="audit-rounds")

    def start(self) -> "AuditRounds":
        self._thread.start()
        return self

    def stop(self, final_round: bool = True) -> dict:
        """Stop the cadence (joining the loop); final_round runs one more
        audit after the caller quiesced. -> summary()."""
        self._stop.set()
        self._thread.join(timeout=max(30.0, self.wait_s * 4))
        if final_round:
            self._run_round(final=True)
        return self.summary()

    def _loop(self):
        while not self._stop.wait(self.every_s):
            try:
                self._run_round()
            except Exception as e:  # noqa: BLE001 - the cadence survives
                # RPC storms; the round is recorded as vacuous
                with self._lock:
                    self.rounds.append({"error": repr(e), "conclusive": False,
                                        "mismatches": []})
                if self.journal is not None:
                    self.journal.record("audit.round.error", error=repr(e))

    def _run_round(self, final: bool = False):
        report = run_cluster_audit(self.meta_addrs, apps=self.apps,
                                   wait_s=self.wait_s, pool=self.pool)
        rnd = {"ok": len(report["ok"]), "partitions": report["partitions"],
               "mismatches": report["mismatches"],
               "inconclusive": report["inconclusive"],
               "conclusive": (report["partitions"] > 0
                              and len(report["ok"]) == report["partitions"]),
               "final": final}
        counters.rate("audit.round.count").increment()
        if rnd["conclusive"]:
            counters.rate("audit.round.conclusive").increment()
        else:
            counters.rate("audit.round.vacuous").increment()
        if rnd["mismatches"]:
            counters.rate("audit.round.mismatch_count").increment(
                len(rnd["mismatches"]))
        with self._lock:
            self.rounds.append(rnd)
        if self.journal is not None:
            self.journal.record("audit.round", ok=rnd["ok"],
                                partitions=rnd["partitions"],
                                conclusive=rnd["conclusive"], final=final,
                                mismatches=len(rnd["mismatches"]))
            for m in rnd["mismatches"]:
                self.journal.fail("audit.mismatch", **m)

    def summary(self) -> dict:
        with self._lock:
            rounds = list(self.rounds)
        mismatches = [m for r in rounds for m in r["mismatches"]]
        return {"rounds": len(rounds),
                "conclusive": sum(1 for r in rounds if r["conclusive"]),
                "vacuous": sum(1 for r in rounds if not r["conclusive"]),
                "mismatches": mismatches}


# ================================================================ doctor


def _gap_threshold() -> int:
    return int(os.environ.get("PEGASUS_DOCTOR_GAP_DEGRADED", "128"))


def _queue_threshold() -> int:
    return int(os.environ.get("PEGASUS_DOCTOR_QUEUE_DEGRADED", "64"))


def run_cluster_doctor(meta_addrs, pool: ConnectionPool = None,
                       scrape: bool = True, slow_last: int = 10,
                       caller: ClusterCaller = None) -> dict:
    """ONE structured health verdict for the whole cluster.

    -> ``{"verdict": healthy|degraded|critical|inconclusive,
          "causes": [{"severity", "cause", "evidence"}...],
          "evidence": {nodes, partitions, lag, audit, quarantine,
                       scrapes, slow_requests}, "ts": unix_seconds}``

    Any critical cause -> ``critical``; else any degraded cause ->
    ``degraded``; else ``healthy``. A cluster whose state cannot be read
    at all (no meta) is ``inconclusive``. Audit evidence comes only from
    digests at EQUAL decrees; members that have not reported yet are
    listed under ``evidence.audit.pending``, never as mismatches."""
    own = caller is None
    caller = caller or ClusterCaller(meta_addrs, pool=pool)
    causes, evidence = [], {}
    try:
        state = caller.meta_state()
        if state is None:
            verdict = {"verdict": INCONCLUSIVE,
                       "causes": [{"severity": INCONCLUSIVE,
                                   "cause": "no meta server reachable",
                                   "evidence": "meta"}],
                       "evidence": {"meta_addrs": list(meta_addrs)},
                       "ts": time.time()}
            _export_verdict(verdict)
            return verdict
        _check_nodes(state, causes, evidence)
        _check_partitions(state, causes, evidence)
        _check_lag(state, causes, evidence)
        _check_audit(state, causes, evidence)
        _check_quarantine(state, causes, evidence)
        _check_slo(causes, evidence)
        if scrape:
            _scrape_nodes(caller, state, causes, evidence, slow_last)
        verdict = CRITICAL if any(c["severity"] == CRITICAL
                                  for c in causes) \
            else DEGRADED if causes else HEALTHY
        out = {"verdict": verdict, "causes": causes, "evidence": evidence,
               "ts": time.time()}
        _export_verdict(out)
        # a healthy -> degraded/critical transition captures an incident;
        # its id rides the verdict so every doctor surface points at the
        # evidence bundle
        try:
            from .flight_recorder import RECORDER

            incident = RECORDER.observe_verdict(out, list(meta_addrs),
                                                caller=caller)
            if incident:
                out["incident"] = incident
        except Exception as e:  # noqa: BLE001 - the verdict must never
            # fail because evidence gathering did
            print(f"[doctor] incident capture failed: {e!r}", flush=True)
        # audit-driven auto-heal: gated off unless PEGASUS_AUTOHEAL=1,
        # interlocked and rate-limited inside
        try:
            from .auto_heal import AUTO_HEALER

            healed = AUTO_HEALER.observe_verdict(out, caller=caller)
            if healed:
                out["autoheal"] = healed
        except Exception as e:  # noqa: BLE001 - heal is best-effort
            print(f"[doctor] auto-heal failed: {e!r}", flush=True)
        return out
    finally:
        if own:
            caller.close()


def _export_verdict(out: dict) -> None:
    counters.rate("doctor.run_count").increment()
    counters.number("doctor.verdict").set(_VERDICT_GAUGE[out["verdict"]])
    events.emit("doctor.verdict",
                severity={CRITICAL: "error", DEGRADED: "warn"}.get(
                    out["verdict"], "info"),
                verdict=out["verdict"], causes=len(out.get("causes", ())))


def _check_nodes(state, causes, evidence) -> None:
    nodes = state.get("nodes", {})
    dead = sorted(a for a, n in nodes.items() if not n["alive"])
    evidence["nodes"] = {"total": len(nodes), "dead": dead}
    for addr in dead:
        causes.append({"severity": DEGRADED,
                       "cause": f"node {addr} dead "
                                f"(last beacon "
                                f"{nodes[addr]['last_beacon_ago_s']:.0f}s "
                                "ago)",
                       "evidence": "nodes.dead"})


def _check_partitions(state, causes, evidence) -> None:
    nodes = state.get("nodes", {})
    alive = {a for a, n in nodes.items() if n["alive"]}
    unserved, under = [], []
    for app_name, app in state.get("apps", {}).items():
        want = app.get("replica_count", 0)
        for pc in app.get("partitions", []):
            gpid = f"{app['app_id']}.{pc['pidx']}"
            members = [m for m in [pc.get("primary")]
                       + pc.get("secondaries", []) if m]
            live = [m for m in members if m in alive]
            if not pc.get("primary") or pc["primary"] not in alive:
                unserved.append({"app": app_name, "gpid": gpid,
                                 "primary": pc.get("primary", "")})
            elif want and len(live) < want:
                under.append({"app": app_name, "gpid": gpid,
                              "live": len(live), "want": want})
    evidence["partitions"] = {"unserved": unserved,
                              "under_replicated": under}
    for u in unserved:
        causes.append({"severity": CRITICAL,
                       "cause": f"partition {u['app']}.{u['gpid']} has no "
                                "live primary — writes are down",
                       "evidence": "partitions.unserved"})
    for u in under:
        causes.append({"severity": DEGRADED,
                       "cause": f"partition {u['app']}.{u['gpid']} "
                                f"under-replicated ({u['live']}/{u['want']})",
                       "evidence": "partitions.under_replicated"})


def _check_lag(state, causes, evidence) -> None:
    """Replication lag over the beacon-folded per-replica states, measured
    within one replica's own snapshot: commit lag as prepared-committed
    (decrees staged whose commit point never arrived), apply lag as
    committed-applied (the engine behind replication). Cross-node
    frontier compares are not causes: beacons are asynchronous per node,
    so a healthy cluster writing faster than the beacon interval would
    read as degraded."""
    nodes = state.get("nodes", {})
    per_gpid = {}
    for node, states in state.get("replica_states", {}).items():
        # a dead node's states are frozen at its last beacon; its death
        # is already a cause of its own (_check_nodes)
        if not nodes.get(node, {}).get("alive", True):
            continue
        for gpid, st in states.items():
            per_gpid.setdefault(gpid, {})[node] = st
    thr = _gap_threshold()
    worst = {"commit_gap": 0, "apply_gap": 0}
    offenders = []
    for gpid, members in per_gpid.items():
        for node, st in members.items():
            commit_gap = st.get("prepared", 0) - st.get("committed", 0)
            apply_gap = st.get("committed", 0) - st.get("applied", 0)
            worst["commit_gap"] = max(worst["commit_gap"], commit_gap)
            worst["apply_gap"] = max(worst["apply_gap"], apply_gap)
            if commit_gap >= thr:
                offenders.append({"gpid": gpid, "node": node,
                                  "kind": "commit", "gap": commit_gap})
                causes.append({"severity": DEGRADED,
                               "cause": f"replica {gpid}@{node} behind on "
                                        f"COMMIT by {commit_gap} decrees "
                                        "(staged but uncommitted)",
                               "evidence": "lag.offenders"})
            if apply_gap >= thr:
                offenders.append({"gpid": gpid, "node": node,
                                  "kind": "apply", "gap": apply_gap})
                causes.append({"severity": DEGRADED,
                               "cause": f"replica {gpid}@{node} behind on "
                                        f"APPLY by {apply_gap} decrees",
                               "evidence": "lag.offenders"})
    evidence["lag"] = {"worst": worst, "offenders": offenders,
                       "threshold": thr}


def _check_audit(state, causes, evidence) -> None:
    """Compare the beacon-reported audit digests per partition, at EQUAL
    decrees only. The reference digest is the primary's when it reported
    at that decree, else a strict majority's; every disagreeing node is
    named."""
    primaries = {}
    for app in state.get("apps", {}).values():
        for pc in app.get("partitions", []):
            primaries[f"{app['app_id']}.{pc['pidx']}"] = pc.get("primary")
    nodes = state.get("nodes", {})
    per_gpid = {}
    for node, states in state.get("replica_states", {}).items():
        if not nodes.get(node, {}).get("alive", True):
            continue  # frozen states of a dead node (see _check_lag)
        for gpid, st in states.items():
            # a failed digest (empty) is not comparable evidence: pending,
            # never a mismatch
            if st.get("audit", {}).get("digest"):
                per_gpid.setdefault(gpid, {})[node] = st["audit"]
    mismatches, pending, checked = [], [], []
    for gpid, audits in sorted(per_gpid.items()):
        latest = max(a["decree"] for a in audits.values())
        at = {n: a for n, a in audits.items() if a["decree"] == latest}
        behind = sorted(set(audits) - set(at))
        if behind:
            pending.append({"gpid": gpid, "decree": latest, "nodes": behind})
        if len(at) < 2:
            continue  # nothing to compare yet
        prim = primaries.get(gpid)
        if prim in at:
            ref = at[prim]["digest"]
        else:
            # no primary report at this decree: a STRICT majority picks
            # the reference; a tie is not attributable and waits for the
            # primary's beacon
            votes = {}
            for a in at.values():
                votes[a["digest"]] = votes.get(a["digest"], 0) + 1
            ref = max(votes, key=votes.get)
            if votes[ref] * 2 <= len(at):
                pending.append({"gpid": gpid, "decree": latest,
                                "nodes": sorted(at),
                                "reason": "digests disagree with no "
                                          "majority and no primary report "
                                          "yet — not attributable"})
                continue
        checked.append(gpid)
        for node, a in sorted(at.items()):
            if a["digest"] != ref:
                mismatches.append({"gpid": gpid, "node": node,
                                   "decree": latest,
                                   "digest": a["digest"], "expected": ref})
    evidence["audit"] = {"checked": checked, "mismatches": mismatches,
                         "pending": pending}
    for m in mismatches:
        causes.append({"severity": CRITICAL,
                       "cause": f"consistency digest MISMATCH at partition "
                                f"{m['gpid']} on node {m['node']} "
                                f"(decree {m['decree']})",
                       "evidence": "audit.mismatches"})


def _check_quarantine(state, causes, evidence) -> None:
    """Beacon-reported QUARANTINED replicas: degraded, not critical (the
    healthy members keep serving); the cause names node, partition and
    reason."""
    quarantined = []
    for node, states in state.get("replica_states", {}).items():
        for gpid, st in states.items():
            if st.get("status") != "QUARANTINED":
                continue
            q = st.get("quarantine", {})
            quarantined.append({"gpid": gpid, "node": node,
                                "reason": q.get("reason", ""),
                                "source": q.get("source", ""),
                                "dir": q.get("dir", "")})
    evidence["quarantine"] = quarantined
    for q in sorted(quarantined, key=lambda x: (x["gpid"], x["node"])):
        causes.append({"severity": DEGRADED,
                       "cause": f"replica {q['gpid']} on node {q['node']} "
                                f"quarantined ({q['source']}: "
                                f"{q['reason'] or 'corruption'})",
                       "evidence": "quarantine"})


def _check_slo(causes, evidence) -> None:
    """Tenant SLO verdicts: a table whose burn rate says `burning` is a
    degraded cause naming the table. The verdicts are the ones this
    process evaluated last (the collector is the evaluator); a process
    that never evaluates SLOs adds nothing."""
    from .info_collector import latest_slo

    verdicts = latest_slo()
    if not verdicts:
        return
    evidence["slo"] = verdicts
    for table in sorted(verdicts):
        v = verdicts[table]
        if v.get("verdict") != "burning":
            continue
        causes.append({
            "severity": DEGRADED,
            "cause": f"table {table} SLO burning "
                     f"(fast_burn={v.get('fast_burn')} "
                     f"slow_burn={v.get('slow_burn')} "
                     f"latency_burn={v.get('latency_burn')} "
                     f"errors_fast={v.get('errors_fast')})",
            "evidence": "slo"})


def _scrape_nodes(caller, state, causes, evidence, slow_last) -> None:
    """Per-node health scrapes: lane breakers, dispatch queue depth, and
    the cluster-wide slow-request rollup. A failed scrape is evidence
    (the node is listed under scrape_failed), never a crash."""
    from .info_collector import rollup_slow_requests

    alive = sorted(a for a, n in state.get("nodes", {}).items()
                   if n["alive"])
    scrapes, failed = {}, []
    qthr = _queue_threshold()
    for node in alive:
        try:
            snap = json.loads(caller.remote_command(
                node, "perf-counters-by-substr",
                ["lane.breaker_open", "dispatch_queue_depth"]))
        except (RpcError, OSError, ValueError):
            failed.append(node)
            continue
        scrapes[node] = snap
        for lane in ("compact", "read"):
            if snap.get(f"{lane}.lane.breaker_open"):
                causes.append({"severity": DEGRADED,
                               "cause": f"{lane} lane circuit breaker OPEN "
                                        f"on node {node} (device lane "
                                        "degraded to host)",
                               "evidence": "scrapes"})
        depth = snap.get("rpc.server.dispatch_queue_depth", 0)
        if depth >= qthr:
            causes.append({"severity": DEGRADED,
                           "cause": f"dispatch queue depth {depth:.0f} on "
                                    f"node {node} (>= {qthr}: serving "
                                    "saturated)",
                           "evidence": "scrapes"})
    evidence["scrapes"] = scrapes
    if failed:
        evidence["scrape_failed"] = failed

    def fetch(node):
        return caller.remote_command(node, "slow-requests", [str(slow_last)])

    evidence["slow_requests"] = rollup_slow_requests(fetch, alive,
                                                     last=slow_last)
