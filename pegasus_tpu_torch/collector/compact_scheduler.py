"""Cluster-wide compaction scheduler: debt-driven timing, placement and
admission control.

Port of pegasus_tpu/collector/compact_scheduler.py, whole. It folds the
signals the cluster exports (per-partition compaction debt, beacon-folded
into the meta's one-RPC ``RPC_CM_QUERY_CLUSTER_STATE`` snapshot; hot read
partitions; committed-vs-applied lag; ``compact.lane.*`` breaker state)
into one decision per partition:

- ``fold_decisions``: the pure, deterministic CLUSTER-level fold, per
  partition one of ``defer | normal | urgent`` with its reasons:

    * L0 debt at or over the hard ceiling -> **urgent**
      (``debt_ceiling``; the engine-local trigger fires there regardless,
      the scheduler merely agrees);
    * a confirmed hot READ partition -> **defer** (``hot_read``):
      compacting it evicts the resident runs its device reads serve from;
    * committed-vs-applied backlog over the threshold -> **urgent**
      (``apply_backlog``, plus ``slow_requests`` when the cluster
      slow-request rollup is non-empty);
    * L0 debt at or over the urgent threshold -> **urgent** (``l0_debt``).

- ``localize_decisions``: the per-NODE half, applied at delivery for each
  receiving node (every replica compacts independently): a receiver
  whose compact-lane breaker is open never gets an urgent token
  (``breaker_open``); at most ``max_urgent_per_node`` non-ceiling urgents
  per receiver, highest debt first (the rest demote, ``node_cap``); defer
  tokens land on the PRIMARY only (``defer_primary_only``).

- ``run_scheduler_tick``: one control-loop round over the live RPC
  surfaces: the snapshot and breaker scrapes in, decisions delivered to
  every alive node over the ``compact-sched-policy`` remote command.

- ``CompactScheduler``: the loop that runs a tick per interval.

Decisions are *leases*: each delivered token expires after ``ttl_s``
back to ``normal`` inside the engine, and the hard debt ceiling
overrides ``defer`` in the engine, so a wedged, crashed or partitioned
scheduler leaves the cluster with exactly the engine-local triggers (the
``compact.sched`` fail point pins that). The scheduler shapes compaction
timing; it never blocks it.

The port has no lane guard, so a port node exports no
``compact.lane.breaker_open``: the tick's breaker scrape reads False for
it. The collector role (runtime/service_app.py CollectorApp) hosts the
loop under ``PEGASUS_SCHED=1``; a caller may also run ticks in its own
process.
"""

import json
import os
import threading

from ..rpc.transport import RpcError
from ..runtime import lockrank
from ..runtime.fail_points import inject
from ..runtime.perf_counters import counters
from ..runtime.tasking import spawn_thread
from .cluster_doctor import ClusterCaller


def _knobs() -> dict:
    """Scheduler policy knobs, re-read per tick (cheap; lets tests and
    operators retune a live scheduler without a restart)."""
    return {
        # L0 files at/over which a partition promotes to urgent
        "urgent_l0": int(os.environ.get("PEGASUS_SCHED_URGENT_L0", "4")),
        # committed-applied decree gap that promotes to urgent
        "backlog_urgent": int(os.environ.get(
            "PEGASUS_SCHED_BACKLOG_URGENT", "64")),
        # urgent budget per node (0 = unbounded)
        "max_urgent_per_node": int(os.environ.get(
            "PEGASUS_SCHED_MAX_URGENT_PER_NODE", "2")),
        # per-node concurrent device-compaction cap delivered with the
        # decisions (0 = leave the node's gate alone)
        "max_device": int(os.environ.get(
            "PEGASUS_SCHED_MAX_DEVICE_COMPACT", "0")),
        # decision lease: engines revert to local triggers this many
        # seconds after the last delivery
        "ttl_s": float(os.environ.get("PEGASUS_SCHED_TTL_S", "30")),
        # compaction-offload placement: the rack's device-
        # owning compaction services; each tick scrapes their free merge
        # budget and the fold assigns (when, where) pairs against it
        "offload_services": [s.strip() for s in os.environ.get(
            "PEGASUS_OFFLOAD_SERVICES", "").split(",") if s.strip()],
        # feedback tuning: PEGASUS_SCHED_AUTOTUNE=1
        # replaces the static urgent thresholds with ones tuned from the
        # measured compact.stage.* durations (EWMA over the nodes'
        # metric-history rings)
        "autotune": os.environ.get("PEGASUS_SCHED_AUTOTUNE", "") == "1",
        "tune_alpha": float(os.environ.get("PEGASUS_SCHED_TUNE_ALPHA",
                                           "0.3")),
        "tune_slow_us": float(os.environ.get("PEGASUS_SCHED_TUNE_SLOW_US",
                                             "2000000")),
        "tune_fast_us": float(os.environ.get("PEGASUS_SCHED_TUNE_FAST_US",
                                             "250000")),
    }


# the stage series the feedback tuner folds: one whole-merge cost is
# (approximately) the sum of the per-stage p99s a node's metric-history
# ring sampled in the window
_STAGE_SERIES = tuple(f"compact.stage.{s}.duration_us.p99"
                      for s in ("pack", "h2d", "device", "gather",
                                "sst_write"))


def stage_cost_us(window: dict) -> float:
    """Worst observed whole-merge stage cost in one metrics-history
    window (``{"samples": [{"ts", "values": {...}}]}``): per sample the
    compact.stage.* duration p99s sum to ~one merge's wall cost; the max
    over the window is the recent worst. 0.0 = no compaction ran."""
    worst = 0.0
    for s in window.get("samples", ()):
        vals = s.get("values", {})
        worst = max(worst, sum(float(vals.get(k, 0.0))
                               for k in _STAGE_SERIES))
    return worst


def tune_knobs(ewma_us: float, knobs: dict) -> tuple:
    """Feedback-tune the fold's urgency thresholds from the measured
    merge cost (EWMA of stage_cost_us across ticks). Pure. Rationale:
    expensive merges (a slow device, big partitions) amortize their
    fixed cost over more debt — promote LATER (doubled thresholds);
    cheap merges should keep read amplification low — promote EARLIER
    (halved thresholds, floored). -> (tuned knobs, report dict)."""
    k = dict(knobs)
    if ewma_us >= k["tune_slow_us"]:
        mode = "slow_merges"
        k["urgent_l0"] = k["urgent_l0"] * 2
        k["backlog_urgent"] = k["backlog_urgent"] * 2
    elif 0.0 < ewma_us <= k["tune_fast_us"]:
        mode = "fast_merges"
        k["urgent_l0"] = max(2, k["urgent_l0"] // 2)
        k["backlog_urgent"] = max(8, k["backlog_urgent"] // 2)
    else:
        mode = "base"
    return k, {"ewma_us": round(ewma_us, 1), "mode": mode,
               "urgent_l0": k["urgent_l0"],
               "backlog_urgent": k["backlog_urgent"]}


def assign_placements(decisions: dict, places: dict,
                      weights: dict = None) -> dict:
    """The WHERE half of the fold: hand each service's free
    merge budget to the partitions that need compaction most. Pure and
    deterministic: non-defer partitions with debt, highest debt first,
    fill the service with the most remaining slots (address tie-break);
    everyone else keeps ``where == ""`` (compact locally). ``weights``
    ({gpid: replica count, default 1}) sizes each placement honestly:
    the token is delivered to EVERY replica of the partition and each
    compacts independently, so one placement can present up to
    replica-count concurrent merges at the service — it is charged
    min(weight, remaining) slots (never refused outright: the budget is
    advisory, the service's admission gate is the hard bound). Mutates
    and returns `decisions` (each entry gains "where")."""
    free = {a: max(0, int(n)) for a, n in (places or {}).items()}
    weights = weights or {}
    for d in decisions.values():
        d.setdefault("where", "")
    if not free:
        return decisions
    order = sorted(
        (g for g, d in decisions.items()
         if d["policy"] != "defer"
         and (d["l0_files"] > 0 or d["debt_bytes"] > 0)),
        key=lambda g: (decisions[g]["debt_bytes"],
                       decisions[g]["l0_files"], g),
        reverse=True)
    for g in order:
        addr = sorted(free, key=lambda a: (-free[a], a))[0]
        if free[addr] <= 0:
            break
        free[addr] -= min(max(1, int(weights.get(g, 1))), free[addr])
        decisions[g]["where"] = addr
        decisions[g]["reasons"] = list(decisions[g]["reasons"]) \
            + ["offload_budget"]
    return decisions


def fold_decisions(parts: dict, hot=(), slow_count: int = 0,
                   knobs: dict = None, places: dict = None,
                   weights: dict = None) -> dict:
    """The deterministic CLUSTER-level decision fold — what each
    partition needs, independent of which node serves it. Pure: no RPC,
    no clock. Per-NODE bounding (breaker-open skip, the urgent budget)
    happens at delivery in ``localize_decisions``, per receiving node:
    every replica compacts independently, so those rules must bind at
    each receiver, not at the primary the fold would otherwise key on.

    ``parts``: {gpid: {"node", "l0_files", "debt_bytes",
    "pending_installs", "apply_gap", "ceiling_files"}} — the primary's
    beacon-reported debt/lag state. ``hot``: gpids with a confirmed
    read-hot verdict. ``slow_count``: size of the cluster slow-request
    rollup. ``places``: {offload service addr: free merge slots} — when
    given, the fold also decides WHERE: the debtiest
    non-defer partitions are placed onto services with free device
    budget (``assign_placements``), so each decision is a (when, where)
    pair. -> {gpid: {"policy", "reasons", "node", "l0_files",
    "debt_bytes", "where"}}."""
    k = dict(_knobs(), **(knobs or {}))
    hot = set(hot)
    out = {}
    for gpid, st in sorted(parts.items()):
        l0 = int(st.get("l0_files", 0))
        ceiling = int(st.get("ceiling_files", 0)) or max(
            1, k["urgent_l0"] * 3)
        reasons = []
        if l0 >= ceiling:
            # the engine-local trigger fires here no matter what the
            # scheduler says; agreeing keeps the status surface truthful
            # and lets manual compactions jump the queue
            policy = "urgent"
            reasons.append("debt_ceiling")
        elif gpid in hot:
            policy = "defer"
            reasons.append("hot_read")
        else:
            policy = "normal"
            if int(st.get("apply_gap", 0)) >= k["backlog_urgent"]:
                policy = "urgent"
                reasons.append("apply_backlog")
                if slow_count > 0:
                    reasons.append("slow_requests")
            if l0 >= k["urgent_l0"]:
                policy = "urgent"
                reasons.append("l0_debt")
        out[gpid] = {"policy": policy, "reasons": reasons,
                     "node": st.get("node", ""), "l0_files": l0,
                     "debt_bytes": int(st.get("debt_bytes", 0))}
    return assign_placements(out, places, weights=weights)


def localize_decisions(decisions: dict, hosts: dict, node: str,
                       breaker_open: bool = False, cap: int = 0) -> dict:
    """Per-receiving-node half of the decision pipeline: the fold says
    what each partition needs; this bounds what ONE node is asked to do.
    Urgent tokens demote to normal (reason appended) for a breaker-open
    receiver (never promote onto a degraded device lane) and past the
    receiver's urgent budget of `cap` non-ceiling urgents (highest debt
    first, deterministic gpid tie-break); ceiling urgents pass through
    untouched (the engine-local trigger fires there regardless). A
    healthy receiver with free budget keeps every promotion — the
    demotions are per node, never global. DEFER tokens land on the
    PRIMARY only (the fold's `node`): the read-residency pin that
    justifies holding compaction lives on the primary's engine, so a
    secondary deferring would ride its debt to the ceiling's inline
    apply-path stall for zero read benefit (`defer_primary_only`).
    -> {gpid: {"policy", "reasons"}} for the partitions `node` hosts."""
    order = sorted((g for g in decisions if node in hosts.get(g, ())),
                   key=lambda g: (decisions[g]["debt_bytes"],
                                  decisions[g]["l0_files"], g),
                   reverse=True)
    mine = {}
    urgent_sent = 0
    for g in order:
        d = decisions[g]
        policy, reasons = d["policy"], list(d["reasons"])
        if policy == "urgent" and "debt_ceiling" not in reasons:
            if breaker_open:
                policy = "normal"
                reasons.append("breaker_open")
            elif cap > 0 and urgent_sent >= cap:
                policy = "normal"
                reasons.append("node_cap")
            else:
                urgent_sent += 1
        elif policy == "defer" and d.get("node") and node != d["node"]:
            policy = "normal"
            reasons.append("defer_primary_only")
        # the WHERE half passes through untouched: every replica of the
        # partition ships to the same service (content-addressed staging
        # dedups the runs they share)
        mine[g] = {"policy": policy, "reasons": reasons,
                   "where": d.get("where", ""),
                   # the job-trace id rides the lease: every
                   # receiver gets the SAME id, so whichever replica's
                   # trigger fires first continues the decision's timeline
                   "job": d.get("job", "")}
    return mine


def run_scheduler_tick(meta_addrs, pool=None, hot_gpids=None,
                       slow_count: int = 0, caller: ClusterCaller = None,
                       deliver: bool = True, knobs: dict = None,
                       tune_state: dict = None) -> dict:
    """One scheduler round over the live cluster. -> report dict:
    ``{"decisions": {gpid: {...}}, "delivered": {node: {gpid: policy}},
    "nodes": N, "services": {addr: {...}}, "errors": [...]}`` (plus
    ``"autotune"`` when the feedback tuner is armed).

    Folds the meta's cluster-state snapshot (partition configs + the
    beacon-carried per-replica ``compact`` debt and committed/applied
    decrees) with per-node compact-lane breaker scrapes and — when
    ``PEGASUS_OFFLOAD_SERVICES`` names compaction services — their free
    merge budget, then delivers each alive node the (when, where)
    decisions for every partition it hosts (primary AND secondaries —
    each replica compacts independently) over ``compact-sched-policy``.
    ``tune_state`` (a dict the caller keeps across ticks, holding
    ``ewma_us``) arms the feedback tuner when the autotune knob is on.
    Every failure is an entry in ``errors``, never an exception: a
    half-delivered round is strictly better than none, and undelivered
    tokens simply expire."""
    inject("compact.sched")  # chaos seam: a wedged/crashed tick must
    # never block writes or compactions (engine-local triggers + token
    # expiry are the fallback)
    counters.rate("sched.tick_count").increment()
    own = caller is None
    caller = caller or ClusterCaller(meta_addrs, pool=pool)
    report = {"decisions": {}, "delivered": {}, "nodes": 0,
              "services": {}, "errors": []}
    k = dict(_knobs(), **(knobs or {}))
    try:
        state = caller.meta_state()
        if state is None:
            report["errors"].append("no meta reachable")
            return report
        nodes = state.get("nodes", {})
        alive = sorted(a for a, n in nodes.items() if n.get("alive"))
        report["nodes"] = len(alive)
        breakers = {}
        for node in alive:
            try:
                snap = json.loads(caller.remote_command(
                    node, "perf-counters-by-substr",
                    ["compact.lane.breaker_open"]))
                breakers[node] = bool(snap.get("compact.lane.breaker_open"))
            except (RpcError, OSError, ValueError):
                # unknown lane state: treat as healthy — a scrape hiccup
                # must not strip a node of promotions it may need
                breakers[node] = False
        # offload services: free device budget per service; a
        # dead/unreachable service simply gets no placements this round
        places = {}
        for svc in k["offload_services"]:
            try:
                st = json.loads(caller.remote_command(svc, "offload-status",
                                                      []))
                places[svc] = int(st.get("free_slots", 0))
                report["services"][svc] = {
                    "free_slots": places[svc],
                    "running_merges": st.get("running_merges", 0),
                    "jobs": st.get("jobs", 0)}
            except (RpcError, OSError, ValueError) as e:
                report["services"][svc] = {"error": str(e)}
                report["errors"].append(f"offload {svc}: {e}")
        if k["autotune"] and tune_state is not None:
            # feedback tuning: fold the nodes'
            # recorded compact.stage.* durations into an EWMA of the
            # whole-merge cost and rescale the urgency thresholds
            obs = 0.0
            for node in alive:
                try:
                    hist = json.loads(caller.remote_command(
                        node, "metrics-history",
                        ["60", "compact.stage."]))
                    for window in hist.values():  # pid-keyed per process
                        obs = max(obs, stage_cost_us(window))
                except (RpcError, OSError, ValueError):
                    continue  # a scrape hiccup must not zero the EWMA
            if obs > 0.0:
                prev = tune_state.get("ewma_us")
                alpha = k["tune_alpha"]
                tune_state["ewma_us"] = obs if prev is None else \
                    alpha * obs + (1.0 - alpha) * prev
            k, tuned = tune_knobs(tune_state.get("ewma_us", 0.0), k)
            report["autotune"] = tuned
            counters.number("sched.autotune.urgent_l0").set(k["urgent_l0"])
        parts, hosts = {}, {}
        rs = state.get("replica_states", {})
        for app in state.get("apps", {}).values():
            for pc in app.get("partitions", []):
                gpid = f"{app['app_id']}.{pc['pidx']}"
                members = [m for m in [pc.get("primary")]
                           + pc.get("secondaries", []) if m and m in alive]
                primary = pc.get("primary")
                st = rs.get(primary, {}).get(gpid) if primary else None
                if not members or not st:
                    continue  # unserved / not yet beaconed: nothing to say
                debt = st.get("compact") or {}
                parts[gpid] = {
                    "node": primary,
                    "l0_files": debt.get("l0_files", 0),
                    "debt_bytes": debt.get("debt_bytes", 0),
                    "pending_installs": debt.get("pending_installs", 0),
                    "ceiling_files": debt.get("ceiling_files", 0),
                    "apply_gap": max(0, st.get("committed", 0)
                                     - st.get("applied", 0)),
                }
                hosts[gpid] = members
        decisions = fold_decisions(parts, hot=hot_gpids or (),
                                   slow_count=slow_count, knobs=k,
                                   places=places,
                                   # a placement reaches every replica,
                                   # each compacting independently —
                                   # budget it by member count
                                   weights={g: len(m)
                                            for g, m in hosts.items()})
        report["decisions"] = decisions
        counters.number("sched.decisions.defer").set(
            sum(1 for d in decisions.values() if d["policy"] == "defer"))
        counters.number("sched.decisions.urgent").set(
            sum(1 for d in decisions.values() if d["policy"] == "urgent"))
        if not deliver:
            return report
        # causal job tracing: one id per (gpid, tick) decision,
        # minted BEFORE the per-node loop so a partition delivered to
        # several replicas shares one id. The scheduler only DECIDES —
        # it never finishes these jobs (the engine whose trigger adopts
        # the token does); scheduler-local records for decisions that
        # never fire age out of the tracer's bounded active set.
        from ..runtime.job_trace import JOB_TRACER

        for gpid, d in decisions.items():
            d["job"] = JOB_TRACER.begin("sched", gpid=gpid)
            JOB_TRACER.note("sched.decide", job_id=d["job"], gpid=gpid,
                            policy=d["policy"],
                            reasons=",".join(d["reasons"]),
                            where=d.get("where", ""))
        for node in alive:
            mine = localize_decisions(decisions, hosts, node,
                                      breaker_open=breakers.get(node, False),
                                      cap=k["max_urgent_per_node"])
            if not mine:
                continue
            body = {"ttl_s": k["ttl_s"], "decisions": mine}
            if k["max_device"] > 0:
                body["max_device"] = k["max_device"]
            try:
                out = caller.remote_command(node, "compact-sched-policy",
                                            [json.dumps(body)])
                report["delivered"][node] = json.loads(out)
                for g, dec in mine.items():
                    if dec.get("job"):
                        JOB_TRACER.note("sched.deliver", job_id=dec["job"],
                                        gpid=g, node=node)
            except (RpcError, OSError, ValueError) as e:
                counters.rate("sched.deliver_errors").increment()
                report["errors"].append(f"{node}: {e}")
    finally:
        if own:
            caller.close()
    return report


class CompactScheduler:
    """The control loop: one ``run_scheduler_tick`` per interval, the hot
    read partitions (`hot_fn`) and the slow-request rollup's size
    (`slow_fn`) wired into the fold; ``status()`` is the last round's
    report. The collector role constructs it under
    ``PEGASUS_SCHED=1``."""

    def __init__(self, meta_addrs, pool=None, interval_seconds: float = None,
                 hot_fn=None, slow_fn=None):
        self.meta_addrs = list(meta_addrs)
        self.pool = pool
        self.interval = (float(os.environ.get("PEGASUS_SCHED_INTERVAL_S",
                                              "5"))
                         if interval_seconds is None else interval_seconds)
        self.hot_fn = hot_fn or (lambda: ())
        self.slow_fn = slow_fn or (lambda: 0)
        self._stop = threading.Event()
        # leaf lock over the published report (the loop writes, the
        # status command reads on an RPC thread)
        self._lock = lockrank.named_lock("sched.state")
        self._last = {}  #: guarded_by self._lock
        # feedback-tuner state (EWMA of measured merge cost), carried
        # across ticks; only the loop thread touches it
        self._tune_state = {}
        self._thread = spawn_thread(self._loop, daemon=True, start=False,
                                    name="compact-sched")

    def start(self) -> "CompactScheduler":
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the loop and JOIN it (bounded): the caller closes the
        shared pool next, and an in-flight tick racing that close would
        spray false tick/deliver errors through every clean shutdown."""
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # a failed tick must never kill the
                # loop — the next interval retries, and engine tokens
                # expiring is the designed degradation
                counters.rate("sched.tick_errors").increment()
                print(f"[compact-sched] tick failed: {e!r}", flush=True)

    def tick(self) -> dict:
        report = run_scheduler_tick(self.meta_addrs, pool=self.pool,
                                    hot_gpids=self.hot_fn(),
                                    slow_count=self.slow_fn(),
                                    tune_state=self._tune_state)
        with self._lock:
            self._last = report
        return report

    def status(self) -> dict:
        """The last round's report (decisions with reasons, delivery map,
        errors) — JSON-ready."""
        with self._lock:
            return dict(self._last)
