"""Info collector: cluster-wide stat scraping, hotspot analysis, the
closed hotkey loop, the cluster rollups and the SLO evaluator.

Port of pegasus_tpu/collector/info_collector.py. On a timer the collector
lists apps from the meta, scrapes every primary's `app.<id>.` perf
counters over the `perf-counters-by-prefix` remote command, republishes
per-app row stats as `collector.app.<name>.*`, and runs the sigma
analysis over per-partition QPS: a partition more than 3 standard
deviations above the others is flagged, and one flagged
`hotkey_rounds` rounds in a row gets detect_hotkey started, queried and
stopped on its primary. A read verdict pins the partition's runs on the
card (`set-read-residency on`); calming releases it. Each round also
folds the cluster's compaction counters, replication lag, slow
requests and table ledgers, then evaluates each table's SLO burn rate.
"""

import configparser
import json
import os
import threading
import time

from ..meta import messages as mm
from ..meta.meta_server import RPC_CM_LIST_APPS, RPC_CM_QUERY_CONFIG
from ..rpc import codec
from ..rpc.transport import ConnectionPool, RpcError
from ..runtime import events, lockrank
from ..runtime.perf_counters import counters
from ..runtime.remote_command import RemoteCommandRequest, RemoteCommandResponse
from ..runtime.tasking import spawn_thread

# the most recent per-table SLO verdicts computed IN THIS PROCESS (the
# collector is the evaluator; every other node's slo-status answers {});
# evaluate_slos rebinds it wholesale, so lock-free readers (the slo-status
# remote command, the doctor's _check_slo) always see a stable dict
_SLO_LATEST = {}


def latest_slo() -> dict:
    """Per-table SLO verdicts from the last evaluate_slos() round in
    this process: {table: {"verdict": ok|warn|burning, ...evidence}}."""
    return _SLO_LATEST


def reset_slo() -> None:
    """Test hook: forget the verdicts."""
    global _SLO_LATEST
    _SLO_LATEST = {}


def _slo_config(tables) -> dict:
    """Resolve each table's SLO targets: the optional PEGASUS_SLO_CONFIG
    ini file's [slo] section (keys ``table.<name>.availability`` /
    ``table.<name>.p99_us``) over the PEGASUS_SLO_AVAIL /
    PEGASUS_SLO_P99_US env defaults (p99 0 = latency SLO disabled)."""
    avail = float(os.environ.get("PEGASUS_SLO_AVAIL", "0.999"))
    p99 = float(os.environ.get("PEGASUS_SLO_P99_US", "0"))
    per = {t: {"availability": avail, "p99_us": p99} for t in tables}
    path = os.environ.get("PEGASUS_SLO_CONFIG", "")
    if path:
        cp = configparser.ConfigParser()
        try:
            cp.read(path)
        except configparser.Error:
            return per
        if cp.has_section("slo"):
            for key, val in cp.items("slo"):
                parts = key.split(".")
                if len(parts) < 3 or parts[0] != "table":
                    continue
                name, field = ".".join(parts[1:-1]), parts[-1]
                if name in per and field in ("availability", "p99_us"):
                    try:
                        per[name][field] = float(val)
                    except ValueError:
                        pass
    return per


def rollup_slow_requests(fetch, nodes, last: int = 20) -> list:
    """Cluster-wide slow-request rollup: merge every node's
    `slow-requests` output (a JSON list of traces with their spans) into
    ONE worst-first top-`last`, each trace tagged with the node it came
    from. `fetch(node)` is the transport (a remote command); it may
    return the raw JSON text or a parsed list. A node that does not
    answer is skipped: a rollup degrades, it never raises."""
    merged = []
    for node in nodes:
        try:
            raw = fetch(node)
            traces = json.loads(raw) if isinstance(raw, str) else raw
        except (RpcError, OSError, ValueError):
            continue
        if not isinstance(traces, list):
            continue
        for t in traces:
            if isinstance(t, dict):
                merged.append(dict(t, node=node))
    merged.sort(key=lambda t: t.get("duration_us", 0), reverse=True)
    return merged[:last]


class InfoCollector:
    def __init__(self, meta_addrs, interval_seconds: float = 10.0,
                 hotkey_rounds: int = 3, hotkey_query_limit: int = 8):
        self.meta_addrs = list(meta_addrs)
        self.interval = interval_seconds
        self.pool = ConnectionPool()
        self._stop = threading.Event()
        self._thread = spawn_thread(self._loop, daemon=True, start=False)
        self.hotspots = {}   # app_name -> [pidx...] flagged last round
        self.app_stats = {}  # app_name -> aggregated dict
        self.compact_stats = {}  # cluster-summed compact.*/engine.* counters
        self._cluster_published = set()  # gauge names set last round
        # closed hotspot loop: a partition flagged hotkey_rounds CONSECUTIVE
        # rounds gets an automatic detect_hotkey start/query/stop sequence
        # against its primary; the verdict republishes as
        # collector.app.<name>.hotkey.* counters + self.hotkey_results
        self.hotkey_rounds = hotkey_rounds
        self.hotkey_query_limit = hotkey_query_limit
        # hotkey-loop bookkeeping below is driven from the collector
        # timer thread but also reachable through remote commands /
        # collector-info reads — one leaf lock covers it
        self._lock = lockrank.named_lock("collector.hotkey")
        # (app_name, pidx) -> consecutive rounds
        self._hot_streak = {}      #: guarded_by self._lock
        # (app_name, pidx) -> in-flight state
        self._detections = {}      #: guarded_by self._lock
        # app_name -> {pidx: {"kind","key","ts"}}. WRITES hold the lock;
        # published copy-on-write (rebound wholesale, never mutated in
        # place) so lock-free readers (collector-info on an RPC thread)
        # always iterate a stable snapshot and never block behind a
        # detection round's RPCs
        self.hotkey_results = {}   #: guarded_by self._lock
        # read-residency the hotkey loop switched on: (app_name, pidx) ->
        # {"node", "gpid"} — turned off again when the partition calms,
        # closing the loop that decides which partitions' SSTs stay
        # resident on the card for the device read path
        self.read_residency = {}  #: guarded_by self._lock
        # cluster-wide observability rollups: worst-first top-N
        # slow requests merged across nodes, and the replication-lag
        # worst-offender summary the doctor reads
        self.cluster_slow_requests = []
        self.lag_stats = {}
        # tenant plane: cluster-folded per-table ledgers, the
        # top-k capacity attribution, and the burn-rate bookkeeping.
        # table_stats/table_top are rebound wholesale (copy-on-write like
        # hotkey_results) so the /tables route and shell read lock-free.
        self.table_stats = {}
        self.table_top = {}
        self._table_published = set()   # collector.table.* gauges set
        self._slo_samples = {}   # table -> [(ts, requests, errors), ...]
        self._slo_burning = set()  # tables burning last round (edge det.)
        # scrape robustness: a node dying
        # mid-collect_once must COUNT, not silently vanish from the
        # round's aggregates — the counter + event make a blind round
        # distinguishable from a quiet one
        self._c_scrape_err = counters.rate("collector.scrape.error_count")

    def _scrape_failed(self, node: str, what: str, err) -> None:
        self._c_scrape_err.increment()
        events.emit("collector.scrape_failed", severity="warn", node=node,
                    what=what, error=repr(err)[:200])

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.pool.close()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.collect_once()
            except (RpcError, OSError):
                continue

    # ------------------------------------------------------------- scrape

    def _call(self, addr: str, code: str, req):
        host, _, port = addr.rpartition(":")
        conn = self.pool.get((host, int(port)))
        _, body = conn.call(code, codec.encode(req), timeout=5.0)
        return body

    def _meta_call(self, code, req, resp_cls):
        last = None
        for m in self.meta_addrs:
            try:
                return codec.decode(resp_cls, self._call(m, code, req))
            except (RpcError, OSError) as e:
                last = e
        raise last

    def remote_command(self, addr: str, command: str, args) -> str:
        """Raw remote-command invocation against one node."""
        req = RemoteCommandRequest(command, list(args))
        body = self._call(addr, "RPC_CLI_CLI_CALL", req)
        return codec.decode(RemoteCommandResponse, body).output

    def scrape_node(self, addr: str, prefix: str = "") -> dict:
        return json.loads(self.remote_command(
            addr, "perf-counters-by-prefix", [prefix]))

    def collect_compact_stats(self, nodes) -> dict:
        """Sum every node's compaction-pipeline telemetry (compact.* stage
        spans + watchdog, engine.* flush/compaction/sst-write counters —
        runtime/tracing.py naming) and republish the cluster totals as
        `collector.cluster.*`, so one scrape of the collector answers
        'where is compaction time going cluster-wide'."""
        agg = {}
        for node in sorted(nodes):
            for prefix in ("compact.", "engine."):
                try:
                    snap = self.scrape_node(node, prefix=prefix)
                except (RpcError, OSError, ValueError) as e:
                    self._scrape_failed(node, f"perf-counters:{prefix}", e)
                    continue
                for name, v in snap.items():
                    if isinstance(v, dict):
                        # percentile counters export {p50..p999}: flatten
                        # to <name>.<q>; MAX across nodes — a cluster-wide
                        # latency quantile is "the worst node", never a sum
                        for q, qv in v.items():
                            key = f"{name}.{q}"
                            agg[key] = max(agg.get(key, 0.0), float(qv))
                    else:
                        agg[name] = agg.get(name, 0.0) + float(v)
        for name, v in agg.items():
            counters.number(f"collector.cluster.{name}").set(v)
        # a counter that stops being reported (node restarted, scrape
        # failing) must not freeze at its last sum — a stale
        # collector.cluster.compact.watchdog.wedged=1 would page forever
        for name in self._cluster_published - set(agg):
            counters.number(f"collector.cluster.{name}").set(0.0)
        self._cluster_published = set(agg)
        self.compact_stats = agg
        return agg

    def collect_lag_stats(self, nodes) -> dict:
        """Replication-lag plane, aggregated: scrape every
        node's per-partition `replica.*` decree gauges + `dup.lag.*`
        ship-lag gauges and republish cluster-level WORST-OFFENDER series
        (a lag quantile summed across nodes is meaningless — the signal
        is the single worst replica, named):

          collector.cluster.lag.secondary_gap_max   worst prepare lag
          collector.cluster.lag.apply_gap_max       worst committed-applied
          collector.cluster.lag.backlog_max         worst staged backlog
          collector.cluster.dup.lag_max             worst duplicator lag

        self.lag_stats keeps {series: {"value", "node", "name"}} so the
        doctor (and collector-info) can point at the offender."""
        worst = {"secondary_gap_max": (0.0, "", ""),
                 "apply_gap_max": (0.0, "", ""),
                 "backlog_max": (0.0, "", ""),
                 "dup_lag_max": (0.0, "", "")}

        def offer(series, value, node, name):
            if value > worst[series][0]:
                worst[series] = (float(value), node, name)

        for node in sorted(nodes):
            try:
                # ONE scrape per node: perf-counters-by-prefix matches
                # any of its arguments
                snap = json.loads(self.remote_command(
                    node, "perf-counters-by-prefix",
                    ["replica.", "dup.lag."]))
            except (RpcError, OSError, ValueError) as e:
                self._scrape_failed(node, "perf-counters:replica", e)
                continue
            committed, applied = {}, {}
            for name, v in snap.items():
                if isinstance(v, dict):
                    continue
                if name.startswith("dup.lag."):
                    offer("dup_lag_max", v, node, name)
                elif name.endswith(".secondary_gap_max"):
                    offer("secondary_gap_max", v, node, name)
                elif name.endswith(".backlog"):
                    offer("backlog_max", v, node, name)
                elif name.endswith(".committed_decree"):
                    committed[name[:-len(".committed_decree")]] = v
                elif name.endswith(".applied_decree"):
                    applied[name[:-len(".applied_decree")]] = v
            for part, c in committed.items():
                offer("apply_gap_max", c - applied.get(part, c), node,
                      part)
        out = {}
        for series, (value, node, name) in worst.items():
            if series == "dup_lag_max":
                counters.number("collector.cluster.dup.lag_max").set(value)
            else:
                counters.number("collector.cluster.lag." + series).set(value)
            out[series] = {"value": value, "node": node, "name": name}
        self.lag_stats = out
        return out

    def collect_slow_requests(self, nodes, last: int = 20) -> list:
        """Cluster-wide top-N slow requests (the node-local ledger merged
        worst-first; see rollup_slow_requests). Republishes the count as
        collector.cluster.slow_request_count."""
        def fetch(n):
            try:
                # parse here (rollup accepts the parsed list): a
                # truncated/garbage reply (node died mid-answer) must
                # COUNT like a refused connection does
                return json.loads(
                    self.remote_command(n, "slow-requests", [str(last)]))
            except (RpcError, OSError, ValueError) as e:
                self._scrape_failed(n, "slow-requests", e)
                raise  # rollup_slow_requests skips the node either way

        self.cluster_slow_requests = rollup_slow_requests(
            fetch, sorted(nodes), last=last)
        counters.number("collector.cluster.slow_request_count").set(
            len(self.cluster_slow_requests))
        return self.cluster_slow_requests

    def collect_table_stats(self, nodes) -> dict:
        """Tenant fold: pull every node's `table-stats`
        fragments (pid-keyed per process — a grouped node's router merge
        already concatenated its workers'), fold them cluster-wide
        (totals sum, latency percentiles MAX) and republish as
        `collector.table.<name>.*` gauges so the series land in metric
        history. Also computes the top-k capacity attribution
        (PEGASUS_TABLE_TOPK, default 5) by ops / bytes / device-seconds
        / device bytes."""
        from ..runtime.table_stats import fold_snapshots, top_k

        frags = []
        for node in sorted(nodes):
            try:
                reply = json.loads(
                    self.remote_command(node, "table-stats", []))
            except (RpcError, OSError, ValueError) as e:
                self._scrape_failed(node, "table-stats", e)
                continue
            if isinstance(reply, dict):
                frags.extend(v for v in reply.values() if isinstance(v, dict))
        folded = fold_snapshots(frags)
        published = set()
        for table, m in folded.items():
            ops = (m.get("read_qps", 0) + m.get("write_qps", 0)
                   + m.get("scan_qps", 0))
            # explicit cumulative series for the slow burn window: the
            # fold ships ledger TOTALS, so first/last deltas over a
            # metric-history window are true request/error counts
            m = dict(m, ops_total=ops,
                     errors_total=m.get("errors", 0))
            for k, v in m.items():
                if isinstance(v, dict):
                    for q, qv in v.items():
                        counters.number(
                            f"collector.table.{table}.{k}.{q}").set(
                                float(qv))
                        published.add(f"collector.table.{table}.{k}.{q}")
                else:
                    counters.number(
                        f"collector.table.{table}.{k}").set(float(v))
                    published.add(f"collector.table.{table}.{k}")
            folded[table] = m
        # stale-clear (same rule as collect_compact_stats): a dropped
        # table's gauges must not freeze at their last totals
        for name in self._table_published - published:
            counters.number(name).set(0.0)
        self._table_published = published
        self.table_top = top_k(
            folded, int(os.environ.get("PEGASUS_TABLE_TOPK", "5")))
        self.table_stats = folded
        return folded

    def evaluate_slos(self) -> dict:
        """Declarative per-table SLOs with multi-window burn rate.
        For each table the error-budget burn is computed on
        a FAST window (~PEGASUS_SLO_FAST_S, from the live fold samples
        this collector keeps round to round) and a SLOW window
        (~PEGASUS_SLO_SLOW_S, first/last deltas of the republished
        cumulative series in metric history; falls back to the fast
        burn until the window holds two samples — cold start). Verdict:
        burning when BOTH windows burn >= PEGASUS_SLO_BURN_CRIT (or the
        p99 latency bound burns past it), warn at >= PEGASUS_SLO_BURN_WARN,
        ok otherwise. Each verdict carries named evidence; entering
        `burning` emits an `slo.burning` event and the slo.<table>.*
        gauges track the numbers."""
        global _SLO_LATEST

        now = time.time()
        fast_s = float(os.environ.get("PEGASUS_SLO_FAST_S", "300"))
        slow_s = float(os.environ.get("PEGASUS_SLO_SLOW_S", "3600"))
        warn = float(os.environ.get("PEGASUS_SLO_BURN_WARN", "1.0"))
        crit = float(os.environ.get("PEGASUS_SLO_BURN_CRIT", "2.0"))
        folded = self.table_stats
        targets = _slo_config(folded)
        verdicts = {}
        for table, m in folded.items():
            requests = m.get("ops_total", 0) + m.get("errors_total", 0)
            errors = m.get("errors_total", 0)
            hist = self._slo_samples.setdefault(table, [])
            hist.append((now, requests, errors))
            while len(hist) > 2 and hist[1][0] <= now - fast_s:
                hist.pop(0)
            budget = max(1e-9, 1.0 - targets[table]["availability"])
            # baseline = the oldest retained sample (the trim above keeps
            # at most one sample older than the window start, so this is
            # "the window's entry point", never the sample just appended)
            r0 = hist[0]
            dreq = max(0, requests - r0[1])
            derr = max(0, errors - r0[2])
            fast_burn = (derr / max(1, dreq)) / budget
            slow_burn = self._slow_burn(table, slow_s, budget, fast_burn)
            p99_bound = targets[table]["p99_us"]
            p99 = max(m.get("read_latency_us", {}).get("p99", 0),
                      m.get("write_latency_us", {}).get("p99", 0))
            lat_burn = (p99 / p99_bound) if p99_bound > 0 else 0.0
            if (fast_burn >= crit and slow_burn >= crit) or lat_burn >= crit:
                verdict = "burning"
            elif (fast_burn >= warn and slow_burn >= warn) \
                    or lat_burn >= warn:
                verdict = "warn"
            else:
                verdict = "ok"
            verdicts[table] = {
                "verdict": verdict,
                "fast_burn": round(fast_burn, 3),
                "slow_burn": round(slow_burn, 3),
                "latency_burn": round(lat_burn, 3),
                "requests_fast": dreq, "errors_fast": derr,
                "availability_target": targets[table]["availability"],
                "p99_us": p99, "p99_bound_us": p99_bound,
            }
            counters.number(f"slo.{table}.fast_burn").set(fast_burn)
            counters.number(f"slo.{table}.slow_burn").set(slow_burn)
            counters.number(f"slo.{table}.verdict").set(
                {"ok": 0, "warn": 1, "burning": 2}[verdict])
            if verdict == "burning" and table not in self._slo_burning:
                events.emit("slo.burning", severity="warn", table=table,
                            fast_burn=round(fast_burn, 3),
                            slow_burn=round(slow_burn, 3),
                            latency_burn=round(lat_burn, 3))
        self._slo_burning = {t for t, v in verdicts.items()
                             if v["verdict"] == "burning"}
        for table in set(self._slo_samples) - set(folded):
            del self._slo_samples[table]
        _SLO_LATEST = verdicts
        return verdicts

    def _slow_burn(self, table: str, slow_s: float, budget: float,
                   fallback: float) -> float:
        """Slow-window burn from metric history first/last deltas of the
        republished cumulative series; `fallback` (the fast burn) until
        the window holds two samples of the table's series."""
        from ..runtime.metric_history import HISTORY

        pfx = f"collector.table.{table}."
        win = HISTORY.window(seconds=slow_s, prefix=pfx)
        samples = [s for s in win.get("samples", [])
                   if pfx + "ops_total" in s.get("values", {})]
        if len(samples) < 2:
            return fallback
        first, last = samples[0]["values"], samples[-1]["values"]
        dreq = max(0, (last.get(pfx + "ops_total", 0)
                       + last.get(pfx + "errors_total", 0))
                   - (first.get(pfx + "ops_total", 0)
                      + first.get(pfx + "errors_total", 0)))
        derr = max(0, last.get(pfx + "errors_total", 0)
                   - first.get(pfx + "errors_total", 0))
        return (derr / max(1, dreq)) / budget

    def collect_once(self) -> dict:
        apps = self._meta_call(RPC_CM_LIST_APPS, mm.ListAppsRequest(),
                               mm.ListAppsResponse).apps
        summary = {}
        all_nodes = set()
        for app in apps:
            cfg = self._meta_call(RPC_CM_QUERY_CONFIG,
                                  mm.QueryConfigRequest(app.app_name),
                                  mm.QueryConfigResponse)
            per_partition_qps = {}
            read_qps, write_qps = {}, {}  # pidx splits for the hotkey kind
            agg = {"get_qps": 0.0, "put_qps": 0.0, "multi_get_qps": 0.0,
                   "scan_qps": 0.0, "recent_read_cu": 0.0,
                   "recent_write_cu": 0.0,
                   # throttling activity (reference row_data
                   # recent_*_throttling_*_count, info_collector.h:73-81)
                   "recent_write_throttling_delay_count": 0.0,
                   "recent_write_throttling_reject_count": 0.0}
            primaries = {pc.pidx: pc.primary for pc in cfg.partitions
                         if pc.primary}
            nodes = set(primaries.values())
            all_nodes |= nodes
            for node in nodes:
                try:
                    snap = self.scrape_node(node, prefix=f"app.{app.app_id}.")
                except (RpcError, OSError, ValueError) as e:
                    self._scrape_failed(node, f"perf-counters:app.{app.app_id}", e)
                    continue
                for name, v in snap.items():
                    if isinstance(v, dict):  # percentile counters: not qps
                        continue
                    # app.<id>.<pidx>.<counter>
                    parts = name.split(".")
                    if len(parts) < 4:
                        continue
                    pidx, cname = int(parts[2]), ".".join(parts[3:])
                    if cname in agg:
                        agg[cname] += v
                    if cname in ("get_qps", "put_qps", "multi_get_qps"):
                        per_partition_qps[pidx] = per_partition_qps.get(pidx, 0.0) + v
                        split = write_qps if cname == "put_qps" else read_qps
                        split[pidx] = split.get(pidx, 0.0) + v
            for cname, v in agg.items():
                counters.number(f"collector.app.{app.app_name}.{cname}").set(v)
            flagged = hotspot_partitions(per_partition_qps)
            self.hotspots[app.app_name] = flagged
            with self._lock:
                self.drive_hotkey_loop(app.app_name, app.app_id, flagged,
                                       primaries, read_qps, write_qps)
            summary[app.app_name] = agg
        self.collect_compact_stats(all_nodes)
        self.collect_lag_stats(all_nodes)
        self.collect_slow_requests(all_nodes)
        self.collect_table_stats(all_nodes)
        self.evaluate_slos()
        self.app_stats = summary
        return summary

    # ------------------------------------------------- closed hotspot loop

    #: requires self._lock
    def drive_hotkey_loop(self, app_name: str, app_id: int, flagged: list,
                          primaries: dict, read_qps: dict = None,
                          write_qps: dict = None) -> None:
        """The closed hotspot loop: a partition flagged
        `hotkey_rounds` consecutive rounds gets detect_hotkey started on
        its primary (read or write kind by whichever QPS dominates), every
        later round queries it, and a FINISHED verdict is republished as
        collector.app.<name>.hotkey.* counters + self.hotkey_results
        before the detection is stopped. Scrape failures skip a round, the
        detection survives."""
        read_qps, write_qps = read_qps or {}, write_qps or {}
        flagged_set = set(flagged)
        # streak bookkeeping: consecutive rounds flagged, reset when calm
        for pidx in flagged_set:
            self._hot_streak[(app_name, pidx)] = \
                self._hot_streak.get((app_name, pidx), 0) + 1
        for key in [k for k in self._hot_streak
                    if k[0] == app_name and k[1] not in flagged_set]:
            del self._hot_streak[key]
        # a published verdict gauge must clear once the partition calms
        # (the streak entry is gone by then — key off the verdicts, or a
        # fixed hot key would page as hot forever); calming also releases
        # the read residency the verdict switched on
        for pidx in self.hotkey_results.get(app_name, {}):
            if pidx not in flagged_set and (app_name, pidx) not in self._detections:
                counters.number(
                    f"collector.app.{app_name}.hotkey.{pidx}.hot").set(0)
                self._set_read_residency(app_name, pidx, on=False)
        # start a detection once the streak proves the hotspot persistent
        for pidx in sorted(flagged_set):
            key = (app_name, pidx)
            if (self._hot_streak.get(key, 0) < self.hotkey_rounds
                    or key in self._detections or pidx not in primaries):
                continue
            kind = ("write" if write_qps.get(pidx, 0.0)
                    > read_qps.get(pidx, 0.0) else "read")
            gpid = f"{app_id}.{pidx}"
            try:
                out = self.remote_command(primaries[pidx], "detect_hotkey",
                                          [gpid, kind, "start"])
            except (RpcError, OSError):
                continue
            if "started" in out:
                self._detections[key] = {"node": primaries[pidx],
                                         "gpid": gpid, "kind": kind,
                                         "queries": 0}
                counters.rate(
                    f"collector.app.{app_name}.hotkey.detections_started"
                ).increment()
        # query in-flight detections; republish + stop on a verdict
        for key, det in [(k, d) for k, d in self._detections.items()
                         if k[0] == app_name]:
            pidx = key[1]
            if primaries.get(pidx, det["node"]) != det["node"]:
                # primary moved: the detector state died with the old
                # node — abandon so a fresh streak can restart detection
                # against the new primary
                self._finish_detection(key, det)
                continue
            try:
                out = self.remote_command(det["node"], "detect_hotkey",
                                          [det["gpid"], det["kind"], "query"])
            except (RpcError, OSError):
                # an unreachable node must not pin the detection forever:
                # failed rounds count against the same query budget
                det["queries"] += 1
                if det["queries"] > self.hotkey_query_limit:
                    self._finish_detection(key, det)
                continue
            if "hotkey:" in out:
                hotkey = out.split("hotkey:", 1)[1].strip()
                per_app = dict(self.hotkey_results.get(app_name, {}))
                per_app[pidx] = {"kind": det["kind"], "key": hotkey,
                                 "ts": time.time()}
                self.hotkey_results = {**self.hotkey_results,
                                       app_name: per_app}
                counters.rate(
                    f"collector.app.{app_name}.hotkey.found_count").increment()
                counters.number(
                    f"collector.app.{app_name}.hotkey.{pidx}.hot").set(1)
                if det["kind"] == "read":
                    # a confirmed read hotspot pins the partition's SSTs
                    # on the card so its batched reads serve from the
                    # device lookup path (released when it calms)
                    self._set_read_residency(app_name, pidx, on=True,
                                             node=det["node"],
                                             gpid=det["gpid"])
                self._finish_detection(key, det)
            elif "STOPPED" in out:    # detector timed out without an outlier
                self._finish_detection(key, det, stop=False)
            else:
                det["queries"] += 1
                if det["queries"] > self.hotkey_query_limit:
                    self._finish_detection(key, det)
        counters.number(
            f"collector.app.{app_name}.hotkey.active_detections").set(
            sum(1 for k in self._detections if k[0] == app_name))

    #: requires self._lock
    def _set_read_residency(self, app_name: str, pidx: int, on: bool,
                            node: str = None, gpid: str = None) -> None:
        """Flip one partition's device read residency on its primary via
        the set-read-residency remote command; bookkeeping in
        self.read_residency so calming turns off exactly what a verdict
        turned on. Failures are dropped — the next verdict (or calm
        round) retries, and residency is a hint, not state."""
        key = (app_name, pidx)
        if on:
            target = {"node": node, "gpid": gpid}
        else:
            target = self.read_residency.get(key)
            if target is None:
                return  # never switched on (or already released)
        try:
            self.remote_command(target["node"], "set-read-residency",
                                [target["gpid"], "on" if on else "off"])
        except (RpcError, OSError):
            # state untouched either way: a failed ON is not resident (a
            # later verdict retries), a failed OFF keeps its bookkeeping
            # so the next calm round resends the release — the server's
            # flag must not stay hot because one RPC was dropped
            return
        # copy-on-write publish (see hotkey_results): readers are free
        rr = dict(self.read_residency)
        if on:
            rr[key] = target
        else:
            rr.pop(key, None)
        self.read_residency = rr
        counters.number(
            f"collector.app.{app_name}.hotkey.{pidx}.device_resident").set(
            1 if on else 0)

    def _finish_detection(self, key, det, stop: bool = True) -> None:  #: requires self._lock
        self._detections.pop(key, None)
        self._hot_streak.pop(key, None)
        if stop:
            try:
                self.remote_command(det["node"], "detect_hotkey",
                                    [det["gpid"], det["kind"], "stop"])
            except (RpcError, OSError):
                pass


def hotspot_partitions(per_partition_qps: dict, sigmas: float = 3.0) -> list:
    """Sigma analysis of per-partition load (reference
    hotspot_partition_calculator::stat_histories_analyse). Each candidate is
    tested against mean + sigmas*stddev of the OTHER partitions so a single
    extreme outlier cannot inflate the threshold that hides it."""
    if len(per_partition_qps) < 3:
        return []
    out = []
    for p, v in per_partition_qps.items():
        rest = [x for q, x in per_partition_qps.items() if q != p]
        mean = sum(rest) / len(rest)
        var = sum((x - mean) ** 2 for x in rest) / len(rest)
        stddev = var ** 0.5
        if v > mean + sigmas * stddev and v > mean:
            out.append(p)
    return sorted(out)
