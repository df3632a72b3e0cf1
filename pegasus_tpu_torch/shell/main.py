"""pegasus shell: admin + data CLI over the meta server and replica nodes.

Port of pegasus_tpu/shell/main.py (the src/shell surface: command table
src/shell/main.cpp:42-..., impls src/shell/commands/*.cpp) over the
port's client and meta RPCs. Runs as a REPL (`python -m
pegasus_tpu_torch.shell --meta host:port`) or one-shot (`... --meta
host:port -- app ls`). Every command prints the reference shell's lines:
cluster info, table DDL, nodes, data ops (set/get/del/multi_*/ttl/incr/
scans/count_data/copy_data), app envs and manual compaction, remote
commands and counters, the traces, jobs and table ledgers, the
consistency audit, the cluster doctor, the compaction scheduler's tokens,
hotkey detection, SLO verdicts, app stats, the integrity plane (scrub,
quarantine status, the flight recorder's incidents), backup and restore,
backup policies, bulk-load sessions, the meta level and the offline
debuggers. The shell runs the audit, the doctor, `app_stat`'s collection
round, `slow_requests --cluster`'s rollup and `flight_recorder`'s
listing and captures in its own process, as the reference's does;
`slo <collector>` reads the collector's verdicts.

A command whose plane the port does not have yet (duplication, balance,
recover, ddd_diagnose, ...) prints one error line
naming the missing module and, in
one-shot mode, exits non-zero. The reference shell has no split command:
a split is the RPC_CM_START_PARTITION_SPLIT DDL.
"""

import argparse
import json
import shlex
import sys
import time

from ..base.utils import c_escape_string
from ..client import MetaResolver, PegasusClient, PegasusError
from ..meta import messages as mm
from ..meta.meta_server import (RPC_CM_CREATE_APP, RPC_CM_DROP_APP,
                                RPC_CM_LIST_APPS, RPC_CM_LIST_NODES,
                                RPC_CM_QUERY_CONFIG, RPC_CM_SET_APP_ENVS)
from ..rpc import codec
from ..rpc.transport import ConnectionPool, RpcError
from ..runtime.remote_command import RemoteCommandRequest, RemoteCommandResponse
from ..runtime.table_stats import fold_snapshots, top_k


# commands whose plane is not ported yet -> the module they need
NOT_PORTED = {
    "recall": "the meta's recall of soft-dropped apps "
              "(meta/meta_server.py RPC_CM_RECALL_APP)",
    "cross_cluster_audit": "duplication (replication/duplicator.py)",
    "propose": "balance (meta/meta_server.py RPC_CM_PROPOSE_BALANCER)",
    "balance": "balance (meta/meta_server.py RPC_CM_START_BALANCE)",
    "add_dup": "duplication (replication/duplicator.py)",
    "query_dup": "duplication (replication/duplicator.py)",
    "start_dup": "duplication (replication/duplicator.py)",
    "pause_dup": "duplication (replication/duplicator.py)",
    "remove_dup": "duplication (replication/duplicator.py)",
    "set_dup_fail_mode": "duplication (replication/duplicator.py)",
    "recover": "recover (meta/meta_server.py RPC_CM_START_RECOVERY)",
    "ddd_diagnose": "ddd_diagnose (meta/meta_server.py RPC_CM_DDD_DIAGNOSE)",
}


class NotPorted(Exception):
    """A command whose plane the port does not have yet."""


class Shell:
    def __init__(self, meta_addrs, out=sys.stdout, rpc_timeout: float = 10.0):
        self.meta_addrs = list(meta_addrs)
        self.pool = ConnectionPool()
        self.out = out
        # seconds one meta DDL or node command may take (the reference's
        # fixed 10 s); a caller driving a table of millions of records
        # through backup or restore raises it
        self.rpc_timeout = rpc_timeout
        self.current_app = None
        self.failed = False  # a command answered NotPorted
        self._clients = {}
        self.commands = {
            "help": (self.cmd_help, "list commands"),
            "cluster_info": (self.cmd_cluster_info, "meta + node summary"),
            "ls": (self.cmd_ls, "list tables"),
            "app": (self.cmd_app, "app <name> — show partition table"),
            "create": (self.cmd_create, "create <name> [-p N] [-r N]"),
            "drop": (self.cmd_drop,
                     "drop <name> [-r seconds] — -r keeps it recallable"),
            "recall": (self._not_ported("recall"),
                       "recall <app_id> [new_name] — restore a soft-dropped app"),
            "use": (self.cmd_use, "use <name> — select table for data ops"),
            "nodes": (self.cmd_nodes, "list replica nodes"),
            "set": (self.cmd_set, "set <hk> <sk> <value> [ttl]"),
            "get": (self.cmd_get, "get <hk> <sk>"),
            "del": (self.cmd_del, "del <hk> <sk>"),
            "exist": (self.cmd_exist, "exist <hk> <sk>"),
            "ttl": (self.cmd_ttl, "ttl <hk> <sk>"),
            "incr": (self.cmd_incr, "incr <hk> <sk> [by]"),
            "multi_set": (self.cmd_multi_set, "multi_set <hk> <sk> <v> [<sk> <v>...]"),
            "multi_get": (self.cmd_multi_get, "multi_get <hk> [sk...]"),
            "multi_del": (self.cmd_multi_del, "multi_del <hk> <sk> [sk...]"),
            "sortkey_count": (self.cmd_sortkey_count, "sortkey_count <hk>"),
            "count": (self.cmd_sortkey_count,
                      "count <hk> — sort key count (alias of sortkey_count)"),
            "check_and_set": (self.cmd_check_and_set,
                              "check_and_set <hk> <check_sk> <check_type> "
                              "<operand> <set_sk> <set_value> [ttl]"),
            "check_and_mutate": (self.cmd_check_and_mutate,
                                 "check_and_mutate <hk> <check_sk> <check_type> "
                                 "<operand> set <sk> <v> | del <sk> [...]"),
            "hash_scan": (self.cmd_hash_scan, "hash_scan <hk> [start] [stop]"),
            "full_scan": (self.cmd_full_scan, "full_scan [max_rows]"),
            "count_data": (self.cmd_count_data, "count rows in current table"),
            "copy_data": (self.cmd_copy_data, "copy_data <dest_table>"),
            "get_app_envs": (self.cmd_get_app_envs, "show current table envs"),
            "set_app_envs": (self.cmd_set_app_envs, "set_app_envs <k> <v> [...]"),
            "del_app_envs": (self.cmd_del_app_envs, "del_app_envs <k> [...]"),
            "manual_compact": (self.cmd_manual_compact,
                               "trigger once manual compaction via app envs"),
            "query_compact_state": (self.cmd_query_compact,
                                    "query manual compact state on nodes"),
            "compact_sched": (self.cmd_compact_sched,
                              "compact_sched [node|all] [gpid] — per-"
                              "partition compaction-scheduler decisions "
                              "(defer/normal/urgent + the reasons that "
                              "drove them + live debt) from every node's "
                              "compact-sched-status"),
            "offload_status": (self.cmd_offload_status,
                               "offload_status <host:port> — a compaction-"
                               "offload service's free merge budget, "
                               "running merges, jobs and staged bytes"),
            "remote_command": (self.cmd_remote_command,
                               "remote_command <node|all> <cmd> [args...]"),
            "server_info": (self.cmd_server_info, "server-info on every node"),
            "server_stat": (self.cmd_server_stat, "server-stat on every node"),
            "perf_counters": (self.cmd_perf_counters,
                              "perf_counters <node> [prefix]"),
            "compact_trace": (self.cmd_compact_trace,
                              "compact_trace [node] [last] — recent "
                              "compaction stage spans (pack/h2d/device/"
                              "gather) from the tracing ring buffer"),
            "device_health": (self.cmd_device_health,
                              "device-health watchdog state on every node "
                              "(last_ok / last_error / wedged_at_stage / "
                              "open stages)"),
            "quarantine_status": (self.cmd_quarantine_status,
                                  "quarantine_status [node] — replicas "
                                  "fenced for on-disk corruption (reason, "
                                  "source, forensics dir) per node"),
            "scrub_replica": (self.cmd_scrub_replica,
                              "scrub_replica <node|all> [gpid] — force one "
                              "integrity scrub pass now (checksum-verify "
                              "live SSTs off the serving path; corrupt "
                              "replicas quarantine themselves)"),
            "request_trace": (self.cmd_request_trace,
                              "request_trace [node] [last] — recent sampled "
                              "request traces (client/rpc/replication/engine "
                              "stage timelines)"),
            "slow_requests": (self.cmd_slow_requests,
                              "slow_requests [node|--cluster] [last] — the "
                              "slow-request ledger; --cluster merges every "
                              "node's ledger into one worst-first top-N"),
            "job_trace": (self.cmd_job_trace,
                          "job_trace [node] [last|<job-id>] — background-"
                          "job timelines (compaction/offload/learn/dup "
                          "hops, one causal id across nodes)"),
            "events": (self.cmd_events,
                       "events [node] [last] [prefix] — the structured "
                       "event ring (flight recorder): breaker trips, "
                       "scheduler tokens, elections, splits, fail-point "
                       "arms... per process, pid-keyed"),
            "flight_recorder": (self.cmd_flight_recorder,
                                "flight_recorder [list|show <id>|capture "
                                "[reason]] — retained incident artifacts "
                                "(auto-captured on doctor degradation / "
                                "chaos failures) or a manual capture now"),
            "trigger_audit": (self.cmd_trigger_audit,
                              "trigger_audit [app] — decree-anchored "
                              "consistency audit: every replica digests its "
                              "state at the same applied decree; mismatches "
                              "name the exact (app, pidx, node)"),
            "cluster_doctor": (self.cmd_cluster_doctor,
                               "cluster_doctor [last] — ONE cluster health "
                               "verdict (healthy|degraded|critical) with "
                               "named causes + evidence"),
            "tables": (self.cmd_tables,
                       "tables [k] — cluster-folded per-table tenant "
                       "ledgers (ops/latency/bytes/throttle/device/HBM) "
                       "+ top-k capacity attribution, from every alive "
                       "node's table-stats"),
            "slo": (self.cmd_slo,
                    "slo [node] — per-table SLO burn-rate verdicts "
                    "(ok|warn|burning + named evidence) from every "
                    "node's slo-status (the collector evaluates)"),
            "detect_hotkey": (self.cmd_detect_hotkey,
                              "detect_hotkey <node> <app_id.pidx> <read|write> <start|stop|query>"),
            "set_fail_point": (self.cmd_set_fail_point,
                               "set_fail_point <node|all> <name> <action> — "
                               "arm/heal a fail point in live server "
                               "processes (chaos harness; action e.g. "
                               "'sleep(40)', '20%raise(x)', 'off()')"),
            "cross_cluster_audit": (self._not_ported("cross_cluster_audit"),
                                    "cross_cluster_audit <app> "
                                    "<dst_meta[,dst_meta...]> [dupid] — "
                                    "table-level digest compare against a "
                                    "duplication target cluster, anchored "
                                    "at the duplicator's confirmed decree "
                                    "(quiesce writes first)"),
            "propose": (self._not_ported("propose"),
                        "propose <pidx> <target_node> — move primary"),
            "balance": (self._not_ported("balance"), "equalize primary counts"),
            "add_dup": (self._not_ported("add_dup"),
                        "add_dup <app> <remote_cluster> [-f] — freeze=no ship yet"),
            "query_dup": (self._not_ported("query_dup"), "query_dup <app>"),
            "start_dup": (self._not_ported("start_dup"), "start_dup <app> <dupid>"),
            "pause_dup": (self._not_ported("pause_dup"), "pause_dup <app> <dupid>"),
            "remove_dup": (self._not_ported("remove_dup"), "remove_dup <app> <dupid>"),
            "set_dup_fail_mode": (self._not_ported("set_dup_fail_mode"),
                                  "set_dup_fail_mode <app> <dupid> <slow|skip>"),
            "backup_app": (self.cmd_backup_app,
                           "backup_app <app> <backup_root> — one-shot backup"),
            "restore_app": (self.cmd_restore_app,
                            "restore_app <backup_root> <backup_id> <old_app> <new_app>"),
            "add_backup_policy": (self.cmd_add_backup_policy,
                                  "add_backup_policy <name> <backup_root> <apps,csv> "
                                  "<interval_s> [history_count] — backups land in "
                                  "<backup_root>/<name>/<backup_id>/"),
            "ls_backup_policy": (self.cmd_ls_backup_policy,
                                 "ls_backup_policy [name]"),
            "modify_backup_policy": (self.cmd_modify_backup_policy,
                                     "modify_backup_policy <name> [-i sec] [-c count] "
                                     "[--add app,..] [--remove app,..]"),
            "enable_backup_policy": (self.cmd_enable_backup_policy,
                                     "enable_backup_policy <name>"),
            "disable_backup_policy": (self.cmd_disable_backup_policy,
                                      "disable_backup_policy <name>"),
            "start_bulk_load": (self.cmd_start_bulk_load,
                                "start_bulk_load <app> <provider_root> [-a] "
                                "— -a = async session (query/pause/cancel)"),
            "query_bulk_load_status": (self.cmd_query_bulk_load,
                                       "query_bulk_load_status <app>"),
            "pause_bulk_load": (self.cmd_pause_bulk_load,
                                "pause_bulk_load <app>"),
            "restart_bulk_load": (self.cmd_restart_bulk_load,
                                  "restart_bulk_load <app> — resume a paused session"),
            "cancel_bulk_load": (self.cmd_cancel_bulk_load,
                                 "cancel_bulk_load <app>"),
            "recover": (self._not_ported("recover"),
                        "recover <node> [node...] — rebuild meta state from nodes"),
            "ddd_diagnose": (self._not_ported("ddd_diagnose"),
                             "ddd_diagnose [app] [-f] — find/fix double-dead partitions"),
            "version": (self.cmd_version, "server + shell version"),
            "timeout": (self.cmd_timeout,
                        "timeout [ms] — get/set the data-op client timeout"),
            "hash": (self.cmd_hash,
                     "hash <hk> <sk> — partition hash + routed pidx"),
            "app_stat": (self.cmd_app_stat,
                         "per-app qps/cu aggregates scraped from primaries"),
            "app_disk": (self.cmd_app_disk,
                         "app_disk [app] — per-replica disk usage by node"),
            "multi_get_sortkeys": (self.cmd_multi_get_sortkeys,
                                   "multi_get_sortkeys <hk> — sortkeys only"),
            "multi_get_range": (self.cmd_multi_get_range,
                                "multi_get_range <hk> <start_sk> <stop_sk>"),
            "multi_del_range": (self.cmd_multi_del_range,
                                "multi_del_range <hk> <start_sk> <stop_sk>"),
            "clear_app_envs": (self.cmd_clear_app_envs,
                               "reset every app env of the current table"),
            "clear_data": (self.cmd_clear_data,
                           "clear_data <table> yes — delete EVERY row"),
            "get_meta_level": (self.cmd_get_meta_level,
                               "meta function level (blind/freezed/steady/lively)"),
            "set_meta_level": (self.cmd_set_meta_level,
                               "set_meta_level <blind|freezed|steady|lively>"),
            "query_backup_policy": (self.cmd_ls_backup_policy,
                                    "alias of ls_backup_policy"),
            "batched_manual_compact": (self.cmd_batched_manual_compact,
                                       "batched_manual_compact <node|all> — "
                                       "node-level batched device compaction"),
            "sst_dump": (self.cmd_sst_dump,
                         "sst_dump <file.sst> [max_rows] — offline SST reader"),
            "mlog_dump": (self.cmd_mlog_dump,
                          "mlog_dump <plog_dir> [from_decree] — offline log reader"),
            "local_get": (self.cmd_local_get,
                          "local_get <replica_data_dir> <hashkey> <sortkey>"),
            "cc": (self.cmd_cc,
                   "cc <meta1[,meta2...]> — change to another cluster"),
            "escape_all": (self.cmd_escape_all,
                           "escape_all [true|false] — escape all bytes, not "
                           "just invisible ones"),
            "flush_log": (self.cmd_flush_log,
                          "flush_log <node|all> — fsync mutation logs"),
            "rdb_key_str2hex": (self.cmd_rdb_key_str2hex,
                                "rdb_key_str2hex <hashkey> <sortkey>"),
            "rdb_key_hex2str": (self.cmd_rdb_key_hex2str,
                                "rdb_key_hex2str <rdb_key_hex>"),
            "rdb_value_hex2str": (self.cmd_rdb_value_hex2str,
                                  "rdb_value_hex2str <value_hex>"),
            "query_restore_status": (self.cmd_query_restore_status,
                                     "query_restore_status <new_app>"),
            "exit": (None, "quit"),
            "quit": (None, "quit"),
        }

    # ----------------------------------------------------------- plumbing

    @staticmethod
    def _not_ported(name):
        def refuse(args):
            raise NotPorted(f"{name}: not ported to pegasus_tpu_torch yet "
                            f"(needs {NOT_PORTED[name]})")

        return refuse

    def _meta_call(self, code, req, resp_cls):
        last = None
        for m in self.meta_addrs:
            host, _, port = m.rpartition(":")
            try:
                conn = self.pool.get((host, int(port)))
                _, body = conn.call(code, codec.encode(req),
                                    timeout=self.rpc_timeout)
                return codec.decode(resp_cls, body)
            except (RpcError, OSError) as e:
                last = e
        raise RpcError(7, f"no meta reachable: {last}")

    def _node_command(self, node, command, args):
        host, _, port = node.rpartition(":")
        conn = self.pool.get((host, int(port)))
        _, body = conn.call("RPC_CLI_CLI_CALL",
                            codec.encode(RemoteCommandRequest(command, args)),
                            timeout=self.rpc_timeout)
        return codec.decode(RemoteCommandResponse, body).output

    def _client(self, app=None) -> PegasusClient:
        app = app or self.current_app
        if app is None:
            raise PegasusError(4, "no table selected (use <name>)")
        if app not in self._clients:
            self._clients[app] = PegasusClient(
                MetaResolver(self.meta_addrs, app, self.pool),
                timeout=getattr(self, "_default_timeout", 10.0))
        return self._clients[app]

    def _nodes(self):
        r = self._meta_call(RPC_CM_LIST_NODES, mm.ListNodesRequest(),
                            mm.ListNodesResponse)
        return r.nodes

    def p(self, *args):
        print(*args, file=self.out)

    def _esc(self, data: bytes) -> str:
        return c_escape_string(data, getattr(self, "escape_all", False))

    # ----------------------------------------------------------- commands

    def cmd_help(self, args):
        for name, (_, doc) in sorted(self.commands.items()):
            self.p(f"  {name:<22} {doc}")

    def cmd_cluster_info(self, args):
        apps = self._meta_call(RPC_CM_LIST_APPS, mm.ListAppsRequest(),
                               mm.ListAppsResponse).apps
        nodes = self._nodes()
        self.p(f"meta_servers       : {','.join(self.meta_addrs)}")
        self.p(f"app_count          : {len(apps)}")
        self.p(f"node_count         : {len(nodes)} "
               f"({sum(1 for n in nodes if n.alive)} alive)")

    def cmd_ls(self, args):
        apps = self._meta_call(RPC_CM_LIST_APPS, mm.ListAppsRequest(),
                               mm.ListAppsResponse).apps
        self.p(f"{'app_id':>6}  {'status':<14} {'app_name':<24} "
               f"{'pcount':>6} {'rcount':>6}")
        for a in sorted(apps, key=lambda x: x.app_id):
            self.p(f"{a.app_id:>6}  {a.status:<14} {a.app_name:<24} "
                   f"{a.partition_count:>6} {a.replica_count:>6}")

    def cmd_app(self, args):
        name = args[0] if args else self.current_app
        cfg = self._meta_call(RPC_CM_QUERY_CONFIG, mm.QueryConfigRequest(name),
                              mm.QueryConfigResponse)
        if cfg.error:
            self.p(f"ERROR: {cfg.error_text}")
            return
        self.p(f"app {cfg.app.app_name} id={cfg.app.app_id} "
               f"partitions={cfg.app.partition_count}")
        self.p(f"{'pidx':>4} {'ballot':>6}  {'primary':<22} secondaries")
        for pc in cfg.partitions:
            self.p(f"{pc.pidx:>4} {pc.ballot:>6}  {pc.primary:<22} "
                   f"{','.join(pc.secondaries)}")

    def cmd_create(self, args):
        ap = argparse.ArgumentParser(prog="create")
        ap.add_argument("name")
        ap.add_argument("-p", "--partition_count", type=int, default=8)
        ap.add_argument("-r", "--replica_count", type=int, default=3)
        ns = ap.parse_args(args)
        r = self._meta_call(RPC_CM_CREATE_APP,
                            mm.CreateAppRequest(ns.name, ns.partition_count,
                                                ns.replica_count),
                            mm.CreateAppResponse)
        self.p(f"ERROR: {r.error_text}" if r.error
               else f"create app {ns.name} succeed, id={r.app_id}")

    def cmd_drop(self, args):
        ap = argparse.ArgumentParser(prog="drop", add_help=False)
        ap.add_argument("name")
        ap.add_argument("-r", "--reserve_seconds", type=int, default=0)
        try:
            ns = ap.parse_args(args)
        except SystemExit:
            raise ValueError(args)
        r = self._meta_call(RPC_CM_DROP_APP,
                            mm.DropAppRequest(ns.name, ns.reserve_seconds),
                            mm.DropAppResponse)
        self._clients.pop(ns.name, None)
        self.p(f"ERROR: {r.error_text}" if r.error
               else f"drop app {ns.name} succeed")

    def cmd_use(self, args):
        self.current_app = args[0]
        self.p(f"OK, table: {args[0]}")

    def cmd_nodes(self, args):
        self.p(f"{'address':<22} {'status':<8} {'replica_count':>13}")
        for n in self._nodes():
            self.p(f"{n.address:<22} {'ALIVE' if n.alive else 'UNALIVE':<8} "
                   f"{n.replica_count:>13}")

    # data ops ------------------------------------------------------------

    def cmd_set(self, args):
        ttl = int(args[3]) if len(args) > 3 else 0
        self._client().set(args[0].encode(), args[1].encode(),
                           args[2].encode(), ttl_seconds=ttl)
        self.p("OK")

    def cmd_get(self, args):
        v = self._client().get(args[0].encode(), args[1].encode())
        self.p("not found" if v is None else f'"{self._esc(v)}"')

    def cmd_del(self, args):
        self._client().delete(args[0].encode(), args[1].encode())
        self.p("OK")

    def cmd_exist(self, args):
        self.p(str(self._client().exist(args[0].encode(), args[1].encode())).lower())

    def cmd_ttl(self, args):
        t = self._client().ttl(args[0].encode(), args[1].encode())
        self.p("not found" if t is None
               else ("no ttl" if t < 0 else f"{t} seconds"))

    def cmd_incr(self, args):
        by = int(args[2]) if len(args) > 2 else 1
        self.p(str(self._client().incr(args[0].encode(), args[1].encode(), by)))

    def cmd_multi_set(self, args):
        hk, rest = args[0].encode(), args[1:]
        kvs = {rest[i].encode(): rest[i + 1].encode()
               for i in range(0, len(rest) - 1, 2)}
        self._client().multi_set(hk, kvs)
        self.p(f"OK, {len(kvs)} kvs")

    def cmd_multi_get(self, args):
        hk = args[0].encode()
        sks = [a.encode() for a in args[1:]] or None
        complete, kvs = self._client().multi_get(hk, sort_keys=sks)
        for sk in sorted(kvs):
            self.p(f'"{self._esc(sk)}" : "{self._esc(kvs[sk])}"')
        self.p(f"{len(kvs)} rows{'' if complete else ' (incomplete)'}")

    def cmd_multi_del(self, args):
        n = self._client().multi_del(args[0].encode(),
                                     [a.encode() for a in args[1:]])
        self.p(f"OK, {n} deleted")

    def cmd_sortkey_count(self, args):
        self.p(str(self._client().sortkey_count(args[0].encode())))

    @staticmethod
    def _cas_check_type(token: str) -> int:
        from ..rpc.messages import CasCheckType

        try:
            return int(token)
        except ValueError:
            return CasCheckType[token.upper()].value

    def cmd_check_and_set(self, args):
        """check_and_set <hk> <check_sk> <check_type> <operand> <set_sk>
        <set_value> [ttl] (reference shell data_operations check_and_set)."""
        ct = self._cas_check_type(args[2])
        ttl = int(args[6]) if len(args) > 6 else 0
        r = self._client().check_and_set(
            args[0].encode(), args[1].encode(), ct, args[3].encode(),
            args[4].encode(), args[5].encode(), set_ttl_seconds=ttl,
            return_check_value=True)
        from ..rpc.messages import Status

        self.p(f"set_succeed: {str(r.error == Status.OK).lower()}")
        if r.check_value_returned and r.check_value_exist:
            self.p(f'check_value: "{self._esc(r.check_value)}"')

    def cmd_check_and_mutate(self, args):
        """check_and_mutate <hk> <check_sk> <check_type> <operand>
        set <sk> <v> | del <sk> [...]."""
        ct = self._cas_check_type(args[2])
        muts, i = [], 4
        while i < len(args):
            if args[i] == "set":
                muts.append(("set", args[i + 1].encode(),
                             args[i + 2].encode(), 0))
                i += 3
            elif args[i] == "del":
                muts.append(("del", args[i + 1].encode()))
                i += 2
            else:
                self.p(f"bad mutation token {args[i]!r}")
                return
        if not muts:
            self.p("no mutations given")
            return
        r = self._client().check_and_mutate(
            args[0].encode(), args[1].encode(), ct, args[3].encode(), muts,
            return_check_value=True)
        from ..rpc.messages import Status

        self.p(f"mutate_succeed: {str(r.error == Status.OK).lower()}")
        if r.check_value_returned and r.check_value_exist:
            self.p(f'check_value: "{self._esc(r.check_value)}"')

    def cmd_hash_scan(self, args):
        hk = args[0].encode()
        start = args[1].encode() if len(args) > 1 else b""
        stop = args[2].encode() if len(args) > 2 else b""
        n = 0
        for _, sk, v in self._client().get_scanner(hk, start, stop):
            self.p(f'"{self._esc(sk)}" : "{self._esc(v)}"')
            n += 1
        self.p(f"{n} rows")

    def cmd_full_scan(self, args):
        limit = int(args[0]) if args else 1 << 30
        n = 0
        for sc in self._client().get_unordered_scanners():
            for hk, sk, v in sc:
                self.p(f'"{self._esc(hk)}" : "{self._esc(sk)}" => '
                       f'"{self._esc(v)}"')
                n += 1
                if n >= limit:
                    self.p(f"{n} rows (limited)")
                    return
        self.p(f"{n} rows")

    def cmd_count_data(self, args):
        n = 0
        for sc in self._client().get_unordered_scanners():
            for _ in sc:
                n += 1
        self.p(f"{n} rows")

    def cmd_copy_data(self, args):
        dest = self._client(args[0])
        n = 0
        for sc in self._client().get_unordered_scanners():
            for hk, sk, v in sc:
                dest.set(hk, sk, v)
                n += 1
        self.p(f"copied {n} rows to {args[0]}")

    # env / admin ---------------------------------------------------------

    def _set_envs(self, envs: dict):
        r = self._meta_call(RPC_CM_SET_APP_ENVS,
                            mm.SetAppEnvsRequest(self.current_app,
                                                 json.dumps(envs)),
                            mm.SetAppEnvsResponse)
        if r.error:
            self.p(f"ERROR: {r.error_text}")
        return r.error == 0

    def cmd_get_app_envs(self, args):
        cfg = self._meta_call(RPC_CM_QUERY_CONFIG,
                              mm.QueryConfigRequest(self.current_app),
                              mm.QueryConfigResponse)
        self.p(json.dumps(json.loads(cfg.app.envs_json), indent=1))

    def cmd_set_app_envs(self, args):
        envs = {args[i]: args[i + 1] for i in range(0, len(args) - 1, 2)}
        if self._set_envs(envs):
            self.p(f"set {len(envs)} envs OK")

    def cmd_del_app_envs(self, args):
        # empty value removes at the replica layer; meta keeps the tombstone
        if self._set_envs({k: "" for k in args}):
            self.p("OK")

    def cmd_manual_compact(self, args):
        if self._set_envs({"manual_compact.once.trigger_time":
                           str(int(time.time()))}):
            self.p("manual compact triggered")

    def cmd_query_compact(self, args):
        for n in self._nodes():
            if n.alive:
                self.p(f"[{n.address}]")
                self.p(self._node_command(n.address, "query-compact-state", []))

    def cmd_compact_sched(self, args):
        """Per-partition compaction-scheduler decisions, one line per
        gpid: the policy token, the reasons that drove it and the live
        debt behind it, from each node's compact-sched-status."""
        target = args[0] if args else "all"
        rest = args[1:]
        nodes = ([n.address for n in self._nodes() if n.alive]
                 if target == "all" else [target])
        for node in nodes:
            try:
                out = self._node_command(node, "compact-sched-status", rest)
                doc = json.loads(out)
            except (RpcError, OSError, ValueError) as e:
                self.p(f"[{node}] unreachable/bad reply: {e}")
                continue
            self.p(f"[{node}]")
            if not isinstance(doc, dict) or not doc:
                self.p("  no partitions")
                continue
            for gpid, d in sorted(doc.items()):
                if not isinstance(d, dict) or "policy" not in d:
                    self.p(f"  {gpid}: {d}")
                    continue
                reasons = ",".join(d.get("reasons", [])) or "-"
                where = d.get("offload") or "local"
                self.p(f"  {gpid}: {d['policy']:<7} where={where} "
                       f"reasons={reasons} "
                       f"l0={d.get('l0_files', 0)}"
                       f"/{d.get('ceiling_files', '?')} "
                       f"debt_bytes={d.get('debt_bytes', 0)} "
                       f"pending={d.get('pending_installs', 0)} "
                       f"expires_in={d.get('expires_in_s', 0)}s")

    def cmd_offload_status(self, args):
        """One compaction-offload service's live state: free merge
        budget (what the scheduler's placement fold consumes), running
        merges, active jobs, staged bytes."""
        if not args:
            self.p("usage: offload_status <host:port>")
            return
        self.p(self._node_command(args[0], "offload-status", []))

    def cmd_remote_command(self, args):
        target, cmd, rest = args[0], args[1], args[2:]
        nodes = ([n.address for n in self._nodes() if n.alive]
                 if target == "all" else [target])
        for node in nodes:
            self.p(f"[{node}]")
            self.p(self._node_command(node, cmd, rest))

    def cmd_server_info(self, args):
        self.cmd_remote_command(["all", "server-info"])

    def cmd_server_stat(self, args):
        self.cmd_remote_command(["all", "server-stat"])

    def cmd_perf_counters(self, args):
        node = args[0]
        cmd = "perf-counters-by-prefix" if len(args) > 1 else "perf-counters"
        self.p(self._node_command(node, cmd, args[1:]))

    def cmd_compact_trace(self, args):
        if args:
            self.p(self._node_command(args[0], "compact-trace-dump",
                                      args[1:]))
        else:
            self.cmd_remote_command(["all", "compact-trace-dump"])

    def cmd_device_health(self, args):
        self.cmd_remote_command(["all", "device-health"])

    def cmd_quarantine_status(self, args):
        if args:
            self.p(self._node_command(args[0], "quarantine-status", args[1:]))
        else:
            self.cmd_remote_command(["all", "quarantine-status"])

    def cmd_scrub_replica(self, args):
        if not args:
            self.p("usage: scrub_replica <node|all> [gpid]")
            return
        self.cmd_remote_command([args[0], "scrub-replica"] + args[1:])

    def cmd_request_trace(self, args):
        if args:
            self.p(self._node_command(args[0], "request-trace-dump",
                                      args[1:]))
        else:
            self.cmd_remote_command(["all", "request-trace-dump"])

    def cmd_job_trace(self, args):
        if args:
            self.p(self._node_command(args[0], "job-trace", args[1:]))
        else:
            self.cmd_remote_command(["all", "job-trace"])

    def cmd_slow_requests(self, args):
        if args and args[0] == "--cluster":
            from ..collector.info_collector import rollup_slow_requests

            last = int(args[1]) if len(args) > 1 else 20
            nodes = [n.address for n in self._nodes() if n.alive]
            merged = rollup_slow_requests(
                lambda n: self._node_command(n, "slow-requests", [str(last)]),
                nodes, last=last)
            self.p(json.dumps(merged, indent=1))
        elif args:
            self.p(self._node_command(args[0], "slow-requests", args[1:]))
        else:
            self.cmd_remote_command(["all", "slow-requests"])

    def cmd_slo(self, args):
        if args:
            self.p(self._node_command(args[0], "slo-status", args[1:]))
            return
        merged = {}
        for node in [n.address for n in self._nodes() if n.alive]:
            try:
                reply = json.loads(self._node_command(node, "slo-status", []))
            except ValueError:
                continue
            if isinstance(reply, dict):
                for verdicts in reply.values():
                    if isinstance(verdicts, dict):
                        merged.update(verdicts)
        self.p(json.dumps(merged, indent=1))
        burning = sorted(t for t, v in merged.items()
                         if isinstance(v, dict)
                         and v.get("verdict") == "burning")
        if burning:
            self.p("BURNING: " + ", ".join(burning))

    def cmd_detect_hotkey(self, args):
        node, rest = args[0], args[1:]
        self.p(self._node_command(node, "detect_hotkey", rest))

    def cmd_tables(self, args):
        k = int(args[0]) if args else 5
        frags = []
        for node in [n.address for n in self._nodes() if n.alive]:
            try:
                reply = json.loads(
                    self._node_command(node, "table-stats", []))
            except ValueError:
                continue
            if isinstance(reply, dict):
                frags.extend(v for v in reply.values()
                             if isinstance(v, dict))
        folded = fold_snapshots(frags)
        self.p(json.dumps({"tables": folded, "top": top_k(folded, k)},
                          indent=1))

    def cmd_set_fail_point(self, args):
        if len(args) < 3:
            self.p("usage: set_fail_point <node|all> <name> <action>")
            return
        target, rest = args[0], args[1:]
        nodes = ([n.address for n in self._nodes() if n.alive]
                 if target == "all" else [target])
        for node in nodes:
            self.p(f"[{node}] "
                   + self._node_command(node, "set-fail-point", rest))

    def cmd_events(self, args):
        if args:
            self.p(self._node_command(args[0], "events-dump", args[1:]))
        else:
            self.cmd_remote_command(["all", "events-dump"])

    def cmd_flight_recorder(self, args):
        from ..collector.flight_recorder import RECORDER

        sub = args[0] if args else "list"
        if sub == "capture":
            reason = " ".join(args[1:]) or "shell capture"
            inc = RECORDER.capture(self.meta_addrs, reason=reason,
                                   trigger="shell", pool=self.pool)
            self.p(json.dumps({"id": inc["id"], "path": inc["path"],
                               "first_cause": inc["first_cause"],
                               "timeline_events": len(inc["timeline"]),
                               "errors": inc["errors"]}, indent=1))
        elif sub == "show" and len(args) > 1:
            inc = RECORDER.load(args[1])
            self.p(json.dumps(inc, indent=1) if inc
                   else f"no retained incident {args[1]!r}")
        else:
            incidents = RECORDER.list_incidents()
            if not incidents:
                self.p("no retained incidents")
            for i in incidents:
                self.p(f"{i['id']}  trigger={i['trigger']} "
                       f"first_cause={i['first_cause']}  {i['reason']}")

    def cmd_trigger_audit(self, args):
        from ..collector.cluster_doctor import run_cluster_audit

        apps = [args[0]] if args else (
            [self.current_app] if self.current_app else None)
        report = run_cluster_audit(self.meta_addrs, pool=self.pool,
                                   apps=apps)
        self.p(json.dumps(report, indent=1))
        if report["mismatches"]:
            self.p(f"AUDIT FAILED: {len(report['mismatches'])} digest "
                   "mismatch(es)")
        elif report["inconclusive"]:
            self.p("audit inconclusive for "
                   f"{len(report['inconclusive'])} partition(s)")
        else:
            self.p(f"audit OK: {len(report['ok'])} partition(s), all "
                   "replicas identical at identical decrees")

    def cmd_cluster_doctor(self, args):
        from ..collector.cluster_doctor import run_cluster_doctor

        last = int(args[0]) if args else 10
        verdict = run_cluster_doctor(self.meta_addrs, pool=self.pool,
                                     slow_last=last)
        self.p(json.dumps(verdict, indent=1))
        self.p(f"cluster verdict: {verdict['verdict'].upper()}"
               + (f" ({len(verdict['causes'])} cause(s))"
                  if verdict["causes"] else ""))

    # backup / restore ----------------------------------------------------
    # (reference src/shell/commands/cold_backup.cpp incl. policy surface)

    def cmd_backup_app(self, args):
        from ..meta.meta_server import RPC_CM_BACKUP_APP

        r = self._meta_call(RPC_CM_BACKUP_APP,
                            mm.BackupAppRequest(args[0], args[1]),
                            mm.BackupAppResponse)
        if r.error:
            self.p(f"backup failed: {r.error_text}")
        else:
            self.p(f"backup succeed, backup_id={r.backup_id}")

    def cmd_restore_app(self, args):
        from ..meta.meta_server import RPC_CM_RESTORE_APP

        r = self._meta_call(RPC_CM_RESTORE_APP,
                            mm.RestoreAppRequest(args[0], int(args[1]),
                                                 args[2], args[3]),
                            mm.RestoreAppResponse)
        if r.error:
            self.p(f"restore failed: {r.error_text}")
        else:
            self.p(f"restore succeed, new app_id={r.app_id}")

    def cmd_add_backup_policy(self, args):
        from ..meta.meta_server import RPC_CM_ADD_BACKUP_POLICY

        pol = mm.BackupPolicyInfo(
            name=args[0], backup_root=args[1], apps=args[2].split(","),
            interval_seconds=int(args[3]),
            history_count=int(args[4]) if len(args) > 4 else 3)
        r = self._meta_call(RPC_CM_ADD_BACKUP_POLICY,
                            mm.AddBackupPolicyRequest(pol),
                            mm.AddBackupPolicyResponse)
        self.p(f"ERROR: {r.error_text}" if r.error else "OK")

    def cmd_ls_backup_policy(self, args):
        from ..meta.meta_server import RPC_CM_LS_BACKUP_POLICY

        r = self._meta_call(RPC_CM_LS_BACKUP_POLICY,
                            mm.LsBackupPolicyRequest(args[0] if args else ""),
                            mm.LsBackupPolicyResponse)
        if r.error:
            self.p(f"ERROR: {r.error_text}")
            return
        for p in r.policies:
            self.p(f"name={p.name} enabled={p.enabled} "
                   f"interval={p.interval_seconds}s history={p.history_count} "
                   f"root={p.backup_root}")
            self.p(f"  apps: {','.join(p.apps)}")
            self.p(f"  recent backups: {p.recent_backup_ids}")
        if not r.policies:
            self.p("(no policies)")

    def _modify_policy(self, req):
        from ..meta.meta_server import RPC_CM_MODIFY_BACKUP_POLICY

        r = self._meta_call(RPC_CM_MODIFY_BACKUP_POLICY, req,
                            mm.ModifyBackupPolicyResponse)
        self.p(f"ERROR: {r.error_text}" if r.error else "OK")

    def cmd_modify_backup_policy(self, args):
        req = mm.ModifyBackupPolicyRequest(name=args[0])
        i = 1
        while i < len(args):
            if args[i] == "-i":
                req.interval_seconds = int(args[i + 1]); i += 2
            elif args[i] == "-c":
                req.history_count = int(args[i + 1]); i += 2
            elif args[i] == "--add":
                req.add_apps = args[i + 1].split(","); i += 2
            elif args[i] == "--remove":
                req.remove_apps = args[i + 1].split(","); i += 2
            else:
                raise ValueError(args[i])
        self._modify_policy(req)

    def cmd_enable_backup_policy(self, args):
        self._modify_policy(mm.ModifyBackupPolicyRequest(name=args[0],
                                                         enabled=1))

    def cmd_disable_backup_policy(self, args):
        self._modify_policy(mm.ModifyBackupPolicyRequest(name=args[0],
                                                         enabled=0))

    # bulk load -----------------------------------------------------------
    # (reference src/shell/commands/bulk_load.cpp)

    def cmd_start_bulk_load(self, args):
        from ..meta.meta_server import RPC_CM_START_BULK_LOAD

        async_start = "-a" in args
        args = [a for a in args if a != "-a"]
        r = self._meta_call(RPC_CM_START_BULK_LOAD,
                            mm.StartBulkLoadRequest(args[0], args[1],
                                                    async_start=async_start),
                            mm.StartBulkLoadResponse)
        if r.error:
            self.p(f"bulk load failed: {r.error_text}")
        elif async_start:
            self.p("bulk load session started "
                   "(query_bulk_load_status to follow)")
        else:
            self.p(f"bulk load succeed, ingested {r.ingested_records} records")

    def cmd_query_bulk_load(self, args):
        from ..meta.meta_server import RPC_CM_QUERY_BULK_LOAD

        r = self._meta_call(RPC_CM_QUERY_BULK_LOAD,
                            mm.QueryBulkLoadRequest(args[0]),
                            mm.QueryBulkLoadResponse)
        if r.error:
            self.p(f"query failed: {r.error_text}")
        else:
            extra = f" ({r.error_text})" if r.error_text else ""
            self.p(f"bulk load of {args[0]}: {r.status}{extra}, "
                   f"{r.done_partitions}/{r.total_partitions} partitions, "
                   f"{r.ingested_records} records")

    def _control_bulk_load(self, app, action):
        from ..meta.meta_server import RPC_CM_CONTROL_BULK_LOAD

        r = self._meta_call(RPC_CM_CONTROL_BULK_LOAD,
                            mm.ControlBulkLoadRequest(app, action),
                            mm.ControlBulkLoadResponse)
        self.p(f"{action} failed: {r.error_text}" if r.error
               else f"{action} OK")

    def cmd_pause_bulk_load(self, args):
        self._control_bulk_load(args[0], "pause")

    def cmd_restart_bulk_load(self, args):
        self._control_bulk_load(args[0], "restart")

    def cmd_cancel_bulk_load(self, args):
        self._control_bulk_load(args[0], "cancel")

    def cmd_query_restore_status(self, args):
        from ..meta.meta_server import RPC_CM_QUERY_RESTORE

        r = self._meta_call(RPC_CM_QUERY_RESTORE,
                            mm.QueryRestoreRequest(args[0]),
                            mm.QueryRestoreResponse)
        if r.status == "none":
            self.p(f"no restore recorded for {args[0]}")
        else:
            self.p(f"restore of {args[0]}: {r.status}, from "
                   f"{r.old_app_name}@{r.backup_id}, "
                   f"{r.done_partitions}/{r.total_partitions} partitions")

    def cmd_version(self, args):
        from ..runtime.remote_command import VERSION

        self.p(VERSION)
        for n in self._nodes():
            try:
                self.p(f"{n.address}: {self._node_command(n.address, 'server-info', [])}")
            except (RpcError, OSError) as e:
                self.p(f"{n.address}: unreachable ({e})")

    def cmd_timeout(self, args):
        if args:
            ms = int(args[0])
            for cli in self._clients.values():
                cli.timeout = ms / 1000.0
            self._default_timeout = ms / 1000.0
        cur = getattr(self, "_default_timeout", 10.0)
        self.p(f"timeout: {int(cur * 1000)} ms")

    def cmd_hash(self, args):
        from ..base.key_schema import generate_key, key_hash

        key = generate_key(args[0].encode(), args[1].encode())
        h = key_hash(key)
        line = f"hash: {h}"
        if self.current_app:
            n = self._client().resolver.partition_count
            line += f"  partition: {h % n} (of {n})"
        self.p(line)

    def cmd_app_stat(self, args):
        from ..collector.info_collector import InfoCollector

        coll = InfoCollector(self.meta_addrs)
        try:
            summary = coll.collect_once()
        finally:
            coll.stop()
        hdr = ["get_qps", "put_qps", "multi_get_qps", "scan_qps",
               "recent_read_cu", "recent_write_cu"]
        self.p(f"{'app':<16} " + " ".join(f"{h:>15}" for h in hdr))
        for app, agg in sorted(summary.items()):
            self.p(f"{app:<16} " + " ".join(f"{agg.get(h, 0):>15.1f}"
                                            for h in hdr))

    def cmd_app_disk(self, args):
        want_app = args[0] if args else None
        app_ids = {}
        r = self._meta_call(RPC_CM_LIST_APPS, mm.ListAppsRequest(),
                            mm.ListAppsResponse)
        for a in r.apps:
            app_ids[str(a.app_id)] = a.app_name
        totals = {}
        for n in self._nodes():
            if not n.alive:
                continue
            try:
                snap = json.loads(self._node_command(n.address,
                                                     "replica-disk", []))
            except (RpcError, OSError, ValueError):
                self.p(f"{n.address} UNREACHABLE — totals below are "
                       f"incomplete")
                continue
            for key, info in snap.items():
                app = app_ids.get(key.split(".")[0], key.split(".")[0])
                if want_app and app != want_app:
                    continue
                t = totals.setdefault(app, {"sst_bytes": 0, "replicas": 0})
                t["sst_bytes"] += info["sst_bytes"]
                t["replicas"] += 1
                self.p(f"{n.address} {app}.{key.split('.')[1]} "
                       f"{info['sst_bytes']}B {info['records']} records "
                       f"{'P' if info['primary'] else 'S'}")
        for app, t in sorted(totals.items()):
            self.p(f"total {app}: {t['sst_bytes']}B across "
                   f"{t['replicas']} replicas")

    def cmd_multi_get_sortkeys(self, args):
        complete, kvs = self._client().multi_get(args[0].encode(),
                                                 no_value=True)
        for sk in sorted(kvs):
            self.p(f'"{self._esc(sk)}"')
        self.p(f"{len(kvs)} sortkeys"
               + ("" if complete else " (INCOMPLETE: server limit hit)"))

    def cmd_multi_get_range(self, args):
        complete, kvs = self._client().multi_get(
            args[0].encode(), start_sortkey=args[1].encode(),
            stop_sortkey=args[2].encode())
        for sk in sorted(kvs):
            self.p(f'"{self._esc(sk)}" : "{self._esc(kvs[sk])}"')
        self.p(f"{len(kvs)} rows"
               + ("" if complete else " (INCOMPLETE: server limit hit)"))

    def cmd_multi_del_range(self, args):
        cli = self._client()
        hk = args[0].encode()
        start, stop = args[1].encode(), args[2].encode()
        deleted = 0
        inclusive = True
        while True:
            # the server's RangeReadLimiter truncates big ranges: page from
            # the last deleted sortkey until the read completes, or a
            # 5000-row range would silently lose its tail
            complete, kvs = cli.multi_get(hk, start_sortkey=start,
                                          stop_sortkey=stop, no_value=True,
                                          start_inclusive=inclusive)
            if kvs:
                deleted += cli.multi_del(hk, list(kvs))
            if complete or not kvs:
                break
            start, inclusive = max(kvs), False
        self.p(f"deleted {deleted} rows")

    def cmd_clear_app_envs(self, args):
        if not self.current_app:
            raise PegasusError(4, "no table selected (use <name>)")
        cfg = self._meta_call(RPC_CM_QUERY_CONFIG,
                              mm.QueryConfigRequest(self.current_app),
                              mm.QueryConfigResponse)
        if cfg.error:
            self.p(f"ERROR: {cfg.error_text}")
            return
        envs = [k for k, v in json.loads(cfg.app.envs_json).items() if v]
        if not envs:
            self.p("no envs set")
            return
        self.cmd_del_app_envs(envs)

    def cmd_clear_data(self, args):
        """Destructive: requires `clear_data <table> yes`."""
        if len(args) < 2 or args[1] != "yes":
            self.p("refusing: run `clear_data <table> yes` to confirm")
            return
        cli = PegasusClient(MetaResolver(self.meta_addrs, args[0], self.pool))
        removed = 0
        for scanner in cli.get_unordered_scanners():
            batch = {}
            for hk, sk, _ in scanner:
                batch.setdefault(hk, []).append(sk)
            for hk, sks in batch.items():
                removed += cli.multi_del(hk, sks)
        self.p(f"cleared {removed} rows from {args[0]}")

    def cmd_get_meta_level(self, args):
        from ..meta.meta_server import RPC_CM_CONTROL_META

        r = self._meta_call(RPC_CM_CONTROL_META, mm.ControlMetaRequest(),
                            mm.ControlMetaResponse)
        self.p(f"meta level: {r.level}")

    def cmd_set_meta_level(self, args):
        from ..meta.meta_server import RPC_CM_CONTROL_META

        r = self._meta_call(RPC_CM_CONTROL_META,
                            mm.ControlMetaRequest(set_level=args[0]),
                            mm.ControlMetaResponse)
        self.p(f"ERROR: {r.error_text}" if r.error
               else f"meta level: {r.level}")

    def cmd_batched_manual_compact(self, args):
        targets = ([n.address for n in self._nodes() if n.alive]
                   if not args or args[0] == "all" else [args[0]])
        for node in targets:
            self.p(f"[{node}] "
                   + self._node_command(node, "batched-manual-compact", []))

    # offline debuggers ---------------------------------------------------
    # (reference src/shell/commands/debugger.cpp: sst_dump / mlog_dump /
    #  local_get read files directly, no cluster needed)

    def cmd_sst_dump(self, args):
        from ..base.key_schema import restore_key
        from ..engine.sstable import SSTable

        sst = SSTable(args[0])
        limit = int(args[1]) if len(args) > 1 else 50
        self.p(f"records={sst.n} level={sst.meta.get('level')} "
               f"decree={sst.meta.get('last_flushed_decree')} "
               f"bytes={sst.data_bytes}")
        b = sst.block()
        for i in range(min(sst.n, limit)):
            hk, sk = restore_key(b.key(i))
            flags = "DEL" if b.deleted[i] else f"exp={int(b.expire_ts[i])}"
            self.p(f'"{self._esc(hk)}" : "{self._esc(sk)}" '
                   f'[{flags}] => {len(b.value(i))}B')
        if sst.n > limit:
            self.p(f"... {sst.n - limit} more")

    def cmd_mlog_dump(self, args):
        import glob
        import os

        from ..replication.mutation_log import MutationLog

        frm = int(args[1]) if len(args) > 1 else 0
        root = args[0]
        # accept a single plog dir OR a replica-node root holding many
        # replicas (<app_id>.<pidx>/plog) — dump each in turn
        if glob.glob(os.path.join(root, "log.*")):
            targets = [("", root)]
        else:
            targets = sorted(
                (os.path.basename(d), os.path.join(d, "plog"))
                for d in glob.glob(os.path.join(root, "*"))
                if os.path.isdir(os.path.join(d, "plog")))
            if not targets:
                self.p(f"no plog under {root}")
                return
        for label, plog_dir in targets:
            if label:
                self.p(f"[replica {label}]")
            log = MutationLog(plog_dir)
            n = 0
            for m in log.replay(frm):
                self.p(f"decree={m.decree} ballot={m.ballot} ts={m.timestamp_us} "
                       f"ops={[c.rsplit('_', 1)[-1] for c in m.codes]}")
                n += 1
            self.p(f"{n} mutations")
            log.close()

    def cmd_cc(self, args):
        """cc <meta1[,meta2...]> — point the shell at another cluster
        (reference cc_command)."""
        self.meta_addrs = args[0].split(",")
        self.current_app = None
        self._clients = {}
        self.p(f"cluster changed to {','.join(self.meta_addrs)}")

    def cmd_escape_all(self, args):
        """escape_all [true|false] — toggle escaping of every output byte
        (reference process_escape_all)."""
        if args:
            self.escape_all = args[0].lower() in ("true", "1", "on", "yes")
        else:
            self.escape_all = not getattr(self, "escape_all", False)
        self.p(f"escape_all: {str(self.escape_all).lower()}")

    def cmd_flush_log(self, args):
        """flush_log <node|all> — fsync mutation logs on replica nodes."""
        targets = ([n.address for n in self._nodes() if n.alive]
                   if args[0] == "all" else [args[0]])
        for node in targets:
            self.p(f"{node}: {self._node_command(node, 'flush-log', [])}")

    def cmd_rdb_key_str2hex(self, args):
        """rdb_key_str2hex <hashkey> <sortkey> — engine key bytes as hex."""
        from ..base import key_schema

        key = key_schema.generate_key(args[0].encode(), args[1].encode())
        self.p(key.hex().upper())

    def cmd_rdb_key_hex2str(self, args):
        """rdb_key_hex2str <hex> — decode an engine key to hash/sort keys."""
        from ..base import key_schema

        try:
            hk, sk = key_schema.restore_key(bytes.fromhex(args[0]))
        except (ValueError, IndexError) as e:
            self.p(f"bad key hex: {e}")
            return
        self.p(f'hash_key: "{self._esc(hk)}"')
        self.p(f'sort_key: "{self._esc(sk)}"')

    def cmd_rdb_value_hex2str(self, args):
        """rdb_value_hex2str <hex> — decode a stored value (schema v0/v1/v2:
        user data + expire timestamp)."""
        from ..base.utils import epoch_begin
        from ..base.value_schema import ValueSchemaManager

        try:
            raw = bytes.fromhex(args[0])
            # self-describing first byte when present, else latest schema
            schema = ValueSchemaManager().get_value_schema(
                2 if raw and raw[0] & 0x80 else 0, raw)
            user = schema.extract_user_data(raw)
            expire = schema.extract_expire_ts(raw)
        except (ValueError, IndexError) as e:
            self.p(f"bad value hex: {e}")
            return
        self.p(f'user_data: "{self._esc(user)}"')
        if expire:
            self.p(f"expire_ts: {expire} (unix {expire + epoch_begin})")
        else:
            self.p("expire_ts: 0 (no ttl)")

    def cmd_local_get(self, args):
        from ..base.key_schema import generate_key
        from ..base.value_schema import SCHEMAS
        from ..engine.db import EngineOptions, LsmEngine

        eng = LsmEngine(args[0], EngineOptions(backend="cpu"))
        raw = eng.get(generate_key(args[1].encode(), args[2].encode()))
        if raw is None:
            self.p("not found")
        else:
            data = SCHEMAS[eng.data_version()].extract_user_data(raw)
            self.p(f'"{self._esc(data)}"')
        eng.close()

    # ---------------------------------------------------------------- run

    def run_line(self, line: str) -> bool:
        """-> False when the shell should exit."""
        parts = shlex.split(line)
        if not parts:
            return True
        name, args = parts[0], parts[1:]
        if name in ("exit", "quit"):
            return False
        ent = self.commands.get(name)
        if ent is None:
            self.p(f"unknown command {name!r} (try help)")
            return True
        try:
            ent[0](args)
        except NotPorted as e:
            self.failed = True
            self.p(f"ERROR: {e}")
        except (PegasusError, RpcError, OSError) as e:
            self.p(f"ERROR: {e}")
        except (IndexError, ValueError):
            self.p(f"usage: {ent[1]}")
        return True

    def repl(self):
        self.p("pegasus-tpu-torch shell; 'help' for commands")
        while True:
            try:
                prompt = f"{self.current_app or ''}> "
                line = input(prompt)
            except EOFError:
                break
            if not self.run_line(line):
                break


def main(argv=None) -> int:
    """-> the exit code: 1 when a one-shot command is not ported."""
    ap = argparse.ArgumentParser(prog="pegasus-shell")
    ap.add_argument("--meta", default="127.0.0.1:34601",
                    help="comma-separated meta server list")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="one-shot command (flags after the command name "
                         "pass through, e.g. create t -p 8)")
    ns = ap.parse_args(argv)
    sh = Shell(ns.meta.split(","))
    command = ns.command
    if command[:1] == ["--"]:
        # `--meta m -- cmd ...`, the documented form: argparse keeps
        # the separator in the remainder (the reference then answers
        # "unknown command '--'")
        command = command[1:]
    if command:
        sh.run_line(shlex.join(command))
        return 1 if sh.failed else 0
    sh.repl()
    return 0


if __name__ == "__main__":
    sys.exit(main())
