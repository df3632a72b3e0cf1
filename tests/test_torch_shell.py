"""The port's admin shell and sample against the port's cluster, on the
CPU, held to pegasus_tpu's shell and sample.

Every script below runs twice against one port cluster (the harness of
tests/test_torch_cluster.py): through pegasus_tpu_torch.shell.Shell on
one table and through pegasus_tpu.shell.Shell on a twin table. The two
print the same lines once table names, node addresses, ids, times and
the version string are masked. The duplication and admin verbs print
the reference shell's lines too. A command whose plane the port lacks
(none now) would print one error line naming the module, and fail a
one-shot run.
`python -m pegasus_tpu_torch.sample` prints the reference sample's
lines.
"""

import io
import os
import re
import subprocess
import sys

import pytest

from pegasus_tpu_torch.shell.main import NOT_PORTED, Shell
from tests.test_torch_cluster import Cluster
from tests.test_torch_replication import _FrozenTime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("shell"))
    yield c
    c.stop()


def _run(shell_cls, meta, lines) -> list:
    out = io.StringIO()
    sh = shell_cls([meta], out=out)
    for line in lines:
        sh.run_line(line)
    return out.getvalue().splitlines()


def _mask(lines, table) -> list:
    out = []
    for line in lines:
        if table:
            line = line.replace(table, "T")
        line = re.sub(r"127\.0\.0\.1:\d+", "ADDR", line)
        line = re.sub(r"(id=|app_id=|backup_id=)\d+", r"\1N", line)
        line = re.sub(r"\d+s ago", "Ns ago", line)
        out.append(line)
    return out


def both(cluster, lines, table) -> list:
    """The script through the port's shell on `<table>_p` and through
    the reference shell on `<table>_r`: -> the port's masked lines,
    after asserting the reference printed the same."""
    from pegasus_tpu.shell.main import Shell as RefShell

    got = _mask(_run(Shell, cluster.meta_addr,
                     [ln.format(t=table + "_p") for ln in lines]),
                table + "_p")
    want = _mask(_run(RefShell, cluster.meta_addr,
                      [ln.format(t=table + "_r") for ln in lines]),
                 table + "_r")
    assert got == want
    return got


def test_shell_ddl_and_data_ops(cluster, monkeypatch):
    # the TTL clock frozen in both packages: `ttl` prints the seconds
    # left, which would otherwise differ by one where either shell's set
    # and ttl straddle a second
    import time

    import pegasus_tpu.base.utils as ref_utils
    import pegasus_tpu_torch.base.utils as port_utils

    now = time.time()
    for mod in (port_utils, ref_utils):
        monkeypatch.setattr(mod, "time", _FrozenTime(mod.time, now))
    out = "\n".join(both(cluster, [
        "create {t} -p 4 -r 3", "use {t}", "app {t}",
        'set user1 sk1 "hello world"', "get user1 sk1", "exist user1 sk1",
        "ttl user1 sk1", "set user1 sk2 v 3600", "ttl user1 sk2",
        "incr user1 counter 5", "incr user1 counter",
        "multi_set mh a 1 b 2 c 3", "multi_get mh", "multi_get mh a c",
        "sortkey_count mh", "count mh", "hash_scan mh", "hash_scan mh b",
        "multi_del mh a b", "del user1 sk1", "get user1 sk1",
        "check_and_set user1 counter VALUE_EXIST x cas1 casval",
        "get user1 cas1",
        "check_and_mutate user1 cas1 VALUE_BYTES_EQUAL casval set m1 v1 "
        "del cas1", "get user1 m1", "get user1 cas1",
        "hash user1 sk1", "timeout 2500", "nosuchcommand", "get onlyone",
    ], "ddl"))
    assert "succeed" in out and '"hello world"' in out
    assert "no ttl" in out and '"a" : "1"' in out and "not found" in out
    assert "3600 seconds" in out
    assert "set_succeed: true" in out and "mutate_succeed: true" in out
    assert "partition:" in out and "2500 ms" in out
    assert "unknown command" in out and "usage: get" in out


def test_shell_cluster_admin(cluster):
    out = "\n".join(both(cluster, [
        "cluster_info", "nodes", "server_info", "get_meta_level",
        "set_meta_level nonsense", "get_meta_level",
    ], "adm"))
    assert "node_count" in out and "ALIVE" in out
    assert "pegasus-tpu" in out and "meta level: lively" in out
    # decaying qps rates: the port's own lines, one per node
    stat = _run(Shell, cluster.meta_addr, ["server_stat"])
    assert len(stat) == 6 and all("qps=" in ln or "no stats" in ln
                                  for ln in stat[1::2])
    # the version line names each shell's own package; the nodes' lines
    # are the same
    from pegasus_tpu.shell.main import Shell as RefShell

    got = _mask(_run(Shell, cluster.meta_addr, ["version"]), "")
    want = _mask(_run(RefShell, cluster.meta_addr, ["version"]), "")
    assert got[0] == "pegasus-tpu-torch 2.0" and got[1:] == want[1:]


def test_shell_full_scan_and_copy(cluster):
    lines = ["create {t} -p 2", "create {t}dst -p 2", "use {t}"]
    lines += [f"set h{i} s v{i}" for i in range(6)]
    lines += ["count_data", "copy_data {t}dst", "use {t}dst", "get h3 s",
              "full_scan", "full_scan 2"]
    out = "\n".join(both(cluster, lines, "cp"))
    assert "6 rows" in out and "copied 6 rows" in out and '"v3"' in out


def test_shell_envs_and_manual_compact(cluster):
    out = "\n".join(both(cluster, [
        "create {t} -p 2", "use {t}", "set k s v",
        "set_app_envs rocksdb.usage_scenario prefer_write", "get_app_envs",
        "set_app_envs default_ttl 99", "del_app_envs default_ttl",
        "clear_app_envs", "get_app_envs", "clear_app_envs",
        "manual_compact",
    ], "env"))
    assert "set 1 envs OK" in out and "prefer_write" in out
    assert "manual compact triggered" in out and "no envs set" in out
    sh_out = "\n".join(_run(Shell, cluster.meta_addr,
                            ["query_compact_state"]))
    assert "idle" in sh_out or "running" in sh_out


def test_shell_remote_and_counters(cluster):
    node = sorted(cluster.nodes)[0]
    out = "\n".join(both(cluster, [
        "create {t} -p 2", "use {t}", "set hot s v",
        f"remote_command {node} server-info", "remote_command all help",
    ], "rc"))
    assert "server-info" in out
    got = "\n".join(_run(Shell, cluster.meta_addr, [
        f"flush_log {node}", f"perf_counters {node} app.",
        "remote_command all describe",
        "app_disk", "batched_manual_compact all"]))
    assert "flushed" in got and "replicas" in got and "total " in got
    assert "partitions" in got


def test_shell_admin_utilities(cluster):
    """The admin sweep of the reference's shell tests that the port
    serves: sortkeys, range reads and deletes, meta levels, clear_data."""
    lines = ["create {t} -p 2", "use {t}"]
    lines += [f"set uh sk{i:02d} v{i}" for i in range(12)]
    lines += ["set other s x", "multi_get_sortkeys uh",
              "multi_get_range uh sk03 sk06", "multi_del_range uh sk03 sk06",
              "get uh sk04", "get uh sk07", "set_meta_level freezed",
              "get_meta_level", "set_meta_level lively", "clear_data {t}",
              "clear_data {t} yes", "get uh sk07", "get other s"]
    out = "\n".join(both(cluster, lines, "ut"))
    assert "12 sortkeys" in out and "3 rows" in out
    assert "deleted 3 rows" in out and "meta level: freezed" in out
    assert "refusing" in out and "cleared 10 rows" in out


def test_shell_backup_restore_policy_and_bulk_load(cluster, tmp_path):
    from pegasus_tpu_torch.base import key_schema
    from pegasus_tpu_torch.engine import bulk_load as bl

    for suffix in ("_p", "_r"):
        app = "ops" + suffix + "bl"
        pdir = tmp_path / "prov" / app / "2"
        rows = {0: [], 1: []}
        for i in range(10):
            hk = b"b%d" % i
            h = key_schema.key_hash(key_schema.generate_key(hk, b"s"))
            rows[h % 2].append((hk, b"s", b"v%d" % i, 0))
        for p, r in rows.items():
            (pdir / str(p)).mkdir(parents=True)
            bl.write_raw_set(str(pdir / str(p) / "x.raw"), r)
        bl.write_metadata(str(tmp_path / "prov"), app, 2)
    root = tmp_path / "bk"
    lines = [
        "create {t} -p 2", "use {t}", "set a s 1",
        f"backup_app {{t}} {root}", "backup_app nosuch /x",
        f"add_backup_policy {{t}}pol {root} {{t}} 60 2",
        "ls_backup_policy {t}pol", "disable_backup_policy {t}pol",
        "modify_backup_policy {t}pol -i 7 -c 5 --add {t} --remove {t}",
        "enable_backup_policy {t}pol", "ls_backup_policy {t}pol",
        "ls_backup_policy nosuchpolicy", "query_backup_policy {t}pol",
        "query_restore_status {t}new", "restore_app /nope 1 {t} {t}x",
        "create {t}bl -p 2",
        f"start_bulk_load {{t}}bl {tmp_path / 'prov'}",
        "query_bulk_load_status {t}bl", "pause_bulk_load {t}bl",
        "restart_bulk_load {t}bl", "cancel_bulk_load {t}bl",
        f"start_bulk_load {{t}} {tmp_path / 'prov'}",
        "query_bulk_load_status nosuch", "use {t}bl", "get b3 s",
    ]
    out = "\n".join(both(cluster, lines, "ops"))
    assert "backup succeed, backup_id=N" in out
    assert "backup failed: no such app" in out
    assert "name=Tpol enabled=True interval=7s history=5" in out
    assert "bulk load succeed, ingested 10 records" in out
    assert "bulk load of Tbl: succeed, 2/2 partitions, 10 records" in out
    assert "pause failed: cannot pause (succeed)" in out
    assert "bulk load failed: no bulk_load_metadata" in out
    assert '"v3"' in out and "no restore recorded for Tnew" in out
    # a restore of the port shell's backup, followed to ok
    bid = sorted(os.listdir(root))[0]
    got = "\n".join(_run(Shell, cluster.meta_addr, [
        f"restore_app {root} {bid} ops_p ops_p_new",
        "query_restore_status ops_p_new", "use ops_p_new", "get a s"]))
    assert "restore succeed" in got and ": ok, from ops_p@" in got
    assert "2/2 partitions" in got and '"1"' in got


def test_shell_audit(cluster):
    sh_out = _run(Shell, cluster.meta_addr, [
        "create aud -p 2", "use aud", "set k s v", "trigger_audit aud"])
    assert sh_out[-1] == ("audit OK: 2 partition(s), all replicas "
                          "identical at identical decrees")


def test_offline_debuggers(tmp_path):
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import SCHEMAS
    from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
    from pegasus_tpu_torch.replication.mutation_log import (LogMutation,
                                                            MutationLog)

    from pegasus_tpu.shell.main import Shell as RefShell

    eng = LsmEngine(str(tmp_path / "ldb"), EngineOptions(backend="cpu"))
    for i in range(5):
        eng.put(generate_key(b"oh", b"s%d" % i),
                SCHEMAS[2].generate_value(0, 0, b"val%d" % i))
    eng.delete(generate_key(b"oh", b"s9"))
    eng.flush()
    sst = eng._l0[0].path
    eng.close()
    log = MutationLog(str(tmp_path / "plog"))
    log.append(LogMutation(decree=1, codes=["RPC_RRDB_RRDB_PUT"],
                           bodies=[b"x"]))
    log.close()
    key_hex = generate_key(b"h\x01", b"s").hex()
    lines = [f"sst_dump {sst}", f"sst_dump {sst} 2",
             f'local_get {tmp_path / "ldb"} oh s2',
             f'local_get {tmp_path / "ldb"} oh nope',
             f'mlog_dump {tmp_path / "plog"}', f"mlog_dump {tmp_path}",
             "rdb_key_str2hex hk sk", f"rdb_key_hex2str {key_hex}",
             "rdb_key_hex2str zz", "rdb_value_hex2str 0000000061",
             "escape_all true", f"rdb_key_hex2str {key_hex}",
             "escape_all"]
    got = _run(Shell, "127.0.0.1:1", lines)
    assert got == _run(RefShell, "127.0.0.1:1", lines)
    text = "\n".join(got)
    assert "records=6" in text and '"val2"' in text
    assert "decree=1" in text and "not found" in text


# the 12 verbs of the duplication and admin planes: each script runs on
# its own twin tables (`{t}`), its lines given as strings or as
# fn(cluster, table) -> line, evaluated when the line runs
def _app_id(c, t):
    return c.meta._apps[t].app_id


def _dupid(c, t):
    return c.meta._dups[_app_id(c, t)][-1]["dupid"]


def _dropped_id(c, t):
    return next(aid for aid, e in c.meta._dropped.items()
                if e["app"]["app_name"] == t)


def _secondary(c, t):
    return c.meta._parts[_app_id(c, t)][0].secondaries[0]


_DUP = ["create {t} -p 2", "add_dup {t} west -f"]
VERBS = {
    "add_dup": ["create {t} -p 2", "add_dup {t} west -f",
                "add_dup {t} west", "add_dup nosuch west", "add_dup {t}",
                "query_dup {t}"],
    "query_dup": ["create {t} -p 2", "query_dup {t}", "add_dup {t} west",
                  "query_dup {t}", "query_dup nosuch", "query_dup"],
    "start_dup": _DUP + [lambda c, t: f"start_dup {t} {_dupid(c, t)}",
                         "start_dup {t} 999", "start_dup nosuch 1",
                         "query_dup {t}"],
    "pause_dup": _DUP + [lambda c, t: f"pause_dup {t} {_dupid(c, t)}",
                         "pause_dup {t} 999", "pause_dup {t}",
                         "query_dup {t}"],
    "remove_dup": _DUP + [lambda c, t: f"remove_dup {t} {_dupid(c, t)}",
                          "remove_dup {t} 1000", "query_dup {t}"],
    "set_dup_fail_mode": _DUP + [
        lambda c, t: f"set_dup_fail_mode {t} {_dupid(c, t)} skip",
        lambda c, t: f"set_dup_fail_mode {t} {_dupid(c, t)} loud",
        "set_dup_fail_mode {t} 999 slow", "query_dup {t}"],
    "cross_cluster_audit": ["create {t} -p 2", "use {t}", "set k s v",
                            "cross_cluster_audit {t} 127.0.0.1:1",
                            "cross_cluster_audit nosuch 127.0.0.1:1",
                            "cross_cluster_audit {t}"],
    "propose": ["create {t} -p 2", "use {t}",
                lambda c, t: f"propose 0 {_secondary(c, t)}",
                "propose 0 127.0.0.1:1", "propose 9 127.0.0.1:1",
                "propose 0"],
    "balance": ["set_meta_level freezed", "balance", "set_meta_level lively",
                "balance"],
    "recover": ["recover 127.0.0.1:1",
                lambda c, t: "recover " + " ".join(sorted(c.nodes))],
    "ddd_diagnose": ["create {t} -p 2", "ddd_diagnose {t}",
                     "ddd_diagnose nosuch -f", "ddd_diagnose {t} -f"],
    "recall": ["create {t} -p 2", "use {t}", "set k s v", "drop {t} -r 3600",
               lambda c, t: f"recall {_dropped_id(c, t)} {t}2",
               lambda c, t: f"recall {_app_id(c, t + '2')}",
               "use {t}2", "get k s", "recall 99999", "recall x"],
}


def _mask_verbs(lines, table) -> list:
    out = []
    for line in _mask(lines, table):
        line = re.sub(r"(recall app |dupid[=:] ?|\(dupid |appid: |duplication\()\d+",
                      r"\1N", line)
        line = re.sub(r"create_time=[\d: -]+", "create_time=T", line)
        line = re.sub(r"id \d+ \[or hold", "id N [or hold", line)
        out.append(line)
    return out


def _run_script(shell_cls, cluster, meta, script, t) -> list:
    out = io.StringIO()
    sh = shell_cls([meta], out=out)
    try:
        for line in script:
            sh.run_line(line(cluster, t) if callable(line)
                        else line.format(t=t))
    finally:
        sh.pool.close()
    return _mask_verbs(out.getvalue().splitlines(), t)


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_admin_and_dup_verbs_print_the_reference_lines(cluster, verb,
                                                       tmp_path):
    """Each verb of the duplication and admin planes, through the port's
    shell on one table and the reference shell on its twin, prints the
    same lines (ids, addresses and times masked) against equal clusters;
    none answers NotPorted. `balance` runs on a settled cluster, and
    `recover` on a cluster of its own, each shell asking an empty meta of
    its own."""
    from pegasus_tpu.shell.main import Shell as RefShell
    from pegasus_tpu_torch.meta import MetaServer
    from pegasus_tpu_torch.meta import messages as mm
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc.transport import RpcServer

    assert not NOT_PORTED
    script = VERBS[verb]
    c, metas, servers = cluster, {}, []
    if verb == "balance":
        cluster.meta._on_balance(None, codec.encode(mm.BalanceRequest()))
    if verb == "recover":
        from tests.test_torch_cluster import make_client

        c = Cluster(tmp_path / "own")
        make_client(c, "rc", partitions=2).close()
        for k in ("p", "r"):
            m = MetaServer(str(tmp_path / f"meta_{k}" / "state.json"))
            srv = RpcServer().start()
            for code, fn in m.rpc_handlers().items():
                srv.register(code, fn)
            servers.append(srv)
            metas[k] = f"{srv.address[0]}:{srv.address[1]}"
    try:
        table = verb[:8]
        got = _run_script(Shell, c, metas.get("p", c.meta_addr), script,
                          table + "_p")
        want = _run_script(RefShell, c, metas.get("r", c.meta_addr), script,
                           table + "_r")
    finally:
        for srv in servers:
            srv.stop()
        if c is not cluster:
            c.stop()
    assert got == want
    text = "\n".join(got)
    assert "not ported" not in text
    expect = {
        "add_dup": "adding duplication succeed [app: T, remote: west, "
                   "appid: N, dupid: N, freeze: true]",
        "query_dup": "  dupid=N status=start remote=west fail_mode=slow "
                     "create_time=T",
        "start_dup": "starting duplication(N) succeed",
        "pause_dup": "pausing duplication(N) succeed",
        "remove_dup": "removing duplication(N) succeed",
        "set_dup_fail_mode": 'fail_mode must be "slow" or "skip"',
        "cross_cluster_audit": "cross-cluster audit inconclusive: no "
                               "active duplication on 'T' (dupid=any)",
        "propose": "OK",
        "balance": "moved 0 primaries",
        "recover": "recovered apps: ['rc']",
        "ddd_diagnose": "no double-dead partitions",
        "recall": "recall app N succeed, name=T2",
    }[verb]
    assert expect in got, got


def _py(args, **kw):
    return subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                          text=True, timeout=120, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), **kw)


def test_one_shot_shell_and_exit_codes(cluster):
    r = _py(["pegasus_tpu_torch.shell", "--meta", cluster.meta_addr, "--",
             "create", "oneshot", "-p", "2"])
    assert r.returncode == 0
    assert r.stdout.startswith("create app oneshot succeed, id=")
    # an app that was never dropped: the reference one-shot's answer and
    # exit code
    r = _py(["pegasus_tpu_torch.shell", "--meta", cluster.meta_addr,
             "recall", "1"])
    want = _py(["pegasus_tpu.shell", "--meta", cluster.meta_addr,
                "recall", "1"])
    assert r.returncode == want.returncode == 0
    assert "Traceback" not in r.stderr
    assert r.stdout == want.stdout == (
        "recall app 1 failed, error=no dropped app with id 1 "
        "[or hold expired]\n")


def test_sample_prints_the_reference_lines(cluster):
    from tests.test_torch_cluster import make_client

    for t in ("sample_p", "sample_r"):
        make_client(cluster, t, partitions=2).close()
    got = _py(["pegasus_tpu_torch.sample", cluster.meta_addr, "sample_p"])
    want = _py(["pegasus_tpu.sample", cluster.meta_addr, "sample_r"])
    assert got.returncode == 0 and want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert "get(pegasus, cloud) -> b'engine'" in got.stdout
