"""The cluster doctor and its audit (pegasus_tpu_torch.collector)
against pegasus_tpu's, in one process.

- The port meta's cluster-state snapshot equals the reference meta's for
  the same state file and the same beacons.
- The doctor's folds (nodes, partitions, lag, audit, quarantine) and the
  audit's table digest fold give equal results on seeded inputs, and the
  slow-request rollup merges worst first in both packages.
- On the port's in-process cluster (tests/test_torch_cluster.py's
  Cluster), the port's and the reference's audit and doctor agree:
  healthy, with a node killed, and with one secondary's digest corrupted
  by the `audit.digest` fail point; the reference's doctor reads the
  port's meta and the port's doctor reads the reference's.
- The shell's trigger_audit and cluster_doctor print the reference
  shell's lines.

Both doctors also feed their verdicts to the flight recorder and
auto-heal (tests/test_torch_heal.py holds those to each other): the
hooks of both packages are stubbed out here, and only `verdict` and
`causes` are compared.
"""

import io
import json
import re
import threading
import time

import numpy as np
import pytest

from pegasus_tpu.collector import cluster_doctor as ref_cd
from pegasus_tpu.collector import info_collector as ref_ic
from pegasus_tpu.meta import messages as ref_mm
from pegasus_tpu.meta import meta_server as ref_meta
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu_torch.collector import cluster_doctor as port_cd
from pegasus_tpu_torch.collector import info_collector as port_ic
from pegasus_tpu_torch.meta import messages as port_mm
from pegasus_tpu_torch.meta import meta_server as port_meta
from pegasus_tpu_torch.rpc import codec as port_codec
from pegasus_tpu_torch.runtime import fail_points as port_fp
from tests.test_torch_cluster import Cluster, make_client

NODES = ["127.0.0.1:11", "127.0.0.1:12", "127.0.0.1:13", "127.0.0.1:14"]
CHECKS = ("_check_nodes", "_check_partitions", "_check_lag",
          "_check_audit", "_check_quarantine")


@pytest.fixture(autouse=True)
def _reference_hooks(monkeypatch):
    """The flight recorder's and the auto-healer's doctor hooks are
    stubbed in both packages (tests/test_torch_heal.py holds them to each
    other), and both packages' SLO verdicts cleared (other tests in the
    process may have left some)."""
    from pegasus_tpu.collector import auto_heal, flight_recorder
    from pegasus_tpu_torch.collector import auto_heal as port_heal
    from pegasus_tpu_torch.collector import flight_recorder as port_fr

    for mod in (flight_recorder, port_fr):
        monkeypatch.setattr(mod.RECORDER, "observe_verdict",
                            lambda *a, **k: None)
    for mod in (auto_heal, port_heal):
        monkeypatch.setattr(mod.AUTO_HEALER, "observe_verdict",
                            lambda *a, **k: None)
    ref_ic.reset_slo()
    port_ic.reset_slo()


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# ---------------------------------------------------------- the snapshot


def _beacon(node, rng, gpids):
    """One beacon's replica states: lag, audit and compaction debt per
    hosted gpid, and a tenant-ledger fragment the meta must divert."""
    states = []
    for g in gpids:
        c = int(rng.integers(10, 99))
        st = {"gpid": g, "status": "SECONDARY", "ballot": 3,
              "committed": c, "applied": c - int(rng.integers(0, 3)),
              "prepared": c + int(rng.integers(0, 3)),
              "compact": {"l0_files": int(rng.integers(0, 9)),
                          "debt_bytes": int(rng.integers(0, 1 << 20)),
                          "pending_installs": 0, "ceiling_files": 12}}
        if rng.random() < 0.5:
            st["audit"] = {"audit_id": 7, "decree": c,
                           "digest": f"{int(rng.integers(1 << 62)):032x}"}
        states.append(json.dumps(st))
    states.append(json.dumps({"gpid": "tables@pid:1", "status": "TABLE_STATS",
                              "tables": {}}))
    return (node, gpids, states)


def _snapshot(meta, codec, mm) -> dict:
    out = json.loads(codec.decode(mm.QueryClusterStateResponse,
                                  meta._on_query_cluster_state(
                                      None, b"")).state_json)
    for n in out["nodes"].values():
        assert n["last_beacon_ago_s"] >= 0
        n.pop("last_beacon_ago_s")
    return out


def test_cluster_state_snapshot_equals_the_reference_meta(tmp_path):
    """Both metas load one state file (written by the reference's
    handlers: nodes, two apps) and take the same beacons; their
    snapshots are equal, the beacons' age apart, with no tenant-ledger
    fragment among the replica states."""
    path = str(tmp_path / "meta" / "state.json")
    ref = ref_meta.MetaServer(path)
    for n in NODES[:3]:
        ref._on_beacon(None, ref_codec.encode(ref_mm.BeaconRequest(node=n)))
    for name, n in (("t1", 4), ("t2", 2)):
        r = ref_codec.decode(ref_mm.CreateAppResponse, ref._on_create_app(
            None, ref_codec.encode(ref_mm.CreateAppRequest(name, n, 3))))
        assert r.error == 0
    ref._persist()
    port = port_meta.MetaServer(path)
    rng = np.random.default_rng(11)
    gpids = [f"{a}.{p}" for a, n in ((1, 4), (2, 2)) for p in range(n)]
    beacons = [_beacon(n, rng, gpids) for n in NODES[:3]]
    for node, alive, states in beacons:
        for meta, codec, mm in ((ref, ref_codec, ref_mm),
                                (port, port_codec, port_mm)):
            meta._on_beacon(None, codec.encode(mm.BeaconRequest(
                node=node, alive_replicas=alive, replica_states=states)))
    want = _snapshot(ref, ref_codec, ref_mm)
    got = _snapshot(port, port_codec, port_mm)
    assert _dumps(got) == _dumps(want)
    assert set(got["apps"]) == {"t1", "t2"} and got["dups"] == {}
    assert all("@" not in g for st in got["replica_states"].values()
               for g in st)
    assert got["replica_states"][NODES[0]]["1.0"]["compact"]["ceiling_files"] \
        == 12


# ------------------------------------------------------------ pure folds


def _random_state(rng) -> dict:
    """A cluster-state snapshot: some nodes dead, partitions with and
    without primaries, lagging, audited (some digests disagreeing) and
    quarantined replicas."""
    nodes = {a: {"alive": bool(rng.random() < 0.75),
                 "last_beacon_ago_s": float(rng.integers(0, 90))}
             for a in NODES}
    apps, states = {}, {a: {} for a in NODES}
    for app_id, name in ((1, "t1"), (2, "t2")):
        parts = []
        for p in range(int(rng.integers(1, 6))):
            members = list(rng.permutation(NODES)[:3])
            primary = members[0] if rng.random() < 0.85 else ""
            parts.append({"pidx": p, "ballot": 2, "primary": primary,
                          "secondaries": members[1:3]})
            decree = int(rng.integers(50, 60))
            for m in members:
                c = int(rng.integers(0, 400))
                st = {"gpid": f"{app_id}.{p}", "status": "SECONDARY",
                      "prepared": c + int(rng.integers(0, 40)),
                      "committed": c,
                      "applied": c - int(rng.integers(0, 40))}
                if rng.random() < 0.7:
                    st["audit"] = {
                        "decree": decree - int(rng.random() < 0.2),
                        "digest": "" if rng.random() < 0.1 else
                        f"d{int(rng.integers(0, 2 if rng.random() < 0.6 else 1))}"}
                if rng.random() < 0.1:
                    st["status"] = "QUARANTINED"
                    st["quarantine"] = {"reason": "crc", "source": "scrub",
                                        "dir": f"/q/{app_id}.{p}"}
                states[m][f"{app_id}.{p}"] = st
        apps[name] = {"app_id": app_id, "partition_count": len(parts),
                      "replica_count": 3, "partitions": parts}
    return {"nodes": nodes, "apps": apps, "replica_states": states,
            "dups": {}, "meta_level": "lively"}


@pytest.mark.parametrize("seed", range(6))
def test_doctor_folds_equal_the_reference(seed, monkeypatch):
    monkeypatch.setenv("PEGASUS_DOCTOR_GAP_DEGRADED", "25")
    state = _random_state(np.random.default_rng(seed))
    for check in CHECKS:
        out = []
        for mod in (ref_cd, port_cd):
            causes, evidence = [], {}
            getattr(mod, check)(json.loads(json.dumps(state)), causes,
                                evidence)
            out.append(_dumps([causes, evidence]))
        assert out[0] == out[1], check


def test_doctor_lag_fold_flags_commit_and_apply_distinctly(monkeypatch):
    """The reference's named case: commit lag and apply lag are distinct
    degraded causes, measured within each replica's own snapshot."""
    monkeypatch.setenv("PEGASUS_DOCTOR_GAP_DEGRADED", "10")
    state = {"replica_states": {
        "n1:1": {"1.0": {"gpid": "1.0", "status": "PRIMARY",
                         "prepared": 500, "committed": 500,
                         "applied": 500}},
        "n2:1": {"1.0": {"gpid": "1.0", "status": "SECONDARY",
                         "prepared": 500, "committed": 480,
                         "applied": 480}},
        "n3:1": {"1.0": {"gpid": "1.0", "status": "SECONDARY",
                         "prepared": 500, "committed": 500,
                         "applied": 420}},
    }}
    causes, evidence = [], {}
    port_cd._check_lag(state, causes, evidence)
    kinds = {(o["node"], o["kind"]) for o in evidence["lag"]["offenders"]}
    assert kinds == {("n2:1", "commit"), ("n3:1", "apply")}
    assert any("behind on COMMIT by 20" in c["cause"] and "n2:1" in c["cause"]
               for c in causes)
    assert any("behind on APPLY by 80" in c["cause"] and "n3:1" in c["cause"]
               for c in causes)
    assert evidence["lag"]["worst"] == {"commit_gap": 20, "apply_gap": 80}


@pytest.mark.parametrize("seed", range(4))
def test_fold_table_digest_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    entries = [(f"{int(rng.integers(1 << 63)):016x}"
                f"{int(rng.integers(1 << 63)):016x}",
                int(rng.integers(0, 10_000)))
               for _ in range(int(rng.integers(1, 40)))]
    got = port_cd.fold_table_digest(entries)
    assert _dumps(got) == _dumps(ref_cd.fold_table_digest(entries))
    # the fold is over the record SET: any order, any grouping
    perm = [entries[i] for i in rng.permutation(len(entries))]
    assert port_cd.fold_table_digest(perm) == got


@pytest.mark.parametrize("seed", range(4))
def test_rollup_slow_requests_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    ledgers = {f"n{i}": [{"trace_id": f"t{i}.{j}",
                          "duration_us": int(rng.integers(0, 5000)),
                          "op": "put"}
                         for j in range(int(rng.integers(0, 6)))]
               for i in range(5)}
    ledgers["n5"] = "not json"
    ledgers["n6"] = {"not": "a list"}

    def fetch(node):
        v = ledgers[node]
        return v if isinstance(v, str) else json.dumps(v)

    for last in (1, 4, 50):
        got = port_ic.rollup_slow_requests(fetch, sorted(ledgers), last=last)
        want = ref_ic.rollup_slow_requests(fetch, sorted(ledgers), last=last)
        assert _dumps(got) == _dumps(want)
        assert len(got) <= last
        assert all(got[i]["duration_us"] >= got[i + 1]["duration_us"]
                   for i in range(len(got) - 1))


def test_slow_request_rollup_merges_worst_first():
    def fetch(node):
        base = {"n1": [{"trace_id": "a", "duration_us": 100, "op": "put"},
                       {"trace_id": "b", "duration_us": 900, "op": "get"}],
                "n2": [{"trace_id": "c", "duration_us": 500, "op": "put"}],
                "n3": "not json"}
        v = base[node]
        return v if isinstance(v, str) else json.dumps(v)

    merged = port_ic.rollup_slow_requests(fetch, ["n1", "n2", "n3"], last=2)
    assert [t["trace_id"] for t in merged] == ["b", "c"]
    assert merged[0]["node"] == "n1" and merged[1]["node"] == "n2"
    assert port_ic.latest_slo() == {}


# ------------------------------------------------------- on a live cluster


def _members(cluster, app_id, pidx):
    pc = cluster.meta._parts[app_id][pidx]
    return pc.primary, list(pc.secondaries)


def _verdicts(meta_addr) -> tuple:
    """(port doctor, reference doctor) against one meta."""
    return (port_cd.run_cluster_doctor([meta_addr]),
            ref_cd.run_cluster_doctor([meta_addr]))


def _causes(verdict) -> list:
    # a dead node's beacon age is read by each doctor at its own instant
    return [re.sub(r"last beacon \d+s ago", "last beacon Ns ago", c["cause"])
            for c in verdict["causes"]]


def _agree(meta_addr) -> dict:
    port, ref = _verdicts(meta_addr)
    assert port["verdict"] == ref["verdict"]
    assert _causes(port) == _causes(ref)
    assert "incident" not in port and "autoheal" not in port
    return port


@pytest.mark.parametrize("meta", ["port", "reference"])
def test_audit_and_doctor_agree_on_a_healthy_cluster(tmp_path, meta):
    """Port nodes behind either package's meta: both audits find every
    replica equal at an equal decree, and both doctors read `healthy`
    from the meta's snapshot."""
    c = Cluster(tmp_path, ref_meta=(meta == "reference"))
    try:
        cli = make_client(c, "aud", partitions=4)
        for i in range(40):
            cli.set(b"k%03d" % i, b"s", b"v%d" % i)
        reports = [mod.run_cluster_audit([c.meta_addr], wait_s=20.0)
                   for mod in (port_cd, ref_cd)]
        for rep in reports:
            assert rep["mismatches"] == [] and rep["inconclusive"] == []
            assert rep["partitions"] == 4 and len(rep["ok"]) == 4
            for gpid, per_node in rep["digests"].items():
                assert len(per_node) == 3
                assert len({(d["decree"], d["digest"])
                            for d in per_node.values()}) == 1
        # the same data: the same digests (at decrees one audit apart);
        # the port audits partitions at once, the report in walk order
        assert {g: p["digest"] for g, p in reports[0]["primaries"].items()} \
            == {g: p["digest"] for g, p in reports[1]["primaries"].items()}
        assert reports[0]["ok"] == reports[1]["ok"]
        assert list(reports[0]["digests"]) == list(reports[1]["digests"])
        time.sleep(0.6)  # the beacons fold the audit states into the meta
        verdict = _agree(c.meta_addr)
        assert verdict["verdict"] == "healthy", verdict["causes"]
        assert verdict["evidence"]["audit"]["mismatches"] == []
        assert len(verdict["evidence"]["audit"]["checked"]) == 4
        cli.close()
    finally:
        c.stop()


def test_corrupt_secondary_flags_exactly_that_partition(tmp_path):
    """`audit.digest` armed for ONE secondary of ONE partition: the
    audit names exactly (app, pidx, node) and both doctors go critical
    naming it; the other partition stays clean."""
    c = Cluster(tmp_path)
    port_fp.setup()
    try:
        cli = make_client(c, "audchaos", partitions=2)
        for i in range(40):
            cli.set(b"k%03d" % i, b"s", b"v%d" % i)
        app_id = cli.resolver.app_id
        _, secondaries = _members(c, app_id, 0)
        victim = secondaries[0]
        port_fp.cfg("audit.digest", f"return({victim}@{app_id}.0)")
        report = port_cd.run_cluster_audit([c.meta_addr], wait_s=20.0)
        assert len(report["mismatches"]) == 1
        m = report["mismatches"][0]
        assert (m["app"], m["pidx"], m["node"]) == ("audchaos", 0, victim)
        assert m["digest"].startswith("deadbeef")
        assert f"{app_id}.1" in report["ok"]
        time.sleep(0.6)  # the corrupted digest rides the next beacons
        verdict = _agree(c.meta_addr)
        assert verdict["verdict"] == "critical"
        crit = [x for x in verdict["causes"] if x["severity"] == "critical"]
        assert any(f"{app_id}.0" in x["cause"] and victim in x["cause"]
                   for x in crit), crit
        assert [(e["gpid"], e["node"]) for e in
                verdict["evidence"]["audit"]["mismatches"]] == \
            [(f"{app_id}.0", victim)]
        cli.close()
    finally:
        port_fp.teardown()
        c.stop()


def test_killed_node_is_named_by_both_doctors(tmp_path):
    c = Cluster(tmp_path)
    try:
        cli = make_client(c, "kill", partitions=2)
        for i in range(20):
            cli.set(b"k%03d" % i, b"s", b"v")
        victim = c.meta._parts[cli.resolver.app_id][0].primary
        c.kill_node(victim)
        verdict = _agree(c.meta_addr)
        assert verdict["verdict"] == "degraded"
        assert verdict["evidence"]["nodes"]["dead"] == [victim]
        assert any(victim in x for x in _causes(verdict))
        assert len(verdict["evidence"]["partitions"]["under_replicated"]) \
            == 2
        cli.close()
    finally:
        c.stop()


def test_midaudit_node_kill_is_inconclusive_not_mismatch(tmp_path):
    c = Cluster(tmp_path)
    try:
        cli = make_client(c, "audkill", partitions=2)
        for i in range(30):
            cli.set(b"k%03d" % i, b"s", b"v%d" % i)
        app_id = cli.resolver.app_id
        primary, secondaries = _members(c, app_id, 0)
        victim = secondaries[0]
        caller = port_cd.ClusterCaller([c.meta_addr])
        out = json.loads(caller.remote_command(primary, "trigger-audit",
                                               [f"{app_id}.0"]))
        caller.close()
        assert out["digest"] and out["decree"] > 0
        c.nodes.pop(victim).stop()  # dead, and the meta not yet told
        report = port_cd.run_cluster_audit([c.meta_addr], wait_s=1.0)
        assert report["mismatches"] == []
        assert any(e.get("node") == victim for e in report["inconclusive"])
        verdict = port_cd.run_cluster_doctor([c.meta_addr])
        assert verdict["evidence"]["audit"]["mismatches"] == []
        cli.close()
    finally:
        c.stop()


def test_audit_under_load_zero_mismatches(tmp_path):
    c = Cluster(tmp_path)
    stop, errors, ops = threading.Event(), [], [0]
    try:
        cli = make_client(c, "ycsbish", partitions=4)
        for i in range(64):
            cli.set(b"user%05d" % i, b"f0", b"init%d" % i)

        def worker(tid):
            i = 0
            while not stop.is_set():
                k = b"user%05d" % ((i * 7 + tid * 13) % 64)
                try:
                    if i % 2:
                        cli.get(k, b"f0")
                    else:
                        cli.set(k, b"f0", b"v%d.%d" % (tid, i))
                    ops[0] += 1
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(repr(e))
                i += 1

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        report = port_cd.run_cluster_audit([c.meta_addr], wait_s=20.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert report["mismatches"] == [] and report["inconclusive"] == []
        assert sorted(report["ok"]) == sorted(report["digests"])
        assert report["partitions"] == 4
        assert ops[0] > 0 and not errors
        cli.close()
    finally:
        stop.set()
        c.stop()


def _shell_lines(shell_cls, meta_addr, line) -> list:
    out = io.StringIO()
    sh = shell_cls([meta_addr], out=out)
    try:
        sh.run_line(line)
    finally:
        sh.pool.close()
    return out.getvalue().splitlines()


def test_shell_audit_and_doctor_print_the_reference_lines(tmp_path):
    from pegasus_tpu.shell.main import Shell as RefShell
    from pegasus_tpu_torch.shell.main import NOT_PORTED, Shell

    assert "cluster_doctor" not in NOT_PORTED
    c = Cluster(tmp_path)
    try:
        cli = make_client(c, "shaud", partitions=2)
        for i in range(20):
            cli.set(b"k%03d" % i, b"s", b"v")
        port = _shell_lines(Shell, c.meta_addr, "trigger_audit shaud")
        ref = _shell_lines(RefShell, c.meta_addr, "trigger_audit shaud")
        assert port[-1] == ref[-1] == ("audit OK: 2 partition(s), all "
                                       "replicas identical at identical "
                                       "decrees")
        # the report above the verdict line: the same keys and partitions
        p_rep = json.loads("\n".join(port[:-1]))
        r_rep = json.loads("\n".join(ref[:-1]))
        assert sorted(p_rep) == sorted(r_rep)
        assert p_rep["ok"] == r_rep["ok"] and p_rep["partitions"] == 2
        time.sleep(0.6)
        port = _shell_lines(Shell, c.meta_addr, "cluster_doctor 5")
        ref = _shell_lines(RefShell, c.meta_addr, "cluster_doctor 5")
        assert port[-1] == ref[-1] == "cluster verdict: HEALTHY"
        assert json.loads("\n".join(port[:-1]))["verdict"] == "healthy"
        cli.close()
    finally:
        c.stop()


def test_audit_rounds_book_a_conclusive_final_round(tmp_path):
    c = Cluster(tmp_path)
    try:
        cli = make_client(c, "rounds", partitions=2)
        for i in range(20):
            cli.set(b"k%03d" % i, b"s", b"v")
        rounds = port_cd.AuditRounds([c.meta_addr], every_s=60.0,
                                     wait_s=20.0).start()
        summary = rounds.stop(final_round=True)
        assert summary == {"rounds": 1, "conclusive": 1, "vacuous": 0,
                           "mismatches": []}
        assert rounds.rounds[0]["final"] and rounds.rounds[0]["ok"] == 2
        assert not rounds._thread.is_alive()
        cli.close()
    finally:
        c.stop()
