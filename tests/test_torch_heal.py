"""The port's integrity loop against pegasus_tpu's, in one process:
scrub, quarantine, the meta's re-seed, auto-heal and the flight recorder.

- The scrub drill of tests/test_integrity.py on a port cluster and on a
  reference cluster (tests/test_torch_cluster.py's Cluster): the tail of
  one secondary's newest SST flipped, `scrub-replica` answers with the
  reference's keys and crc finding and quarantines the replica; the
  quarantine record, the forensics dir, the QUARANTINED beacon state,
  the doctor's quarantine cause, the meta's re-seed (repair_quarantined)
  and every row read back equal the reference's. Time is frozen in both
  replica modules, so both clusters write the same SST bytes.
- A quarantined cuda engine (on CPU tensors) releases its runs from the
  `engine.hbm.*` gauges, and its re-seeded successor's runs count again.
- AutoHealer's gate, interlocks and rate limit take the reference's
  actions on the same verdicts, and the audit-driven heal end to end:
  `audit.digest` planted on one secondary, the doctor critical, that
  replica quarantined (source `command`), re-seeded, the re-audit
  conclusive.
- The flight recorder: an offline capture, retention, observe_verdict's
  transition and cooldown, the `/incidents` route function and the
  event ring's emitted_total / reset, each equal to the reference's; and
  a planted `audit.digest` whose incident's first cause is its
  `failpoint.arm`, listed by the shell's flight_recorder.
- The stub's scrub tick rotates oldest-first under a short cadence, as
  the reference's does.
"""

import glob
import io
import json
import os
import threading
import time
import types

import pytest

from pegasus_tpu.collector import auto_heal as ref_heal
from pegasus_tpu.collector import cluster_doctor as ref_cd
from pegasus_tpu.collector import flight_recorder as ref_fr
from pegasus_tpu.replication import replica as ref_replica
from pegasus_tpu.replication.replica_stub import ReplicaStub as RefStub
from pegasus_tpu.runtime import events as ref_events
from pegasus_tpu.runtime import fail_points as ref_fp
from pegasus_tpu.runtime import service_app as ref_sa
from pegasus_tpu_torch.collector import auto_heal as port_heal
from pegasus_tpu_torch.collector import cluster_doctor as port_cd
from pegasus_tpu_torch.collector import flight_recorder as port_fr
from pegasus_tpu_torch.replication import replica as port_replica
from pegasus_tpu_torch.replication.replica_stub import ReplicaStub
from pegasus_tpu_torch.runtime import events as port_events
from pegasus_tpu_torch.runtime import fail_points as port_fp
from pegasus_tpu_torch.runtime import service_app as port_sa
from pegasus_tpu_torch.runtime.perf_counters import counters
from pegasus_tpu_torch.shell.main import Shell
from tests.test_integrity import flip_tail
from tests.test_torch_cluster import Cluster, make_client
from tests.test_torch_replication import _FrozenTime

PKG = {"port": types.SimpleNamespace(cd=port_cd, fr=port_fr, heal=port_heal,
                                     events=port_events, fp=port_fp,
                                     sa=port_sa),
       "ref": types.SimpleNamespace(cd=ref_cd, fr=ref_fr, heal=ref_heal,
                                    events=ref_events, fp=ref_fp,
                                    sa=ref_sa)}
UNREACHABLE = ["127.0.0.1:1"]


@pytest.fixture(autouse=True)
def _incidents(tmp_path, monkeypatch):
    """Incident artifacts under the test's dir; both recorders' verdict
    state cleared before and after."""
    monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(tmp_path / "incidents"))
    for p in PKG.values():
        p.fr.RECORDER.reset()
    yield tmp_path / "incidents"
    for p in PKG.values():
        p.fr.RECORDER.reset()


def _cluster(root, kind):
    if kind == "port":
        return Cluster(root)
    return Cluster(root, kinds=("reference",) * 3, ref_meta=True)


def _members(c, app_id, pidx):
    pc = c.meta._parts[app_id][pidx]
    return pc.primary, list(pc.secondaries)


def _drive_heal(c, stub, gpid, app_id, pidx, deadline_s=20.0) -> bool:
    """The meta's repair passes (what the MetaApp tick runs) until the
    quarantine is acknowledged and the partition has three members, each
    hosting it."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        c.meta.repair_quarantined()
        c.meta.repair_under_replication()
        with stub._lock:
            acked = gpid not in stub._quarantined
        primary, secondaries = _members(c, app_id, pidx)
        hosting = all((app_id, pidx) in c.nodes[n]._replicas
                      for n in [primary] + secondaries if n in c.nodes)
        if acked and primary and len(secondaries) == 2 and hosting:
            return True
        time.sleep(0.2)
    return False


def _await(fn, what, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while not fn():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _norm(x, subs):
    """x as JSON with every (old, new) of subs replaced."""
    s = json.dumps(x, sort_keys=True)
    for old, new in subs:
        s = s.replace(old, new)
    return json.loads(s)


# ------------------------------------------------------------ scrub drill


def _scrub_drill(root, kind) -> dict:
    c = _cluster(root, kind)
    try:
        cli = make_client(c, "drill", partitions=2)
        rows = {(b"dk%02d" % i, b"s"): b"dv%d" % i for i in range(48)}
        for (hk, sk), v in rows.items():
            cli.set(hk, sk, v)
        app_id = cli.resolver.app_id
        gpid = f"{app_id}.0"
        _, secondaries = _members(c, app_id, 0)
        victim = secondaries[0]
        stub = c.nodes[victim]
        rep = stub._replicas[(app_id, 0)]
        rep.server.engine.flush()
        ssts = sorted(glob.glob(os.path.join(rep.path, "data", "*.sst")),
                      key=os.path.getmtime)
        flip_tail(ssts[-1])
        scrub = json.loads(stub._cmd_scrub_replica([gpid]))
        status = json.loads(stub._cmd_quarantine_status([]))
        forensics = os.listdir(os.path.join(stub.root, "quarantine"))
        _await(lambda: c.meta._node_states.get(victim, {}).get(
            gpid, {}).get("status") == "QUARANTINED", "the beacon")
        verdict = PKG[kind].cd.run_cluster_doctor([c.meta_addr],
                                                  scrape=False)
        healed = _drive_heal(c, stub, gpid, app_id, 0)
        wrong = [k for k, v in rows.items() if cli.get(*k) != v]
        digests = c.digests(app_id, 0)
        cli.close()
        subs = [(str(c.dirs[victim]), "<victim dir>"), (victim, "<victim>")]
        return {"scrub": _norm(scrub, subs), "status": _norm(status, subs),
                "forensics": [f.rpartition(".")[0] for f in forensics],
                "verdict": verdict["verdict"],
                "causes": _norm([x["cause"] for x in verdict["causes"]],
                                subs),
                "incident": bool(verdict.get("incident")),
                "healed": healed, "wrong": wrong,
                "replicas": len(digests), "digests": len(set(
                    digests.values())), "gpid": gpid}
    finally:
        c.stop()


def test_scrub_drill_equals_the_reference(tmp_path, monkeypatch):
    import time as _time

    for mod in (port_replica, ref_replica):
        monkeypatch.setattr(mod, "time", _FrozenTime(_time))
    got = {kind: _scrub_drill(tmp_path / kind, kind)
           for kind in ("port", "ref")}
    port, ref = got["port"], got["ref"]
    for rec in (port["status"], ref["status"]):
        for q in rec.values():
            q.pop("ts")
            q["dir"] = q["dir"].rpartition(".")[0]  # the quarantine's ms
    assert port == ref
    gpid = port["gpid"]
    ans = port["scrub"][gpid]
    assert ans["quarantined"] is True
    assert any("crc32 mismatch" in f["detail"] for f in ans["findings"])
    assert port["status"][gpid]["source"] == "scrub"
    assert port["forensics"] == [gpid]
    assert port["verdict"] == "degraded" and port["incident"]
    assert any(f"replica {gpid} on node <victim> quarantined (scrub: " in x
               for x in port["causes"])
    assert port["healed"] and port["wrong"] == []
    assert port["replicas"] == 3 and port["digests"] == 1


def test_quarantine_releases_the_engine_device_runs(tmp_path):
    """A cuda engine (device="cpu") holds its flushed runs resident; its
    quarantine closes it, and the node's engine.hbm.resident_bytes falls
    by exactly its bytes; the re-seeded replica's runs count again."""
    c = Cluster(tmp_path)
    gauge = counters.number("engine.hbm.resident_bytes")
    ssts = counters.number("engine.hbm.resident_ssts")
    try:
        cli = make_client(c, "hbm", partitions=2)
        for i in range(64):
            cli.set(b"hk%02d" % i, b"s", b"v%d" % i)
        app_id = cli.resolver.app_id
        gpid = f"{app_id}.1"
        primary, secondaries = _members(c, app_id, 1)
        for node in [primary] + secondaries:  # the re-seed learns a run
            e = c.replica(node, app_id, 1).server.engine
            e.flush()
            e.wait_primes()
        stub = c.nodes[secondaries[0]]
        eng = stub._replicas[(app_id, 1)].server.engine
        held, held_ssts = eng.device_resident_bytes(), \
            eng.stats()["device_resident_ssts"]
        assert held > 0 and held_ssts == 1
        before, before_ssts = gauge.value(), ssts.value()
        rec = json.loads(stub._cmd_quarantine_replica([gpid, "test"]))
        assert rec[gpid]["source"] == "command"
        assert before - gauge.value() == held
        assert before_ssts - ssts.value() == held_ssts
        assert eng.device_resident_bytes() == 0
        assert _drive_heal(c, stub, gpid, app_id, 1)
        fresh = stub._replicas[(app_id, 1)].server.engine
        fresh.wait_primes()
        assert fresh is not eng and fresh.device_resident_bytes() > 0
        assert gauge.value() == before - held + fresh.device_resident_bytes()
        for i in range(64):
            assert cli.get(b"hk%02d" % i, b"s") == b"v%d" % i
        cli.close()
    finally:
        c.stop()


def test_read_path_corruption_quarantines_once_as_the_reference(tmp_path):
    """The hook the stub installs at open: a burst of corrupt reads on one
    replica starts one asynchronous quarantine, source `read`, in both
    packages."""
    from pegasus_tpu.engine.sstable import CorruptionError as RefError
    from pegasus_tpu_torch.engine.sstable import CorruptionError

    got = {}
    for kind, err in (("port", CorruptionError), ("ref", RefError)):
        c = _cluster(tmp_path / kind, kind)
        try:
            cli = make_client(c, "rd", partitions=2)
            cli.set(b"k", b"s", b"v")
            app_id = cli.resolver.app_id
            gpid = f"{app_id}.0"
            stub = c.nodes[_members(c, app_id, 0)[1][0]]
            eng = stub._replicas[(app_id, 0)].server.engine
            for _ in range(3):
                eng.corruption_hook(err("x.sst", "section keys crc32 "
                                                 "mismatch"))
            _await(lambda: gpid in stub._quarantined, "the quarantine")
            rec = dict(stub._quarantined[gpid])
            rec.pop("ts")
            rec["dir"] = bool(rec["dir"])
            got[kind] = (rec, os.listdir(os.path.join(stub.root,
                                                      "quarantine")))
            assert (app_id, 0) not in stub._replicas
            cli.close()
        finally:
            c.stop()
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0] == {"reason": "section keys crc32 mismatch",
                                 "source": "read", "dir": True}
    assert len(port[1]) == len(ref[1]) == 1


def test_scrub_tick_rotates_under_short_cadence():
    """A cadence shorter than the tick spacing leaves every replica past
    due at every tick: both stubs rotate oldest-first."""
    got = {}
    for cls in (ReplicaStub, RefStub):
        reps = [types.SimpleNamespace(app_id=1, pidx=i) for i in range(4)]
        fake = types.SimpleNamespace(
            _lock=threading.Lock(),
            _replicas={(r.app_id, r.pidx): r for r in reps},
            _last_scrub={}, _scrub_interval=0.001, scrubbed=[])
        fake._scrub_replica = lambda rep, f=fake: f.scrubbed.append(
            (rep.app_id, rep.pidx))
        tick = types.MethodType(cls._scrub_tick, fake)
        for _ in range(8):
            time.sleep(0.002)
            tick(reps)
        got[cls] = fake.scrubbed
    assert got[ReplicaStub] == got[RefStub] == \
        [(1, 0), (1, 1), (1, 2), (1, 3)] * 2


# --------------------------------------------------------------- auto-heal


class _FakeCaller:
    def __init__(self):
        self.calls = []

    def remote_command(self, node, cmd, args):
        self.calls.append((node, cmd, list(args)))
        return "{}"


def _verdict(mismatches, verdict="critical"):
    return {"verdict": verdict,
            "evidence": {"audit": {"mismatches": mismatches}}}


def test_autoheal_gates_and_vetoes_equal_the_reference(monkeypatch):
    m = {"gpid": "2.1", "node": "n1:1", "decree": 7,
         "digest": "a" * 32, "expected": "b" * 32}
    script = [
        ("off", None, [_verdict([m])]),
        ("on", None, [_verdict([m])]),
        ("on", None, [_verdict([m, dict(m, node="n2:1")])]),
        ("on", None, [_verdict([m], "inconclusive"),
                      _verdict([m], "degraded"), _verdict([])]),
        ("on", "3600", [_verdict([m]), _verdict([dict(m, gpid="2.0")])]),
        ("on", None, [_verdict([m, dict(m, gpid="3.0", node="n3:1")])]),
    ]
    for gate, interval, verdicts in script:
        if gate == "on":
            monkeypatch.setenv("PEGASUS_AUTOHEAL", "1")
        else:
            monkeypatch.delenv("PEGASUS_AUTOHEAL", raising=False)
        if interval:
            monkeypatch.setenv("PEGASUS_AUTOHEAL_MIN_INTERVAL_S", interval)
        else:
            monkeypatch.delenv("PEGASUS_AUTOHEAL_MIN_INTERVAL_S",
                               raising=False)
        got = []
        for p in PKG.values():
            h, c = p.heal.AutoHealer(), _FakeCaller()
            got.append(([h.observe_verdict(v, c) for v in verdicts],
                        c.calls))
        assert got[0] == got[1], (gate, interval)
    # the one quarantine of the rate-limited round, and its reason
    assert len(got[0][1]) == 1
    assert "decree 7" in got[0][1][0][2][1]


def _autoheal_e2e(root, kind) -> dict:
    p = PKG[kind]
    c = _cluster(root, kind)
    p.fp.setup()
    try:
        cli = make_client(c, "ahl", partitions=2)
        rows = {b"ak%02d" % i: b"av%d" % i for i in range(40)}
        for hk, v in rows.items():
            cli.set(hk, b"s", v)
        app_id = cli.resolver.app_id
        gpid = f"{app_id}.0"
        victim = _members(c, app_id, 0)[1][0]
        p.fp.cfg("audit.digest", f"return({victim}@{gpid})")
        report = p.cd.run_cluster_audit([c.meta_addr], wait_s=20.0)
        assert len(report["mismatches"]) == 1
        time.sleep(0.6)  # the corrupted digest rides the next beacons
        with p.heal.AUTO_HEALER._lock:
            p.heal.AUTO_HEALER._last_action = None
        verdict = p.cd.run_cluster_doctor([c.meta_addr], scrape=False)
        stub = c.nodes[victim]
        with stub._lock:
            record = dict(stub._quarantined.get(gpid, {}))
        p.fp.cfg("audit.digest", "off()")
        healed = _drive_heal(c, stub, gpid, app_id, 0)
        for _ in range(20):
            report = p.cd.run_cluster_audit([c.meta_addr], wait_s=20.0)
            assert report["mismatches"] == []
            if gpid in report["ok"]:
                break
            time.sleep(0.3)
        wrong = [hk for hk, v in rows.items() if cli.get(hk, b"s") != v]
        cli.close()
        return {"verdict": verdict["verdict"],
                "autoheal": _norm(verdict.get("autoheal"),
                                  [(victim, "<victim>")]),
                "source": record.get("source"),
                "reason": record.get("reason", "").split(" (got")[0],
                "healed": healed, "reaudit_ok": gpid in report["ok"],
                "wrong": wrong, "gpid": gpid}
    finally:
        p.fp.teardown()
        c.stop()


def test_autoheal_end_to_end_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PEGASUS_AUTOHEAL", "1")
    port = _autoheal_e2e(tmp_path / "port", "port")
    ref = _autoheal_e2e(tmp_path / "ref", "ref")
    assert port == ref
    assert port["verdict"] == "critical"
    assert port["autoheal"] == [{"gpid": port["gpid"], "node": "<victim>"}]
    assert port["source"] == "command"
    assert port["healed"] and port["reaudit_ok"] and port["wrong"] == []


# --------------------------------------------------------- flight recorder


def test_event_ring_emitted_total_and_reset_equal_the_reference():
    got = []
    for p in PKG.values():
        bus = p.events.EventBus(capacity=4)
        for i in range(6):
            bus.emit("unit.tick", i=i)
        before = (bus.emitted_total(), [e["attrs"]["i"]
                                        for e in bus.snapshot()])
        bus.reset()
        got.append((before, bus.emitted_total(), bus.snapshot()))
        bus.emit("unit.tick", i=9)
        got[-1] += (bus.emitted_total(), bus.snapshot()[0]["seq"])
    assert got[0] == got[1] == [((6, [2, 3, 4, 5]), 0, [], 1, 0)][0]


def _offline(p) -> dict:
    p.events.EVENTS.reset()
    p.events.emit("learn.start", gpid="1.0")
    p.events.emit("lane.breaker_trip", lane="compact.lane", op="merge")
    p.events.emit("failpoint.arm", point="unit.fault", action="return()")
    fr = p.fr.FlightRecorder()
    inc = fr.capture(UNREACHABLE, reason="unit", trigger="manual")
    listing = fr.list_incidents()
    return {"first_cause": inc["first_cause"]["name"],
            "timeline": [e["name"] for e in inc["timeline"]],
            "t_rel": all("t_rel" in e for e in inc["timeline"]),
            "errors": bool(inc["errors"]),
            "retained": os.path.exists(inc["path"]),
            "loaded": fr.load(inc["id"])["id"] == inc["id"],
            "listing": [dict(i, id=None, ts=None) for i in listing],
            "keys": sorted(inc)}


def test_offline_capture_equals_the_reference(_incidents, monkeypatch):
    got = []
    for kind, p in PKG.items():
        monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(_incidents / kind))
        got.append(_offline(p))
    assert got[0] == got[1]
    assert got[0]["first_cause"] == "lane.breaker_trip"
    assert got[0]["timeline"] == ["learn.start", "lane.breaker_trip",
                                  "failpoint.arm"]
    assert got[0]["errors"] and got[0]["retained"] and got[0]["loaded"]


def test_retention_prunes_to_keep_as_the_reference(_incidents, monkeypatch):
    monkeypatch.setenv("PEGASUS_INCIDENT_KEEP", "2")
    for kind, p in PKG.items():
        monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(_incidents / kind))
        p.events.EVENTS.reset()
        fr = p.fr.FlightRecorder()
        ids = []
        for i in range(4):
            ids.append(fr.capture(UNREACHABLE, reason=f"r{i}",
                                  trigger="manual")["id"])
            time.sleep(0.01)  # distinct mtimes
        assert {i["id"] for i in fr.list_incidents()} == set(ids[-2:]), kind


def test_observe_verdict_transition_and_cooldown_equal_the_reference(
        _incidents, monkeypatch):
    monkeypatch.setenv("PEGASUS_INCIDENT_COOLDOWN_S", "3600")
    ok = {"verdict": "healthy", "causes": []}
    bad = {"verdict": "critical",
           "causes": [{"cause": "x", "severity": "critical"}]}
    deg = {"verdict": "degraded", "causes": []}
    got = []
    for kind, p in PKG.items():
        monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(_incidents / kind))
        p.events.EVENTS.reset()
        fr = p.fr.FlightRecorder()
        seq = [fr.observe_verdict(v, UNREACHABLE)
               for v in (ok, bad, deg, ok, bad)]
        fr.reset()
        seq.append(fr.observe_verdict(bad, UNREACHABLE))
        first = seq[1]
        got.append(([None if i is None else ("first" if i == first else
                                             "new") for i in seq],
                    len(fr.list_incidents())))
    assert got[0] == got[1] == (
        [None, "first", "first", None, None, "new"], 2)


def test_incidents_route_equals_the_reference(_incidents, monkeypatch):
    got = []
    for kind, p in PKG.items():
        monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(_incidents / kind))
        p.events.EVENTS.reset()
        empty = (p.sa._incidents_route("/incidents"),
                 p.sa._incidents_route("/incidents?id=nope"),
                 p.sa._incidents_route("/incidents?id=../x"))
        p.events.emit("failpoint.arm", point="u", action="return()")
        inc = p.fr.RECORDER.capture(UNREACHABLE, reason="route",
                                    trigger="manual")
        listed = p.sa._incidents_route("/incidents")["incidents"]
        one = p.sa._incidents_route(f"/incidents?id={inc['id']}")
        got.append((empty, [dict(i, id=None, ts=None) for i in listed],
                    one["incident"]["id"] == inc["id"],
                    one["incident"]["first_cause"]["attrs"]))
    assert got[0] == got[1]
    assert got[0][0] == ({"incidents": []}, {"incident": None},
                         {"incident": None})
    assert got[0][1][0]["first_cause"] == "failpoint.arm"


def _planted(root, kind, incidents) -> dict:
    p = PKG[kind]
    c = _cluster(root, kind)
    p.fp.setup()
    try:
        cli = make_client(c, "frinc", partitions=2)
        for i in range(40):
            cli.set(b"k%03d" % i, b"s", b"v%d" % i)
        time.sleep(0.5)  # beacons land
        assert p.cd.run_cluster_doctor([c.meta_addr], scrape=False)[
            "verdict"] == "healthy"
        app_id = cli.resolver.app_id
        victim = _members(c, app_id, 0)[1][0]
        # the planted arm is the earliest cascade-class event in the ring
        p.events.EVENTS.reset()
        p.fp.cfg("audit.digest", f"return({victim}@{app_id}.0)")
        report = p.cd.run_cluster_audit([c.meta_addr], wait_s=20.0)
        assert report["mismatches"]
        time.sleep(0.6)  # the corrupted digest rides the next beacons
        verdict = p.cd.run_cluster_doctor([c.meta_addr], scrape=False)
        inc = p.fr.RECORDER.load(verdict.get("incident") or "")
        again = p.cd.run_cluster_doctor([c.meta_addr], scrape=False)
        tl = inc["timeline"]
        names = {e["name"] for e in tl}
        out = {"verdict": verdict["verdict"],
               "first_cause": (inc["first_cause"]["name"],
                               inc["first_cause"]["attrs"]["point"]),
               "ordered": all(tl[i]["ts"] <= tl[i + 1]["ts"]
                              for i in range(len(tl) - 1)),
               "names": sorted(names & {"failpoint.arm", "audit.mismatch",
                                        "doctor.verdict"}),
               "cause_first": inc["first_cause"]["ts"] <= min(
                   e["ts"] for e in tl if e["name"] == "audit.mismatch"),
               "same_id": again.get("incident") == inc["id"],
               "listed": [i["first_cause"] for i in
                          p.fr.RECORDER.list_incidents()
                          if i["id"] == inc["id"]]}
        if kind == "port":
            text = io.StringIO()
            Shell([c.meta_addr], out=text).run_line("flight_recorder")
            out["shell"] = inc["id"] in text.getvalue()
        cli.close()
        return out
    finally:
        p.fp.teardown()
        c.stop()


def test_planted_fault_is_the_incident_first_cause(_incidents, monkeypatch,
                                                   tmp_path):
    got = {}
    for kind in ("port", "ref"):
        monkeypatch.setenv("PEGASUS_INCIDENT_DIR", str(_incidents / kind))
        got[kind] = _planted(tmp_path / kind, kind, _incidents / kind)
    assert got["port"].pop("shell") is True
    assert got["port"] == got["ref"]
    assert got["port"] == {
        "verdict": "critical", "first_cause": ("failpoint.arm",
                                               "audit.digest"),
        "ordered": True, "names": ["audit.mismatch", "doctor.verdict",
                                   "failpoint.arm"],
        "cause_first": True, "same_id": True, "listed": ["failpoint.arm"]}
