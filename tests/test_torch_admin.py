"""The port meta's admin and duplication planes, on the CPU, held to
pegasus_tpu's meta.

Each scenario runs on a port cluster (the harness of
tests/test_torch_cluster.py) with the port's MetaServer acting for real,
and replays the same handler calls on a pegasus_tpu MetaServer twin that
starts from a copy of the port meta's state file and liveness map. The
twin asks the nodes what only they know (their replicas, their replica
states) and records every other node call instead of sending it. The
two metas answer with the same bytes, send the same node calls (node,
code, request bytes) and persist state files equal entry for entry:

- `balance` moves the same primaries (a node restarted after a kill
  holds none) and is refused at level `freezed`; the copy-secondary
  stage seeds a learner on a fourth node; `propose` moves one primary;
- `drop -r`, `recall` (under a new name), a second recall refused, and
  `purge_expired_dropped(now=2**31)`;
- `recover` from the nodes into empty metas, the table then served
  through the port's;
- `ddd_diagnose` names a memberless partition, and `-f` promotes its
  best candidate;
- the duplication entries: add (frozen), query, modify, the beacon's
  confirmed-decree fold, push_dup_envs and the cluster-state snapshot.

The meta modules' wall clock is pinned where a handler stamps a time.
"""

import json
import shutil
import time

import pytest

from pegasus_tpu_torch.client import MetaResolver, PegasusClient
from pegasus_tpu_torch.meta import MetaServer
from pegasus_tpu_torch.meta import messages as mm
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc.transport import RpcServer
from tests.test_torch_cluster import Cluster, make_client
from tests.test_torch_replication import _FrozenTime

# node calls that only read: the twin sends them to the real nodes
_READS = ("RPC_QUERY_REPLICA_INFO", "RPC_QUERY_REPLICA_STATE")


def _recording(meta, calls, send):
    """Wrap meta._send_to_node: append (node, code, request bytes) of
    every call that is not a read, and send through `send` (None: record
    only, answering nothing)."""
    real = meta._send_to_node

    def wrapped(node, code, req, ignore_errors=False, app_id=0, pidx=0):
        if code in _READS:
            return real(node, code, req, ignore_errors, app_id, pidx)
        calls.append((node, code, codec.encode(req)))
        if send:
            return real(node, code, req, ignore_errors, app_id, pidx)
        return None

    meta._send_to_node = wrapped


def _twin(port_meta, path, empty=False):
    """A pegasus_tpu MetaServer on a copy of the port meta's state file
    (or an empty one) with its liveness map, recording its node calls.
    -> (twin, twin's calls, port's calls): from now on the port meta
    records its own calls too (and still sends them)."""
    from pegasus_tpu.meta import MetaServer as RefMeta

    path.mkdir(parents=True, exist_ok=True)
    state = path / "state.json"
    if not empty:
        port_meta._persist()
        shutil.copy(port_meta.state_path, state)
    ref = RefMeta(str(state), fd_grace_seconds=port_meta.fd_grace)
    if not empty:
        with port_meta._lock:
            ref._nodes = dict(port_meta._nodes)
            ref._node_replicas = {n: set(r) for n, r in
                                  port_meta._node_replicas.items()}
    ref_calls, port_calls = [], []
    _recording(ref, ref_calls, send=False)
    if not hasattr(port_meta, "_recorded"):
        _recording(port_meta, port_calls, send=True)
        port_meta._recorded = port_calls
    else:
        port_calls = port_meta._recorded
        port_calls.clear()
    return ref, ref_calls, port_calls


def _both(port_meta, ref_meta, handler, port_req, ref_req=None):
    """The same request through the twin, then the port meta (the twin
    first: it reads the nodes before the port meta moves them). -> the
    port's response bytes, after asserting the twin's are equal."""
    from pegasus_tpu.rpc import codec as ref_codec

    ref_req = ref_req if ref_req is not None else _ref_copy(port_req)
    want = getattr(ref_meta, handler)(None, ref_codec.encode(ref_req))
    got = getattr(port_meta, handler)(None, codec.encode(port_req))
    assert got == want
    return got


def _ref_copy(req):
    from pegasus_tpu.meta import messages as ref_mm
    from pegasus_tpu.rpc import codec as ref_codec

    return ref_codec.decode(getattr(ref_mm, type(req).__name__),
                            codec.encode(req))


def _same_state(port_meta, ref_meta):
    port_meta._persist()
    ref_meta._persist()
    with open(port_meta.state_path) as f:
        got = json.load(f)
    with open(ref_meta.state_path) as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    return got


def _primaries(meta, app_id):
    counts = {a: 0 for a in meta._alive_nodes_locked()}
    for pc in meta._parts[app_id]:
        counts[pc.primary] = counts.get(pc.primary, 0) + 1
    return counts


def _read_all(meta_addr, app, rows):
    cl = PegasusClient(MetaResolver([meta_addr], app))
    try:
        for k, v in rows.items():
            assert cl.get(k, b"s") == v, k
    finally:
        cl.close()


@pytest.fixture
def frozen_meta_clock(monkeypatch):
    import pegasus_tpu.meta.meta_server as ref_ms
    import pegasus_tpu_torch.meta.meta_server as port_ms

    clock = _FrozenTime(time, 1.7e9)
    monkeypatch.setattr(port_ms, "time", clock)
    monkeypatch.setattr(ref_ms, "time", clock)
    return clock


def test_balance_and_propose_like_the_reference(tmp_path):
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "bal", partitions=4)
        rows = {b"bk%d" % i: b"v%d" % i for i in range(40)}
        for k, v in rows.items():
            cl.set(k, b"s", v)
        app_id = cl.resolver.app_id
        victim = c.meta._parts[app_id][0].primary
        c.kill_node(victim)
        c.restart_node(victim)
        deadline = time.time() + 15
        while victim not in c.meta._alive_nodes_locked():
            assert time.time() < deadline
            time.sleep(0.05)
        c.meta.repair_under_replication()
        assert all(len(pc.secondaries) == 2 for pc in c.meta._parts[app_id])
        before = _primaries(c.meta, app_id)
        assert before[victim] == 0
        ref, ref_calls, port_calls = _twin(c.meta, tmp_path / "twin")
        # refused below lively, with the same answer
        for level in ("freezed", "lively"):
            _both(c.meta, ref, "_on_control_meta",
                  mm.ControlMetaRequest(set_level=level))
            if level == "freezed":
                r = codec.decode(mm.BalanceResponse, _both(
                    c.meta, ref, "_on_balance", mm.BalanceRequest()))
                assert r.error and "freezed" in r.error_text
        r = codec.decode(mm.BalanceResponse, _both(
            c.meta, ref, "_on_balance", mm.BalanceRequest()))
        assert r.error == 0 and r.moved >= 1
        after = _primaries(c.meta, app_id)
        assert max(after.values()) - min(after.values()) <= 1
        assert after[victim] >= 1
        assert port_calls == ref_calls and port_calls
        _same_state(c.meta, ref)
        # one propose: a primary of the busiest node to a secondary
        heavy = max(after, key=lambda a: (after[a], a))
        pc = next(p for p in c.meta._parts[app_id] if p.primary == heavy)
        target = pc.secondaries[0]
        port_calls.clear()
        ref_calls.clear()
        r = codec.decode(mm.ProposeResponse, _both(
            c.meta, ref, "_on_propose",
            mm.ProposeRequest("bal", pc.pidx, target)))
        assert r.error == 0 and pc.primary == target
        r = codec.decode(mm.ProposeResponse, _both(
            c.meta, ref, "_on_propose",
            mm.ProposeRequest("bal", pc.pidx, "127.0.0.1:1")))
        assert r.error == 1 and "not a secondary" in r.error_text
        assert port_calls == ref_calls
        _same_state(c.meta, ref)
        cl.resolver.refresh()
        _read_all(c.meta_addr, "bal", rows)
        cl.close()
    finally:
        c.stop()


def test_copy_secondary_seeds_a_learner_like_the_reference(tmp_path):
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "cp", partitions=4)
        rows = {b"ck%d" % i: b"v%d" % i for i in range(40)}
        for k, v in rows.items():
            cl.set(k, b"s", v)
        app_id = cl.resolver.app_id
        new = c.start_node(tmp_path / "c" / "node3", "port").address
        deadline = time.time() + 15
        while new not in c.meta._alive_nodes_locked():
            assert time.time() < deadline
            time.sleep(0.05)
        ref, ref_calls, port_calls = _twin(c.meta, tmp_path / "twin")
        r = codec.decode(mm.BalanceResponse, _both(
            c.meta, ref, "_on_balance", mm.BalanceRequest()))
        assert r.error == 0 and r.moved >= 2
        assert port_calls == ref_calls
        learns = [body for n, code, body in port_calls
                  if n == new and codec.decode(mm.OpenReplicaRequest,
                                               body).learn_from]
        assert len(learns) == r.moved
        _same_state(c.meta, ref)
        loads = [c.meta._node_load_locked(a)
                 for a in c.meta._alive_nodes_locked()]
        assert max(loads) - min(loads) <= 1
        held = [pc.pidx for pc in c.meta._parts[app_id]
                if new in pc.secondaries]
        assert len(held) == r.moved
        for p in held:   # the learner holds its partition's state
            assert len(set(c.digests(app_id, p).values())) == 1
        cl.resolver.refresh()
        _read_all(c.meta_addr, "cp", rows)
        cl.close()
    finally:
        c.stop()


def test_drop_recall_and_purge_like_the_reference(tmp_path,
                                                  frozen_meta_clock):
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "dr", partitions=2)
        app_id = cl.resolver.app_id
        rows = {b"drk%d" % i: b"v%d" % i for i in range(15)}
        for k, v in rows.items():
            cl.set(k, b"s", v)
        cl.close()
        ref, ref_calls, port_calls = _twin(c.meta, tmp_path / "twin")
        _both(c.meta, ref, "_on_drop_app", mm.DropAppRequest("dr", 3600))
        assert "dr" not in c.meta._apps and app_id in c.meta._dropped
        r = codec.decode(mm.RecallAppResponse, _both(
            c.meta, ref, "_on_recall_app", mm.RecallAppRequest(app_id,
                                                               "dr2")))
        assert r.error == 0 and r.app_name == "dr2"
        r = codec.decode(mm.RecallAppResponse, _both(
            c.meta, ref, "_on_recall_app", mm.RecallAppRequest(app_id)))
        assert r.error == 1
        _both(c.meta, ref, "_on_create_app",
              mm.CreateAppRequest("dr3", 1, 3))
        aid3 = c.meta._apps["dr3"].app_id
        _both(c.meta, ref, "_on_drop_app", mm.DropAppRequest("dr3", 5))
        assert c.meta.purge_expired_dropped(now=2**31) == [aid3] == \
            ref.purge_expired_dropped(now=2**31)
        r = codec.decode(mm.RecallAppResponse, _both(
            c.meta, ref, "_on_recall_app", mm.RecallAppRequest(aid3)))
        assert r.error == 1 and "hold expired" in r.error_text
        assert port_calls == ref_calls
        _same_state(c.meta, ref)
        _read_all(c.meta_addr, "dr2", rows)
    finally:
        c.stop()


def test_recover_into_an_empty_meta_like_the_reference(tmp_path):
    c = Cluster(tmp_path / "c")
    rpc2 = None
    try:
        cl = make_client(c, "rc", partitions=2)
        rows = {b"rk%d" % i: b"v%d" % i for i in range(30)}
        for k, v in rows.items():
            cl.set(k, b"s", v)
        cl.close()
        nodes = sorted(c.nodes)
        m2 = MetaServer(str(tmp_path / "meta2" / "state.json"))
        ref, ref_calls, port_calls = _twin(m2, tmp_path / "twin",
                                           empty=True)
        r = codec.decode(mm.RecoverResponse, _both(
            m2, ref, "_on_recover", mm.RecoverRequest(nodes)))
        assert r.recovered_apps == ["rc"]
        assert len(m2._parts[m2._apps["rc"].app_id]) == 2
        assert port_calls == ref_calls and port_calls
        _same_state(m2, ref)
        # a second recover finds nothing new
        r = codec.decode(mm.RecoverResponse, _both(
            m2, ref, "_on_recover", mm.RecoverRequest(nodes)))
        assert r.recovered_apps == []
        rpc2 = RpcServer().start()
        for code, fn in m2.rpc_handlers().items():
            rpc2.register(code, fn)
        _read_all(f"{rpc2.address[0]}:{rpc2.address[1]}", "rc", rows)
    finally:
        if rpc2 is not None:
            rpc2.stop()
        c.stop()


def test_ddd_diagnose_like_the_reference(tmp_path):
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "dd", partitions=1)
        rows = {b"ddk%d" % i: b"v%d" % i for i in range(10)}
        for k, v in rows.items():
            cl.set(k, b"s", v)
        app_id = cl.resolver.app_id
        pc = c.meta._parts[app_id][0]
        members = [pc.primary] + list(pc.secondaries)
        for m in members:
            c.meta.mark_node_dead(m)
        assert pc.primary == "" and pc.secondaries == []
        deadline = time.time() + 10
        while len(c.meta._alive_nodes_locked()) != 3:
            assert time.time() < deadline   # beacons revive the nodes
            time.sleep(0.05)
        ref, ref_calls, port_calls = _twin(c.meta, tmp_path / "twin")
        r = codec.decode(mm.DddDiagnoseResponse, _both(
            c.meta, ref, "_on_ddd_diagnose", mm.DddDiagnoseRequest("dd")))
        (info,) = r.partitions
        assert info.reason == "no alive member in config"
        assert len(info.candidates) == 3 and not info.action
        r = codec.decode(mm.DddDiagnoseResponse, _both(
            c.meta, ref, "_on_ddd_diagnose",
            mm.DddDiagnoseRequest("nosuch", True)))
        assert r.error == 1
        r = codec.decode(mm.DddDiagnoseResponse, _both(
            c.meta, ref, "_on_ddd_diagnose",
            mm.DddDiagnoseRequest("dd", True)))
        assert r.partitions[0].action.startswith("promoted ")
        assert pc.primary in members and len(pc.secondaries) == 2
        assert port_calls == ref_calls and port_calls
        _same_state(c.meta, ref)
        cl.resolver.refresh()
        _read_all(c.meta_addr, "dd", rows)
        r = codec.decode(mm.DddDiagnoseResponse, c.meta._on_ddd_diagnose(
            None, codec.encode(mm.DddDiagnoseRequest("dd"))))
        assert r.partitions == []
        cl.close()
    finally:
        c.stop()


def test_duplication_entries_like_the_reference(tmp_path,
                                               frozen_meta_clock):
    """add_dup (frozen), a second add refused, query_dup, start, a bad
    status and a bad fail mode refused, the fail mode set; a beacon's
    dup_progress folded into `confirmed`; push_dup_envs and the
    cluster-state snapshot's `dups`; remove. Same answers, node calls
    and state files as the reference meta; the reserved app env carries
    the entries to every replica."""
    from pegasus_tpu_torch.base import consts

    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "du", partitions=2)
        app_id = cl.resolver.app_id
        cl.close()
        ref, ref_calls, port_calls = _twin(c.meta, tmp_path / "twin")
        r = codec.decode(mm.AddDuplicationResponse, _both(
            c.meta, ref, "_on_add_dup",
            mm.AddDuplicationRequest("du", "west", True)))
        assert (r.error, r.app_id, r.dupid) == (0, app_id, 1)
        r = codec.decode(mm.AddDuplicationResponse, _both(
            c.meta, ref, "_on_add_dup",
            mm.AddDuplicationRequest("du", "west")))
        assert r.error == 1 and "already exists" in r.error_text
        r = codec.decode(mm.QueryDuplicationResponse, _both(
            c.meta, ref, "_on_query_dup", mm.QueryDuplicationRequest("du")))
        assert [(e.dupid, e.status) for e in r.entries] == [(1, "init")]
        for status, mode, err in (("start", "", 0), ("bogus", "", 1),
                                  ("", "loud", 1), ("", "skip", 0),
                                  ("", "", 0)):
            r = codec.decode(mm.ModifyDuplicationResponse, _both(
                c.meta, ref, "_on_modify_dup",
                mm.ModifyDuplicationRequest("du", 1, status, mode)))
            assert r.error == err
        beacon = mm.BeaconRequest(
            node=sorted(c.nodes)[0],
            dup_progress=[f"{app_id}.0.1:7", f"{app_id}.1.1:3",
                          f"{app_id}.1.1:2", "junk"])
        for meta in (c.meta, ref):
            meta._on_beacon(None, codec.encode(beacon))
        assert c.meta._dups[app_id][0]["confirmed"] == {"0": 7, "1": 3}
        c.meta.push_dup_envs()
        ref.push_dup_envs()
        snap = [json.loads(codec.decode(
            mm.QueryClusterStateResponse, m._on_query_cluster_state(
                None, b"")).state_json)["dups"] for m in (c.meta, ref)]
        assert snap[0] == snap[1] == {str(app_id): c.meta._dups[app_id]}
        envs = {json.loads(rep.server.app_envs[consts.ENV_DUPLICATION_KEY])
                [0]["confirmed"]["0"] for stub in c.nodes.values()
                for (a, p), rep in stub._replicas.items() if a == app_id}
        assert envs == {7}
        r = codec.decode(mm.ModifyDuplicationResponse, _both(
            c.meta, ref, "_on_modify_dup",
            mm.ModifyDuplicationRequest("du", 1, "removed")))
        assert r.error == 0 and c.meta._dups[app_id] == []
        # an env push reaches the nodes at once in the port (each node's
        # partitions in order), one after another in the reference
        assert sorted(port_calls) == sorted(ref_calls) and port_calls
        _same_state(c.meta, ref)
    finally:
        c.stop()
