"""The port's cluster: meta server, replica stubs and the meta-resolved
client over real sockets, on the CPU.

A Cluster harness like tests/test_cluster.py's (the port's MetaServer
and three port ReplicaStubs with EngineOptions(device="cpu"), beacons
every 0.2 s) drives table DDL, PacificA writes across nodes, a primary
kill, the rebuild of a dead node's replicas, a restarted node's relearn,
app envs and a meta restart. Two mixed clusters hold the packages'
replication wire to each other: a pegasus_tpu meta with port nodes, and
a port meta with one pegasus_tpu node among two port nodes, where
prepares and a learn cross the packages and every partition's replicas
end with equal state digests. Then the RPC pool's priority escape, and
`python -m pegasus_tpu_torch.server` booting the onebox's metas and
replicas from an ini derived from onebox.ini. Every wait has a deadline;
every server, stub and subprocess stops in teardown.
"""

import configparser
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from pegasus_tpu_torch.client import MetaResolver, PegasusClient
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.meta import MetaServer
from pegasus_tpu_torch.meta import messages as mm
from pegasus_tpu_torch.meta.meta_server import (RPC_CM_CREATE_APP,
                                                RPC_CM_LIST_NODES,
                                                RPC_CM_SET_APP_ENVS)
from pegasus_tpu_torch.replication.replica_stub import (RPC_PREPARE,
                                                        ReplicaStub)
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_stub(root, meta_addr, port=0, cluster_id=1, remote_clusters=None,
               **opts):
    return ReplicaStub(str(root), [meta_addr], port=port,
                       options_factory=lambda: EngineOptions(device="cpu",
                                                             **opts),
                       cluster_id=cluster_id,
                       remote_clusters=remote_clusters
                       ).start(beacon_interval=0.2)


def _ref_stub(root, meta_addr, port=0, cluster_id=1, remote_clusters=None,
              **opts):
    from pegasus_tpu.engine import EngineOptions as RefOptions
    from pegasus_tpu.replication.replica_stub import ReplicaStub as RefStub

    return RefStub(str(root), [meta_addr], port=port,
                   options_factory=lambda: RefOptions(backend="cpu", **opts),
                   cluster_id=cluster_id, remote_clusters=remote_clusters
                   ).start(beacon_interval=0.2)


class Cluster:
    """A meta (the port's, or pegasus_tpu's with ref_meta=True) and
    replica nodes; `kinds` names each node's package, `options` the
    EngineOptions fields every node's engines take, `cluster_id` and
    `remote_clusters` (name -> meta addresses, the duplication targets)
    what every node's stub takes."""

    options = {}
    stub_args = {}

    def __init__(self, root, kinds=("port",) * 3, ref_meta=False,
                 fd_grace=60.0, options=None, cluster_id=1,
                 remote_clusters=None):
        self.root = root
        self.options = dict(options or {})
        self.stub_args = {"cluster_id": cluster_id,
                          "remote_clusters": remote_clusters}
        if ref_meta:
            from pegasus_tpu.meta import MetaServer as RefMeta
            from pegasus_tpu.rpc.transport import RpcServer as RefRpc

            self.meta = RefMeta(str(root / "meta" / "state.json"),
                                fd_grace_seconds=fd_grace)
            self.meta_rpc = RefRpc()
            self.meta_rpc._thread = threading.Thread(
                target=self.meta_rpc._srv.serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True)
        else:
            self.meta = MetaServer(str(root / "meta" / "state.json"),
                                   fd_grace_seconds=fd_grace)
            self.meta_rpc = RpcServer()
        for code, fn in self.meta.rpc_handlers().items():
            self.meta_rpc.register(code, fn)
        self.meta_rpc.start()
        self.meta_addr = (f"{self.meta_rpc.address[0]}:"
                          f"{self.meta_rpc.address[1]}")
        self.nodes, self.kinds, self.dirs = {}, {}, {}
        for i, kind in enumerate(kinds):
            self.start_node(root / f"node{i}", kind)

    def start_node(self, path, kind, port=0):
        make = _ref_stub if kind == "reference" else _port_stub
        stub = make(path, self.meta_addr, port, **self.stub_args,
                    **self.options)
        self.nodes[stub.address] = stub
        self.kinds[stub.address] = kind
        self.dirs[stub.address] = path
        return stub

    def ddl(self, code, req, resp_cls):
        host, _, port = self.meta_addr.rpartition(":")
        conn = RpcConnection((host, int(port)))
        try:
            _, body = conn.call(code, codec.encode(req), timeout=30.0)
            return codec.decode(resp_cls, body)
        finally:
            conn.close()

    def kill_node(self, addr):
        self.nodes.pop(addr).stop()
        self.meta.mark_node_dead(addr)

    def restart_node(self, addr):
        """Bring a killed node back on its address and data dir; the
        meta's repair pass re-adds it as a learner."""
        port = int(addr.rpartition(":")[2])
        return self.start_node(self.dirs[addr], self.kinds[addr], port)

    def replica(self, addr, app_id, pidx):
        return self.nodes[addr]._replicas[(app_id, pidx)]

    def digests(self, app_id, pidx) -> dict:
        """Every member's state digest, after the primary broadcast its
        commit point (secondaries apply what they hold prepared)."""
        pc = self.meta._parts[app_id][pidx]
        self.replica(pc.primary, app_id, pidx).broadcast_commit_point()
        return {a: self.replica(a, app_id, pidx).server.engine
                .state_digest(now=0)["digest"]
                for a in [pc.primary] + pc.secondaries}

    def stop(self):
        for s in self.nodes.values():
            s.stop()
        self.meta_rpc.stop()


def make_client(cluster, app, partitions=4, replicas=3):
    r = cluster.ddl(RPC_CM_CREATE_APP,
                    mm.CreateAppRequest(app_name=app,
                                        partition_count=partitions,
                                        replica_count=replicas),
                    mm.CreateAppResponse)
    assert r.error == 0 and r.app_id >= 1
    return PegasusClient(MetaResolver([cluster.meta_addr], app))


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(tmp_path)
    yield c
    c.stop()


def test_create_app_and_data_ops(cluster):
    c = make_client(cluster, "t1")
    for i in range(32):
        c.set(b"hk%d" % i, b"sk", b"val%d" % i)
    for i in range(32):
        assert c.get(b"hk%d" % i, b"sk") == b"val%d" % i
    assert c.batch_get([(b"hk%d" % i, b"sk") for i in range(8)]) == \
        [b"val%d" % i for i in range(8)]
    assert c.sortkey_count(b"hk3") == 1
    c.close()


def test_three_members_per_partition_with_equal_digests(cluster):
    c = make_client(cluster, "t2")
    for i in range(40):
        c.set(b"k%d" % i, b"s", b"v%d" % i)
    app_id = c.resolver.app_id
    for pc in cluster.meta._parts[app_id]:
        assert pc.primary and len(pc.secondaries) == 2
        prim = cluster.replica(pc.primary, app_id, pc.pidx)
        assert set(prim.view.secondaries) == set(pc.secondaries)
        assert len(set(cluster.digests(app_id, pc.pidx).values())) == 1
    c.close()


def test_client_survives_primary_node_kill(cluster):
    c = make_client(cluster, "t3")
    for i in range(48):
        c.set(b"fk%d" % i, b"s", b"v%d" % i)
    victim = cluster.meta._parts[c.resolver.app_id][0].primary
    cluster.kill_node(victim)
    for i in range(48):
        assert c.get(b"fk%d" % i, b"s") == b"v%d" % i, f"lost fk{i}"
    for i in range(48, 64):
        c.set(b"fk%d" % i, b"s", b"v%d" % i)
        assert c.get(b"fk%d" % i, b"s") == b"v%d" % i
    for pc in cluster.meta._parts[c.resolver.app_id]:
        assert pc.primary != victim and victim not in pc.secondaries
    c.close()


def test_dead_node_replicas_rebuilt_on_survivor(tmp_path):
    c = Cluster(tmp_path, kinds=("port",) * 4)
    try:
        cl = make_client(c, "t4", partitions=2)
        app_id = cl.resolver.app_id
        for i in range(20):
            cl.set(b"rk%d" % i, b"s", b"v%d" % i)
        pc = c.meta._parts[app_id][0]
        members = [pc.primary] + list(pc.secondaries)
        spare = next(a for a in c.nodes if a not in members)
        c.kill_node(pc.secondaries[0])
        # the spare learned and joined the primary's live view
        assert spare in pc.secondaries
        prim = c.replica(pc.primary, app_id, 0)
        assert spare in prim.view.secondaries
        for i in range(20, 30):
            cl.set(b"rk%d" % i, b"s", b"v%d" % i)
        assert c.replica(spare, app_id, 0).last_prepared >= \
            prim.last_committed
        assert len(set(c.digests(app_id, 0).values())) == 1
        for i in range(30):
            assert cl.get(b"rk%d" % i, b"s") == b"v%d" % i
        cl.close()
    finally:
        c.stop()


def test_restarted_node_relearns_and_rejoins(cluster):
    c = make_client(cluster, "t5")
    app_id = c.resolver.app_id
    for i in range(40):
        c.set(b"lk%d" % i, b"s", b"v%d" % i)
    victim = cluster.meta._parts[app_id][1].primary
    cluster.kill_node(victim)
    for i in range(40, 60):   # writes the victim misses
        c.set(b"lk%d" % i, b"s", b"v%d" % i)
    for pc in cluster.meta._parts[app_id]:
        assert len(pc.secondaries) == 1   # no spare node
    cluster.restart_node(victim)
    deadline = time.monotonic() + 10
    while victim not in cluster.meta._alive_nodes_locked():
        assert time.monotonic() < deadline, "no beacon from the restart"
        time.sleep(0.05)
    assert cluster.meta.repair_under_replication() == 4
    for pc in cluster.meta._parts[app_id]:
        assert victim in pc.secondaries and len(pc.secondaries) == 2
    for i in range(60, 70):
        c.set(b"lk%d" % i, b"s", b"v%d" % i)
    for pidx in range(4):
        assert len(set(cluster.digests(app_id, pidx).values())) == 1
    for i in range(70):
        assert c.get(b"lk%d" % i, b"s") == b"v%d" % i
    c.close()


def test_app_envs_propagate_to_replicas(cluster):
    c = make_client(cluster, "t6", partitions=2)
    r = cluster.ddl(RPC_CM_SET_APP_ENVS,
                    mm.SetAppEnvsRequest(app_name="t6",
                                         envs_json='{"default_ttl": "120"}'),
                    mm.SetAppEnvsResponse)
    assert r.error == 0
    found = 0
    for stub in cluster.nodes.values():
        for (aid, _), rep in stub._replicas.items():
            if aid == c.resolver.app_id:
                assert rep.server.app_envs.get("default_ttl") == "120"
                found += 1
    assert found == 6
    c.close()


def test_list_nodes_and_meta_restart(cluster):
    c = make_client(cluster, "t7", partitions=2)
    c.set(b"h", b"s", b"v")
    c.close()
    r = cluster.ddl(RPC_CM_LIST_NODES, mm.ListNodesRequest(),
                    mm.ListNodesResponse)
    assert len(r.nodes) == 3 and all(n.alive for n in r.nodes)
    m2 = MetaServer(cluster.meta.state_path)
    assert "t7" in m2._apps
    assert [vars(pc) for pc in m2._parts[m2._apps["t7"].app_id]] == \
        [vars(pc) for pc in cluster.meta._parts[m2._apps["t7"].app_id]]


# ------------------------------------------------------- mixed packages

def _mixed_round(c, app):
    cl = make_client(c, app, partitions=4)
    app_id = cl.resolver.app_id
    for i in range(40):
        cl.set(b"mk%d" % i, b"s", b"v%d" % i)
    return cl, app_id


def test_reference_meta_with_port_nodes(tmp_path):
    c = Cluster(tmp_path, ref_meta=True)
    try:
        cl, app_id = _mixed_round(c, "m1")
        victim = c.meta._parts[app_id][0].primary
        c.kill_node(victim)
        for i in range(40, 50):
            cl.set(b"mk%d" % i, b"s", b"v%d" % i)
        c.restart_node(victim)
        deadline = time.monotonic() + 10
        while victim not in c.meta._alive_nodes_locked():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert c.meta.repair_under_replication() == 4
        for pidx in range(4):
            assert len(set(c.digests(app_id, pidx).values())) == 1
        for i in range(50):
            assert cl.get(b"mk%d" % i, b"s") == b"v%d" % i
        cl.close()
    finally:
        c.stop()


def test_port_meta_with_a_reference_node(tmp_path):
    """Prepares cross the packages both ways (each package leads some
    partitions), then the reference node is killed and restarted and
    learns from port primaries; every replica ends digest-equal."""
    c = Cluster(tmp_path, kinds=("reference", "port", "port"))
    try:
        cl, app_id = _mixed_round(c, "m2")
        ref_addr = next(a for a, k in c.kinds.items() if k == "reference")
        primaries = {pc.primary for pc in c.meta._parts[app_id]}
        assert ref_addr in primaries and len(primaries) > 1
        for pidx in range(4):
            assert len(set(c.digests(app_id, pidx).values())) == 1
        c.kill_node(ref_addr)
        for i in range(40, 60):
            cl.set(b"mk%d" % i, b"s", b"v%d" % i)
        c.restart_node(ref_addr)
        deadline = time.monotonic() + 10
        while ref_addr not in c.meta._alive_nodes_locked():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert c.meta.repair_under_replication() == 4
        for pc in c.meta._parts[app_id]:
            assert c.kinds[pc.primary] == "port" and \
                ref_addr in pc.secondaries
        for i in range(60, 70):
            cl.set(b"mk%d" % i, b"s", b"v%d" % i)
        for pidx in range(4):
            assert len(set(c.digests(app_id, pidx).values())) == 1
        for i in range(70):
            assert cl.get(b"mk%d" % i, b"s") == b"v%d" % i
        cl.close()
    finally:
        c.stop()


# ------------------------------------------------------ priority escape

def test_prepare_served_while_every_worker_is_blocked():
    srv = RpcServer()
    release, entered = threading.Event(), []
    lock = threading.Lock()

    def block(header, body):
        with lock:
            entered.append(1)
        release.wait(30)
        return b"blocked"

    srv.register("RPC_TEST_BLOCK", block)
    srv.register("RPC_TEST_PLAIN", lambda h, b: b"plain")
    srv.register(RPC_PREPARE, lambda h, b: b"prepared")
    srv.start()
    conns = []
    threads = []
    try:
        def call(code, out):
            conn = RpcConnection(srv.address)
            conns.append(conn)
            out.append(conn.call(code, b"", timeout=30)[1])

        blocked = []
        for _ in range(RpcServer.POOL_WORKERS):
            t = threading.Thread(target=call,
                                 args=("RPC_TEST_BLOCK", blocked))
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 10
        while len(entered) < RpcServer.POOL_WORKERS:
            assert time.monotonic() < deadline, "the pool never filled"
            time.sleep(0.01)
        plain = []
        t = threading.Thread(target=call, args=("RPC_TEST_PLAIN", plain))
        t.start()
        threads.append(t)
        conn = RpcConnection(srv.address)
        conns.append(conn)
        assert conn.call(RPC_PREPARE, b"", timeout=5)[1] == b"prepared"
        time.sleep(0.3)
        assert plain == []          # a plain code waits for a worker
        release.set()
        t.join(timeout=10)
        assert plain == [b"plain"]
    finally:
        release.set()
        for t in threads:
            t.join(timeout=10)
        for conn in conns:
            conn.close()
        srv.stop()


# --------------------------------------------------------- entry point

def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _onebox_ini(tmp_path) -> str:
    """onebox.ini with its metas and replicas on free fixed ports and
    paths under tmp_path, the cpu backend, fast beacons, and without the
    toollets, http_port, the collector and the offload service (the
    whole onebox boots in tests/test_torch_collector_role.py)."""
    cp = configparser.ConfigParser()
    cp.read(os.path.join(ROOT, "onebox.ini"))
    for sec in ("core", "apps.collector", "apps.compact_offload"):
        cp.remove_section(sec)
    ports = _free_ports(6)
    metas = []
    for i in range(1, 4):
        cp[f"apps.meta{i}"]["port"] = str(ports[i - 1])
        cp[f"apps.meta{i}"]["state_dir"] = str(tmp_path / "meta")
        metas.append(f"127.0.0.1:{ports[i - 1]}")
        sec = cp[f"apps.replica{i}"]
        sec["port"] = str(ports[2 + i])
        sec["data_dir"] = str(tmp_path / f"replica{i}")
        sec.pop("http_port", None)
    cp["pegasus.server"]["meta_servers"] = ",".join(metas)
    cp["pegasus.server"]["compaction_backend"] = "cpu"
    cp["failure_detector"]["beacon_interval_seconds"] = "0.2"
    path = str(tmp_path / "onebox.ini")
    with open(path, "w") as f:
        cp.write(f)
    return path, metas


def test_entry_point_boots_the_onebox_and_stops(tmp_path):
    ini, metas = _onebox_ini(tmp_path)
    apps = "meta1,meta2,meta3,replica1,replica2,replica3"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pegasus_tpu_torch.server", "--config", ini,
         "--app", apps], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT), cwd=str(tmp_path))
    try:
        started = []
        deadline = time.monotonic() + 60
        while len(started) < 6:
            assert time.monotonic() < deadline and proc.poll() is None, \
                proc.stderr.read()
            line = proc.stdout.readline()
            if " started " in line:
                started.append(line.split()[2])
        assert sorted(started) == sorted(apps.split(","))
        # the replicas beacon every meta; the leader creates the table
        ddl = None
        while ddl is None or ddl.error:
            assert time.monotonic() < deadline, ddl
            time.sleep(0.2)
            for m in metas:
                host, _, port = m.rpartition(":")
                conn = RpcConnection((host, int(port)))
                try:
                    _, body = conn.call(RPC_CM_CREATE_APP, codec.encode(
                        mm.CreateAppRequest("boot", 4, 3)), timeout=10)
                    ddl = codec.decode(mm.CreateAppResponse, body)
                    break
                except Exception:   # a follower redirects
                    continue
                finally:
                    conn.close()
        cl = PegasusClient(MetaResolver(metas, "boot"))
        for i in range(20):
            cl.set(b"b%d" % i, b"s", b"v%d" % i)
        assert [cl.get(b"b%d" % i, b"s") for i in range(20)] == \
            [b"v%d" % i for i in range(20)]
        cl.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0, proc.stderr.read()
