"""The table lifecycle on the port's cluster, on the CPU: partition split
with its stale-key GC compaction, cold backup and restore, backup
policies and meta-driven bulk-load sessions, each held to pegasus_tpu.

The clusters are tests/test_torch_cluster.py's harness (in-process metas
and replica stubs over real sockets; port engines on device="cpu").
Parity is byte equality: the same writes and DDL on a port cluster and
on a pegasus_tpu cluster (time frozen in both replica modules, so value
timetags agree) give equal per-partition key sets and state digests,
equal backup trees, and equal session responses; mixed clusters split
and restore across the packages both ways. The reference engines
compact on the tpu backend (JAX on the CPU) where the GC compaction
runs, and on the cpu backend elsewhere.
"""

import json
import os

import numpy as np
import pytest

from pegasus_tpu_torch.base import key_schema
from pegasus_tpu_torch.client import MetaResolver, PegasusClient
from pegasus_tpu_torch.engine import bulk_load as bl
from pegasus_tpu_torch.meta import messages as mm
from pegasus_tpu_torch.meta.meta_server import (RPC_CM_BACKUP_APP,
                                                RPC_CM_CONTROL_BULK_LOAD,
                                                RPC_CM_QUERY_BULK_LOAD,
                                                RPC_CM_QUERY_CONFIG,
                                                RPC_CM_QUERY_RESTORE,
                                                RPC_CM_RESTORE_APP,
                                                RPC_CM_SPLIT_APP,
                                                RPC_CM_START_BULK_LOAD)
from pegasus_tpu_torch.replication import replica as port_replica
from pegasus_tpu_torch.rpc import codec
from tests.test_torch_cluster import Cluster, make_client
from tests.test_torch_replication import _FrozenTime


def _ref_tpu_stub(root, meta_addr, port=0):
    from pegasus_tpu.engine import EngineOptions as RefOptions
    from pegasus_tpu.replication.replica_stub import ReplicaStub as RefStub

    return RefStub(str(root), [meta_addr], port=port,
                   options_factory=lambda: RefOptions(backend="tpu")
                   ).start(beacon_interval=0.2)


class RefTpuCluster(Cluster):
    """A pegasus_tpu meta and pegasus_tpu nodes on the tpu backend."""

    def __init__(self, root):
        super().__init__(root, kinds=("reference",) * 3, ref_meta=True)

    def start_node(self, path, kind, port=0):
        stub = _ref_tpu_stub(path, self.meta_addr, port)
        self.nodes[stub.address] = stub
        self.kinds[stub.address] = kind
        self.dirs[stub.address] = path
        return stub


@pytest.fixture
def cluster(tmp_path):
    c = Cluster(tmp_path)
    yield c
    c.stop()


@pytest.fixture
def frozen(monkeypatch):
    """time.time() frozen in both packages' replica modules."""
    import pegasus_tpu.replication.replica as ref_replica

    for mod in (port_replica, ref_replica):
        monkeypatch.setattr(mod, "time", _FrozenTime(mod.time))


def _split(c, app):
    return c.ddl(RPC_CM_SPLIT_APP, mm.SplitAppRequest(app),
                 mm.SplitAppResponse)


def _gc_compact(c, app_id):
    """Manual compaction of every replica of the app (each one GCs the
    keys its partition no longer owns)."""
    for stub in c.nodes.values():
        for (aid, _), rep in list(stub._replicas.items()):
            if aid == app_id:
                rep.server.engine.manual_compact()


def _partition_state(c, app_id) -> dict:
    """{pidx: {node: (sorted keys, digest)}} of every replica."""
    out = {}
    for pc in c.meta._parts[app_id]:
        c.replica(pc.primary, app_id, pc.pidx).broadcast_commit_point()
        for a in [pc.primary] + pc.secondaries:
            eng = c.replica(a, app_id, pc.pidx).server.engine
            keys = sorted(k for k, _, _ in eng.scan(b"", None, now=1))
            out.setdefault(pc.pidx, {})[a] = (
                keys, eng.state_digest(now=0)["digest"])
    return out


def _one_per_partition(state) -> dict:
    """Every replica of a partition agrees -> {pidx: (keys, digest)}."""
    out = {}
    for pidx, reps in state.items():
        vals = list(reps.values())
        assert all(v == vals[0] for v in vals), pidx
        out[pidx] = vals[0]
    return out


# ------------------------------------------------------------------ split

def test_split_doubles_and_reroutes(cluster):
    cli = make_client(cluster, "sp", partitions=2)
    rows = {b"sp%d" % i: b"v%d" % i for i in range(40)}
    for hk, v in rows.items():
        cli.set(hk, b"s", v)
    r = _split(cluster, "sp")
    assert r.error == 0 and r.new_partition_count == 4
    cli2 = PegasusClient(MetaResolver([cluster.meta_addr], "sp"))
    assert cli2.resolver.partition_count == 4
    for hk, v in rows.items():
        assert cli2.get(hk, b"s") == v, hk
    for i in range(40, 60):
        cli2.set(b"sp%d" % i, b"s", b"v%d" % i)
        assert cli2.get(b"sp%d" % i, b"s") == b"v%d" % i
    # the stale client re-routes (the parents reject child-half keys)
    for hk, v in rows.items():
        assert cli.get(hk, b"s") == v
    envs = json.loads(cluster.meta._apps["sp"].envs_json)
    assert envs["replica.partition_version"] == "3"
    assert "replica.split_pending" not in envs
    cli.close()
    cli2.close()


def test_split_stale_keys_gc_after_compact(cluster):
    cli = make_client(cluster, "spgc", partitions=1)
    for i in range(30):
        cli.set(b"g%d" % i, b"s", b"v")
    _split(cluster, "spgc")
    app_id = cli.resolver.app_id
    _gc_compact(cluster, app_id)
    seen = {}
    for pc in cluster.meta._parts[app_id]:
        eng = cluster.replica(pc.primary, app_id, pc.pidx).server.engine
        assert eng.opts.partition_mask == 1
        for k, _, _ in eng.scan(b"", None, now=1):
            assert key_schema.key_hash(k) % 2 == pc.pidx
            seen[k] = seen.get(k, 0) + 1
    assert len(seen) == 30 and all(n == 1 for n in seen.values())
    cli.close()


def _split_round(c, app):
    """Writes, a split, writes into the doubled space, a GC compaction.
    -> (app_id, per-partition keys and digest)."""
    cli = make_client(c, app, partitions=2)
    rng = np.random.default_rng(8)
    for i in range(48):
        cli.set(b"k%d" % i, b"s%d" % int(rng.integers(3)),
                rng.bytes(int(rng.integers(1, 40))))
    assert _split(c, app).new_partition_count == 4
    cli.resolver.refresh()
    for i in range(48, 64):
        cli.set(b"k%d" % i, b"s", b"late%d" % i)
    app_id = cli.resolver.app_id
    cli.close()
    _gc_compact(c, app_id)
    return app_id, _one_per_partition(_partition_state(c, app_id))


def test_split_and_gc_match_the_reference(tmp_path, frozen):
    port = Cluster(tmp_path / "port")
    try:
        _, got = _split_round(port, "eq")
    finally:
        port.stop()
    ref = RefTpuCluster(tmp_path / "ref")
    try:
        _, want = _split_round(ref, "eq")
    finally:
        ref.stop()
    assert got == want
    assert sum(len(keys) for keys, _ in got.values()) == 64


@pytest.mark.parametrize("mix", ["reference_meta", "reference_node"])
def test_split_seeds_across_the_packages(tmp_path, mix):
    """A reference meta splits port nodes; a port meta splits a cluster
    with a pegasus_tpu node among port nodes (children learn from
    parents of either package)."""
    c = (Cluster(tmp_path, ref_meta=True) if mix == "reference_meta"
         else Cluster(tmp_path, kinds=("reference", "port", "port")))
    try:
        cli = make_client(c, "mx", partitions=2)
        for i in range(40):
            cli.set(b"x%d" % i, b"s", b"v%d" % i)
        r = _split(c, "mx")
        assert r.error == 0 and r.new_partition_count == 4
        cli.resolver.refresh()
        for i in range(40, 50):
            cli.set(b"x%d" % i, b"s", b"v%d" % i)
        for i in range(50):
            assert cli.get(b"x%d" % i, b"s") == b"v%d" % i
        app_id = cli.resolver.app_id
        _one_per_partition(_partition_state(c, app_id))
        cli.close()
    finally:
        c.stop()


def _failed_split(c, monkeypatch, fail_pidx):
    """A split whose seeding of child `fail_pidx` fails once (its learn
    raises on the node): -> (first response, resumed response, the
    port's learn calls per child)."""
    calls, failed = {}, []
    real = port_replica.Replica.learn_from

    def learn_from(rep, peer):
        key = (rep.name, rep.pidx)
        calls[key] = calls.get(key, 0) + 1
        if rep.pidx == fail_pidx and not failed:
            failed.append(key)
            raise port_replica.ReplicaError("seeding refused once")
        return real(rep, peer)

    monkeypatch.setattr(port_replica.Replica, "learn_from", learn_from)
    cli = make_client(c, "sf", partitions=2)
    for i in range(30):
        cli.set(b"f%d" % i, b"s", b"v%d" % i)
    first = _split(c, "sf")
    return cli, first, calls


@pytest.mark.parametrize("meta", ["port", "reference"])
def test_failed_seeding_resumes_without_relearning(tmp_path, monkeypatch,
                                                   meta):
    """The seeding of one child fails: the split answers the reference's
    error text (byte-equal from either meta) and keeps its resume
    marker; a seeded child takes a write; the retried split resumes (no
    second doubling) and does not re-learn that child's primary from its
    parent (its secondaries re-learn from the child primary, as in the
    reference)."""
    c = Cluster(tmp_path, ref_meta=(meta == "reference"))
    try:
        cli, first, calls = _failed_split(c, monkeypatch, fail_pidx=3)
        assert codec.encode(first) == codec.encode(mm.SplitAppResponse(
            error=1, new_partition_count=4,
            error_text="child seeding incomplete; GC mask withheld — "
                       "re-run split to retry"))
        envs = json.loads(c.meta._apps["sf"].envs_json)
        assert envs["replica.split_pending"] == "2"
        assert "replica.partition_version" not in envs
        # child 2 seeded: it serves, and takes a write of its own half
        cli.resolver.refresh()
        hk = next(b"w%d" % i for i in range(1000)
                  if key_schema.key_hash(key_schema.generate_key(
                      b"w%d" % i, b"s")) % 4 == 2)
        cli.set(hk, b"s", b"after-seed")
        child = (c.meta._parts[cli.resolver.app_id][2].primary, 2)
        assert calls[child] == 1
        second = _split(c, "sf")
        assert second.error == 0 and second.new_partition_count == 4
        assert calls[child] == 1
        assert cli.get(hk, b"s") == b"after-seed"
        for i in range(30):
            assert cli.get(b"f%d" % i, b"s") == b"v%d" % i
        envs = json.loads(c.meta._apps["sf"].envs_json)
        assert envs["replica.partition_version"] == "3"
        assert "replica.split_pending" not in envs
        cli.close()
    finally:
        c.stop()


def test_unseedable_child_fails_the_open(cluster):
    """No resolvable seed source: the node raises instead of serving an
    empty child."""
    from pegasus_tpu_torch.meta.meta_server import RPC_OPEN_REPLICA
    from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcError

    node = next(iter(cluster.nodes))
    host, _, port = node.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        with pytest.raises(RpcError, match="cannot seed: parent 9.0"):
            conn.call(RPC_OPEN_REPLICA, codec.encode(mm.OpenReplicaRequest(
                app_name="ghost", app_id=9, pidx=1, ballot=1, primary=node,
                partition_count=2, learn_from=node, learn_pidx=0)),
                timeout=10)
    finally:
        conn.close()
    # registered only after a successful seed
    assert (9, 1) not in cluster.nodes[node]._service._replicas


def test_partition_groups_raise_by_name(tmp_path):
    from pegasus_tpu_torch.replication.replica_stub import ReplicaStub

    with pytest.raises(NotImplementedError, match="serve_groups.py"):
        ReplicaStub(str(tmp_path), ["127.0.0.1:1"], group_spec={"groups": 2})


# ---------------------------------------------------------- backup/restore

def test_cold_backup_and_restore(cluster, tmp_path):
    cli = make_client(cluster, "bk", partitions=2)
    for i in range(25):
        cli.set(b"bk%d" % i, b"s", b"bv%d" % i)
    root = str(tmp_path / "backups")
    r = cluster.ddl(RPC_CM_BACKUP_APP, mm.BackupAppRequest("bk", root),
                    mm.BackupAppResponse)
    assert r.error == 0 and r.backup_id > 0
    for i in range(25):
        cli.set(b"bk%d" % i, b"s", b"MUTATED")
    rr = cluster.ddl(RPC_CM_RESTORE_APP, mm.RestoreAppRequest(
        root, r.backup_id, "bk", "bk_restored"), mm.RestoreAppResponse)
    assert rr.error == 0, rr.error_text
    q = cluster.ddl(RPC_CM_QUERY_RESTORE, mm.QueryRestoreRequest(
        "bk_restored"), mm.QueryRestoreResponse)
    assert (q.status, q.done_partitions, q.total_partitions) == ("ok", 2, 2)
    rcli = PegasusClient(MetaResolver([cluster.meta_addr], "bk_restored"))
    for i in range(25):
        assert rcli.get(b"bk%d" % i, b"s") == b"bv%d" % i
    assert cli.get(b"bk3", b"s") == b"MUTATED"
    # a restored cuda engine holds its runs resident at once
    for stub in cluster.nodes.values():
        for (aid, _), rep in stub._replicas.items():
            if aid == rr.app_id:
                eng = rep.server.engine
                ssts = eng._all_ssts_locked()
                assert ssts and all(s._device_run is not None for s in ssts)
    cli.close()
    rcli.close()


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _backup_round(c, root):
    cli = make_client(c, "bt", partitions=2)
    for i in range(20):
        cli.set(b"t%d" % i, b"s", b"tv%d" % i)
    cli.close()
    r = c.ddl(RPC_CM_BACKUP_APP, mm.BackupAppRequest("bt", root),
              mm.BackupAppResponse)
    assert r.error == 0
    # the backup id is the wall clock in ms: mask it
    os.rename(os.path.join(root, str(r.backup_id)), os.path.join(root, "ID"))
    return r.backup_id


def test_backup_tree_matches_the_reference_and_restores_across(tmp_path,
                                                               frozen):
    """The same state backed up by a port cluster and by a pegasus_tpu
    cluster: the same files with the same bytes and the same
    backup_metadata keys (the backup id masked); then each package
    restores the other's backup with equal answers and digests."""
    roots = {"port": str(tmp_path / "bk_port"),
             "ref": str(tmp_path / "bk_ref")}
    port = Cluster(tmp_path / "port")
    ref = Cluster(tmp_path / "ref", kinds=("reference",) * 3, ref_meta=True)
    try:
        ids = {"port": _backup_round(port, roots["port"]),
               "ref": _backup_round(ref, roots["ref"])}
        trees = {k: _tree(v) for k, v in roots.items()}
        meta = {k: json.loads(t.pop(os.path.join("ID", "bt",
                                                 "backup_metadata")))
                for k, t in trees.items()}
        assert trees["port"] == trees["ref"]
        assert len(trees["port"]) >= 4
        assert meta["port"].keys() == meta["ref"].keys()
        for k in meta:
            assert meta[k].pop("backup_id") == ids[k]
        assert meta["port"] == meta["ref"]
        answers, digests = {}, {}
        for name, c, src in (("port", port, "ref"), ("ref", ref, "port")):
            # restore the other package's tree under its masked id
            os.rename(os.path.join(roots[src], "ID"),
                      os.path.join(roots[src], "1"))
            r = c.ddl(RPC_CM_RESTORE_APP, mm.RestoreAppRequest(
                roots[src], 1, "bt", "bt_r"), mm.RestoreAppResponse)
            os.rename(os.path.join(roots[src], "1"),
                      os.path.join(roots[src], "ID"))
            assert r.error == 0, r.error_text
            cli = PegasusClient(MetaResolver([c.meta_addr], "bt_r"))
            answers[name] = [cli.get(b"t%d" % i, b"s") for i in range(20)]
            cli.close()
            digests[name] = _one_per_partition(_partition_state(c, r.app_id))
        assert answers["port"] == answers["ref"] == \
            [b"tv%d" % i for i in range(20)]
        assert digests["port"] == digests["ref"]
    finally:
        port.stop()
        ref.stop()


# --------------------------------------------------------------- bulk load

def _provider(tmp_path, app, n_parts, n_total, files=2, tag=b"bl"):
    root = tmp_path / f"prov_{app}"
    per_part = {p: [] for p in range(n_parts)}
    for i in range(n_total):
        hk, sk, v = tag + b"%d" % i, b"s", b"val%d" % i
        h = key_schema.key_hash(key_schema.generate_key(hk, sk))
        per_part[h % n_parts].append((hk, sk, v, 0))
    for pidx, rows in per_part.items():
        pdir = root / app / str(n_parts) / str(pidx)
        pdir.mkdir(parents=True)
        for f in range(files):
            bl.write_raw_set(str(pdir / f"part{f}.raw"), rows[f::files])
    bl.write_metadata(str(root), app, n_parts)
    return str(root)


def test_bulk_load_end_to_end(cluster, tmp_path):
    cli = make_client(cluster, "blt", partitions=2)
    provider = _provider(tmp_path, "blt", 2, 60)
    r = cluster.ddl(RPC_CM_START_BULK_LOAD,
                    mm.StartBulkLoadRequest("blt", provider),
                    mm.StartBulkLoadResponse)
    assert r.error == 0, r.error_text
    assert r.ingested_records == 60
    for i in range(60):
        assert cli.get(b"bl%d" % i, b"s") == b"val%d" % i
    cli.close()


def _session_round(c, tmp_path, monkeypatch, meta_mod):
    """An async session: paused before the walk starts (the worker holds
    at 0 done), restarted, followed to succeed; a second start, a cancel
    and an unknown action are refused. -> every response's bytes."""
    import threading

    cli = make_client(c, "blas", partitions=2)
    provider = _provider(tmp_path, "blas", 2, 40)
    hold = threading.Event()
    real = meta_mod.MetaServer._bulk_load_worker

    def held_worker(meta, app, sess):
        hold.wait(10)
        return real(meta, app, sess)

    monkeypatch.setattr(meta_mod.MetaServer, "_bulk_load_worker",
                        held_worker)
    out = []

    def call(code, req, resp_cls):
        r = c.ddl(code, req, resp_cls)
        out.append(codec.encode(r))
        return r

    call(RPC_CM_QUERY_BULK_LOAD, mm.QueryBulkLoadRequest("blas"),
         mm.QueryBulkLoadResponse)
    call(RPC_CM_START_BULK_LOAD, mm.StartBulkLoadRequest(
        "blas", provider, async_start=True), mm.StartBulkLoadResponse)
    call(RPC_CM_CONTROL_BULK_LOAD, mm.ControlBulkLoadRequest(
        "blas", "pause"), mm.ControlBulkLoadResponse)
    hold.set()
    import time

    time.sleep(0.3)
    call(RPC_CM_QUERY_BULK_LOAD, mm.QueryBulkLoadRequest("blas"),
         mm.QueryBulkLoadResponse)
    call(RPC_CM_START_BULK_LOAD, mm.StartBulkLoadRequest(
        "blas", provider, async_start=True), mm.StartBulkLoadResponse)
    call(RPC_CM_CONTROL_BULK_LOAD, mm.ControlBulkLoadRequest(
        "blas", "pause"), mm.ControlBulkLoadResponse)
    call(RPC_CM_CONTROL_BULK_LOAD, mm.ControlBulkLoadRequest(
        "blas", "restart"), mm.ControlBulkLoadResponse)
    deadline = time.monotonic() + 30
    while True:
        r = c.ddl(RPC_CM_QUERY_BULK_LOAD, mm.QueryBulkLoadRequest("blas"),
                  mm.QueryBulkLoadResponse)
        if r.status == "succeed":
            break
        assert time.monotonic() < deadline, r
        time.sleep(0.05)
    out.append(codec.encode(r))
    call(RPC_CM_CONTROL_BULK_LOAD, mm.ControlBulkLoadRequest(
        "blas", "cancel"), mm.ControlBulkLoadResponse)
    call(RPC_CM_CONTROL_BULK_LOAD, mm.ControlBulkLoadRequest(
        "blas", "rewind"), mm.ControlBulkLoadResponse)
    call(RPC_CM_QUERY_BULK_LOAD, mm.QueryBulkLoadRequest("nope"),
         mm.QueryBulkLoadResponse)
    for i in range(40):
        assert cli.get(b"bl%d" % i, b"s") == b"val%d" % i
    cli.close()
    return out


def test_bulk_load_session_controls_match_the_reference(tmp_path,
                                                        monkeypatch):
    import pegasus_tpu.meta.meta_server as ref_meta_mod

    import pegasus_tpu_torch.meta.meta_server as port_meta_mod

    got, want = [], []
    port = Cluster(tmp_path / "port")
    try:
        got = _session_round(port, tmp_path / "port", monkeypatch,
                             port_meta_mod)
    finally:
        port.stop()
    ref = Cluster(tmp_path / "ref", ref_meta=True)
    try:
        want = _session_round(ref, tmp_path / "ref", monkeypatch,
                              ref_meta_mod)
    finally:
        ref.stop()
    assert got == want
    statuses = [codec.decode(mm.QueryBulkLoadResponse, b).status
                for b in (got[0], got[3], got[7])]
    assert statuses == ["none", "paused", "succeed"]


def test_bulk_load_survives_primary_failover(cluster, tmp_path):
    cli = make_client(cluster, "blf", partitions=1)
    provider = _provider(tmp_path, "blf", 1, 15, files=1, tag=b"fk")
    r = cluster.ddl(RPC_CM_START_BULK_LOAD,
                    mm.StartBulkLoadRequest("blf", provider),
                    mm.StartBulkLoadResponse)
    assert r.error == 0 and r.ingested_records == 15
    cfg = cluster.ddl(RPC_CM_QUERY_CONFIG, mm.QueryConfigRequest("blf"),
                      mm.QueryConfigResponse)
    cluster.kill_node(cfg.partitions[0].primary)
    for i in range(15):
        assert cli.get(b"fk%d" % i, b"s") == b"val%d" % i, f"lost fk{i}"
    cli.close()


def test_stub_bulk_load_ingests_locally(cluster, tmp_path):
    """RPC_BULK_LOAD: one node ingests its partition's set into its own
    engine and answers the record count as 8 little-endian bytes."""
    from pegasus_tpu_torch.meta.meta_server import RPC_BULK_LOAD
    from pegasus_tpu_torch.rpc.transport import RpcConnection

    cli = make_client(cluster, "bll", partitions=1)
    provider = _provider(tmp_path, "bll", 1, 12, files=1)
    pc = cluster.meta._parts[cli.resolver.app_id][0]
    host, _, port = pc.primary.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        _, body = conn.call(RPC_BULK_LOAD, codec.encode(mm.OpenReplicaRequest(
            app_name="bll", app_id=cli.resolver.app_id, pidx=0,
            partition_count=1, restore_dir=provider)), timeout=10)
    finally:
        conn.close()
    assert int.from_bytes(body, "little") == 12
    eng = cluster.replica(pc.primary, cli.resolver.app_id, 0).server.engine
    assert sum(1 for _ in eng.scan(b"", None, now=1)) == 12
    cli.close()


# --------------------------------------------------------- block service

def test_block_service_local_provider(tmp_path):
    from pegasus_tpu.runtime.block_service import \
        create_block_service as ref_create

    from pegasus_tpu_torch.runtime.block_service import create_block_service

    trees = {}
    for name, make in (("port", create_block_service), ("ref", ref_create)):
        bs = make("local_service", str(tmp_path / name / "store"))
        src = tmp_path / name / "f.txt"
        src.write_bytes(b"hello")
        bs.upload(str(src), "backups/1/f.txt")
        assert bs.exists("backups/1/f.txt")
        assert bs.read("backups/1/f.txt") == b"hello"
        assert bs.list_dir("backups/1") == ["f.txt"]
        dst = tmp_path / name / "out" / "f.txt"
        bs.download("backups/1/f.txt", str(dst))
        assert dst.read_bytes() == b"hello"
        bs.write("direct/x.bin", b"\x00\x01")
        assert bs.read("direct/x.bin") == b"\x00\x01"
        with pytest.raises(ValueError):
            bs.upload(str(src), "../escape.txt")
        assert bs.upload_dir(str(tmp_path / name / "out"), "dir") == 1
        assert bs.download_dir("dir", str(tmp_path / name / "back")) == 1
        with pytest.raises(ValueError, match="unknown block service"):
            make("hdfs", str(tmp_path))
        trees[name] = _tree(str(tmp_path / name / "store"))
    assert trees["port"] == trees["ref"]


# --------------------------------------------------------- backup policies

def _shell(c, line: str) -> str:
    import io

    from pegasus_tpu_torch.shell.main import Shell

    out = io.StringIO()
    Shell([c.meta_addr], out=out).run_line(line)
    return out.getvalue()


def test_backup_policy_schedule_and_retention(tmp_path):
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "bp", partitions=2)
        for i in range(20):
            cl.set(b"bk%d" % i, b"s", b"v%d" % i)
        root = str(tmp_path / "backups")
        assert "OK" in _shell(c, f"add_backup_policy daily {root} bp 100 2")
        assert "name=daily" in _shell(c, "ls_backup_policy")
        # three due runs with an advancing pinned clock; retention = 2
        ran = [c.meta.run_backup_policies(now=t) for t in (1000, 1100, 1200)]
        assert all(bid for r in ran for _, _, bid in r)
        assert c.meta.run_backup_policies(now=1201) == []
        kept = sorted(os.listdir(os.path.join(root, "daily")))
        assert kept == ["1100000", "1200000"], kept
        out = _shell(c, f"restore_app {root}/daily 1200000 bp bp_restored")
        assert "succeed" in out
        cr = PegasusClient(MetaResolver([c.meta_addr], "bp_restored"))
        for i in range(20):
            assert cr.get(b"bk%d" % i, b"s") == b"v%d" % i
        cr.close()
        assert "OK" in _shell(c, "disable_backup_policy daily")
        assert c.meta.run_backup_policies(now=5000) == []
        assert "OK" in _shell(c, "modify_backup_policy daily -i 7 -c 5")
        pol = c.meta._policies["daily"]
        assert pol["interval_seconds"] == 7 and pol["history_count"] == 5
        # the policies persist through state.json, as the reference's
        with open(c.meta.state_path) as f:
            assert json.load(f)["policies"]["daily"]["history_count"] == 5
        cl.close()
    finally:
        c.stop()


def test_backup_policy_validation(tmp_path):
    c = Cluster(tmp_path / "c", kinds=("port",))
    try:
        out = _shell(c, "add_backup_policy p1 /tmp/x nosuchapp 60")
        assert "no such app" in out
    finally:
        c.stop()


def test_meta_app_policy_timer_runs_due_policies(tmp_path):
    """The meta app's policy tick backs up every due policy's apps (the
    port's MetaApp timer, every max(check_interval, 5) s)."""
    from pegasus_tpu_torch.runtime.config import Config
    from pegasus_tpu_torch.runtime.service_app import MetaApp

    ini = ("[apps.meta]\ntype = meta\nport = 0\n"
           f"state_dir = {tmp_path / 'meta'}\n"
           "[failure_detector]\ncheck_interval_seconds = 3600\n")
    app = MetaApp("meta", Config(text=ini), "apps.meta").start()
    # the harness around the app's meta: three port nodes
    c = Cluster.__new__(Cluster)
    c.meta, c.meta_addr = app.meta, app.address
    c.nodes, c.kinds, c.dirs = {}, {}, {}
    try:
        for i in range(3):
            c.start_node(tmp_path / f"node{i}", "port")
        cl = make_client(c, "tick", partitions=2)
        cl.set(b"a", b"s", b"v")
        cl.close()
        root = str(tmp_path / "pol")
        assert "OK" in _shell(c, f"add_backup_policy hourly {root} tick 3600")
        assert app._policy_timer is not None and app._policy_timer.is_alive()
        app._policy_tick()
        pol = app.meta._policies["hourly"]
        assert len(pol["recent_backup_ids"]) == 1
        bid = pol["recent_backup_ids"][0]
        assert os.path.exists(os.path.join(root, "hourly", str(bid), "tick",
                                           "backup_metadata"))
        app._policy_tick()  # not due again for an hour
        assert app.meta._policies["hourly"]["recent_backup_ids"] == [bid]
    finally:
        for s in c.nodes.values():
            s.stop()
        app.stop()


# ------------------------------------------------------------ the wire

def test_closed_connection_ends_its_threads():
    """A client that closes its connection ends its reader thread and the
    server's thread for it at once. A split's re-routed writes drop and
    reopen connections many times a second, and each close used to leave
    both threads blocked for the life of the processes."""
    import threading
    import time

    from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcServer

    srv = RpcServer()
    srv.register("RPC_TEST_ECHO", lambda h, b: b)
    srv.start()
    try:
        conns = [RpcConnection(srv.address) for _ in range(20)]
        for c in conns:
            assert c.call("RPC_TEST_ECHO", b"x", timeout=10)[1] == b"x"
        opened = threading.active_count()
        for c in conns:
            c.close()
        # each connection: a reader here and a serving thread in the server
        deadline = time.monotonic() + 5
        while threading.active_count() > opened - 40:
            assert time.monotonic() < deadline, threading.active_count()
            time.sleep(0.02)
        assert not any(c._reader.is_alive() for c in conns)
    finally:
        srv.stop()


# ------------------------------------------- digests of a split's seeds

def test_crc64_batch_and_update_equal_the_reference():
    """crc64_batch (records longest first, short ones in transposed
    chunks, long ones byte by byte) equals the reference's on records of
    0 to 3000 bytes in any arena order, and crc64_update over a record's
    parts equals the record hashed whole."""
    from pegasus_tpu.base.crc64 import crc64_batch as ref_batch

    from pegasus_tpu_torch.base.crc64 import MASK, crc64_batch, crc64_update

    rng = np.random.default_rng(11)
    for hi in (1, 3, 40, 300, 3000):
        n = int(rng.integers(1, 4000))
        lens = rng.integers(0, hi, n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        perm = rng.permutation(n)
        arena = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
        got = crc64_batch(arena, offs[perm], lens[perm])
        assert (got == ref_batch(arena, offs[perm], lens[perm])).all()
        cut = lens // 3
        mid = crc64_update(np.full(n, MASK, np.uint64), arena, offs, cut)
        whole = crc64_update(mid, arena, offs + cut, lens - cut)
        assert (whole ^ np.uint64(MASK) == crc64_batch(arena, offs, lens)).all()


@pytest.mark.parametrize("compacted", [False, True])
def test_loaded_engine_with_newer_files_digests_by_array_ops(tmp_path,
                                                             compacted):
    """A split parent's checkpoint: a base run (a bulk-loaded L0 file, or
    a compacted level) under newer flushed files of updates, deletes and
    expired rows, and a memtable. The digest takes the array path
    (_single_run_digest_rows) and equals the merged scan's and the
    reference engine's, with and without an ownership mask."""
    from pegasus_tpu.base.value_schema import SCHEMAS as REF_SCHEMAS
    from pegasus_tpu.engine.db import EngineOptions as RefOptions
    from pegasus_tpu.engine.db import LsmEngine as RefEngine
    from pegasus_tpu.engine.db import WriteBatch as RefBatch

    from pegasus_tpu_torch.base.crc64 import crc64_batch
    from pegasus_tpu_torch.base.value_schema import SCHEMAS
    from pegasus_tpu_torch.engine.db import (EngineOptions, LsmEngine,
                                             WriteBatch)

    now = 1000
    ref = RefEngine(str(tmp_path / "ref"), RefOptions(backend="cpu"))
    port = LsmEngine(str(tmp_path / "port"), EngineOptions(device="cpu"))
    rng = np.random.default_rng(5)
    try:
        decree = 0
        for step in range(4):
            batch = []
            for i in range(600 if step == 0 else 40):
                k = int(rng.integers(0, 600))
                key = key_schema.generate_key(b"h%03d" % (k % 97),
                                              b"s%d" % k)
                op = int(rng.integers(0, 5)) if step else 0
                exp = now - 1 if op == 1 else (now + 50 if op == 2 else 0)
                batch.append((key, op, exp, b"v%d.%d" % (step, i)))
            decree += 1
            for eng, bcls, sch in ((ref, RefBatch, REF_SCHEMAS),
                                   (port, WriteBatch, SCHEMAS)):
                wb = bcls()
                for key, op, exp, val in batch:
                    if op == 3:
                        wb.delete(key)
                    else:
                        wb.put(key, sch[2].generate_value(exp, 0, val), exp)
                eng.write_batch([(wb, decree)])
                if step < 3:
                    eng.flush()
                if step == 0 and compacted:
                    eng.manual_compact(now=now)
        assert len(port._mem) > 0 and len(port._l0) >= 2
        for pmask in (0, 3):
            fast = port._single_run_digest_rows(now, pmask)
            assert fast is not None
            crcs = [crc64_batch(*r)
                    for r in port._merged_digest_rows(now, pmask)]
            xor = add = 0
            for c in crcs:
                xor ^= int(np.bitwise_xor.reduce(c)) if len(c) else 0
                add = (add + int(c.sum(dtype=np.uint64))) & (2 ** 64 - 1)
            got = port.state_digest(now=now, pmask=pmask)
            assert got["digest"] == f"{xor:016x}{add:016x}"
            assert got["records"] == sum(len(c) for c in crcs)
            assert got == ref.state_digest(now=now, pmask=pmask)
    finally:
        ref.close()
        port.close()
