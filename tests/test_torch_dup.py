"""Cross-cluster duplication in the port, on the CPU, held to pegasus_tpu.

The shipper's RPC_DUPLICATE frames equal the reference shipper's for the
same log mutations, on its windowed and its per-mutation path. Then
tests/test_dup_backup_admin.py's duplication scenarios on two port
clusters (the harness of tests/test_torch_cluster.py with a cluster id
and a [pegasus.clusters] map): the lifecycle through the shell, a frozen
add then start, a primary failover with the logs GC'd behind the durable
state (the duplication floor keeps what the promoted primary must catch
up from), and the block-ship bootstrap with its resume and the
cross-cluster audit. Across the packages: a port source and a reference
source each duplicate one table into a port and a reference destination
with the replicas' clock pinned; all four destinations hold equal state
digests at the confirmed decree, and two write-write conflicts resolve
to the same winners in each. Storage holds no tolerance: every
comparison is byte equality.
"""

import dataclasses
import io
import json
import os
import time

import pytest

from pegasus_tpu_torch.replication.duplicator import MutationDuplicator
from pegasus_tpu_torch.replication.mutation_log import LogMutation
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc import messages as msg
from pegasus_tpu_torch.rpc.task_codes import (RPC_BULK_LOAD_INGEST,
                                              RPC_DUPLICATE, RPC_MULTI_PUT,
                                              RPC_PUT, RPC_REMOVE)
from pegasus_tpu_torch.rpc.transport import RpcServer
from pegasus_tpu_torch.shell.main import Shell
from tests.test_torch_cluster import Cluster, make_client
from tests.test_torch_replication import _FrozenTime


def wait_until(fn, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def shell_run(cluster, line: str) -> str:
    out = io.StringIO()
    sh = Shell([cluster.meta_addr], out=out)
    try:
        sh.run_line(line)
    finally:
        sh.pool.close()
    return out.getvalue()


# --------------------------------------------------------------- the wire


class _Resolver:
    """A remote table of `pcount` partitions all served at `addr`."""

    def __init__(self, addr, app_id=7, pcount=4):
        self.addr, self.app_id, self.partition_count = addr, app_id, pcount

    def resolve(self, pidx, refresh=False):
        return self.addr

    def refresh(self):
        pass


def _mutations(m, first=1):
    """Log mutations of every duplicable kind plus an ingest (skipped) and
    a duplicate (never re-duplicated), in package `m`'s messages."""
    bodies = [
        (RPC_PUT, m.UpdateRequest(key=b"\x00\x02hkput", value=b"v1",
                                  expire_ts_seconds=7)),
        (RPC_MULTI_PUT, m.MultiPutRequest(
            hash_key=b"mh", kvs=[m.KeyValue(b"s1", b"a"),
                                 m.KeyValue(b"s2", b"b")])),
        (RPC_REMOVE, m.KeyRequest(b"\x00\x02hkgone")),
        (RPC_BULK_LOAD_INGEST, m.BulkLoadIngestRequest("/x", "t", 4)),
        (RPC_DUPLICATE, m.DuplicateRequest(timestamp=5, task_code=RPC_PUT)),
    ]
    from pegasus_tpu.rpc import codec as ref_codec

    enc = codec.encode if m is msg else ref_codec.encode
    return [(first + i, code, enc(req)) for i, (code, req) in
            enumerate(bodies)]


@pytest.mark.parametrize("path", ["window", "single"])
def test_duplicate_frames_equal_reference(path):
    """The same log mutations through the port's shipper and the
    reference's reach a server as the same RPC_DUPLICATE frames: header
    fields (code, app id, partition index and hash, sharded) and body
    bytes (timestamp, task code, raw message, cluster id,
    verify_timetag). The window path ships them as one wave, the single
    path one by one."""
    from pegasus_tpu.replication.duplicator import \
        MutationDuplicator as RefDuplicator
    from pegasus_tpu.replication.mutation_log import \
        LogMutation as RefLogMutation
    from pegasus_tpu.rpc import messages as ref_msg

    got = []

    def on_dup(header, body):
        got.append((dataclasses.replace(header, seq=0), body))
        return codec.encode(msg.DuplicateResponse())

    srv = RpcServer().start()
    srv.register(RPC_DUPLICATE, on_dup)
    frames = {}
    try:
        for name, cls, lm, m in (("port", MutationDuplicator, LogMutation,
                                  msg),
                                 ("reference", RefDuplicator, RefLogMutation,
                                  ref_msg)):
            got.clear()
            d = cls(_Resolver(srv.address), cluster_id=3, dupid=9,
                    paused=True)
            try:
                ms = [lm(decree=dec, ballot=2, timestamp_us=1_700_000_000 +
                         dec, codes=[code], bodies=[body])
                      for dec, code, body in _mutations(m)]
                if path == "window":
                    for lmut in ms:
                        d.on_commit(lmut)
                    d.set_paused(False)
                else:
                    d.set_paused(False)
                    for lmut in ms:   # one at a time: each its own batch
                        d.on_commit(lmut)
                        assert d.flush(10.0)
                assert d.flush(10.0)
                assert d.last_shipped_decree == ms[-1].decree
                assert (d.shipped, d.skipped) == (3, 1)
            finally:
                d.stop()
            frames[name] = list(got)
    finally:
        srv.stop()
    assert len(frames["port"]) == 3
    assert frames["port"] == frames["reference"]
    for header, body in frames["port"]:
        assert header.code == RPC_DUPLICATE and header.app_id == 7
        assert header.sharded == (path == "window")
        req = codec.decode(msg.DuplicateRequest, body)
        assert req.cluster_id == 3 and req.verify_timetag
        assert req.timestamp > 1_700_000_000


def test_ship_stopped_mid_retry_confirms_nothing_later(tmp_path):
    """A shipper stopped while it retries an undelivered decree (its
    remote down, fail mode slow) confirms neither that decree nor a later
    one, even one with nothing to ship (an ingest), and persists the last
    decree it did deliver. The reference went on through its batch and
    recorded the ingest's decree as confirmed, so a restarted shipper
    would skip the undelivered write for good."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()   # nothing listens there
    d = MutationDuplicator(_Resolver(dead), dupid=4, paused=True,
                           progress_dir=str(tmp_path), confirmed_floor=10)
    muts = _mutations(msg, first=11)
    d.on_commit(LogMutation(decree=11, timestamp_us=1, codes=[muts[0][1]],
                            bodies=[muts[0][2]]))
    d.on_commit(LogMutation(decree=12, timestamp_us=2, codes=[muts[3][1]],
                            bodies=[muts[3][2]]))
    d.set_paused(False)
    time.sleep(0.5)   # the window failed; decree 11 retries
    d.stop()
    assert d.last_shipped_decree == 10
    with open(tmp_path / "dup_4.json") as f:
        assert json.load(f) == {"dupid": 4, "confirmed_decree": 10}


def test_catch_up_refuses_a_log_that_skips_unconfirmed_decrees(tmp_path):
    """A shipper confirmed through decree 5 catches up only from a log
    holding decree 6 on, or from an empty log with nothing committed past
    5; a hole raises DuplicationGap and queues nothing. With nothing
    confirmed it ships what the log holds."""
    from pegasus_tpu_torch.replication.duplicator import DuplicationGap
    from pegasus_tpu_torch.replication.mutation_log import MutationLog

    plog = MutationLog(str(tmp_path / "log"))
    body = _mutations(msg)[0]
    for dec in range(8, 11):
        plog.append(LogMutation(decree=dec, timestamp_us=dec,
                                codes=[body[1]], bodies=[body[2]]))

    def shipper(floor):
        return MutationDuplicator(_Resolver(("127.0.0.1", 1)), paused=True,
                                  confirmed_floor=floor)

    for floor, committed, want in [(5, 10, DuplicationGap), (7, 10, 3),
                                   (0, 10, 3), (10, 10, 0), (10, 12,
                                                             DuplicationGap)]:
        d = shipper(floor)
        try:
            if want is DuplicationGap:
                with pytest.raises(DuplicationGap):
                    d.catch_up(plog, committed=committed)
                assert d._queue == []
            else:
                assert d.catch_up(plog, committed=committed) == want
        finally:
            d.stop()
    plog.close()


# ------------------------------------------------------- port to port


@pytest.fixture
def two_clusters(tmp_path):
    b = Cluster(tmp_path / "west", cluster_id=2)
    a = Cluster(tmp_path / "east", cluster_id=1,
                remote_clusters={"west": [b.meta_addr]})
    try:
        yield a, b
    finally:
        a.stop()
        b.stop()


def test_duplication_lifecycle_between_clusters(two_clusters):
    a, b = two_clusters
    ca = make_client(a, "dt", partitions=2)
    cb = make_client(b, "dt", partitions=2)
    out = shell_run(a, "add_dup dt west")
    assert "succeed" in out and "dupid: 1" in out
    out = shell_run(a, "query_dup dt")
    assert "dupid=1" in out and "status=start" in out and "remote=west" in out
    assert "already exists" in shell_run(a, "add_dup dt west")
    for i in range(10):
        ca.set(b"dk%d" % i, b"s", b"v%d" % i)
    assert wait_until(lambda: all(
        cb.get(b"dk%d" % i, b"s") == b"v%d" % i for i in range(10)))
    # pause: new writes queue, nothing ships
    assert "succeed" in shell_run(a, "pause_dup dt 1")
    time.sleep(0.3)
    for i in range(10, 15):
        ca.set(b"dk%d" % i, b"s", b"v%d" % i)
    time.sleep(1.0)
    assert all(cb.get(b"dk%d" % i, b"s") is None for i in range(10, 15))
    # start again: the kept backlog ships
    assert "succeed" in shell_run(a, "start_dup dt 1")
    assert wait_until(lambda: all(
        cb.get(b"dk%d" % i, b"s") == b"v%d" % i for i in range(10, 15)))
    # the fail mode reaches the live shippers
    assert "succeed" in shell_run(a, "set_dup_fail_mode dt 1 skip")
    assert wait_until(lambda: any(
        d.fail_mode == "skip" for stub in a.nodes.values()
        for rep in stub._replicas.values()
        for d in rep.duplicators.values()))
    # the beacons fold each primary's confirmed decree into the entry
    app_id = ca.resolver.app_id
    assert wait_until(lambda: len(a.meta._dups[app_id][0].get(
        "confirmed", {})) == 2)
    # remove: shippers torn down, their lag gauges gone, writes stay home
    assert "succeed" in shell_run(a, "remove_dup dt 1")
    assert wait_until(lambda: all(
        not rep.duplicators for stub in a.nodes.values()
        for rep in stub._replicas.values()))
    from pegasus_tpu_torch.runtime.perf_counters import counters

    assert not [n for n in counters.snapshot()
                if n.startswith(f"dup.lag.{app_id}.")]
    ca.set(b"post_remove", b"s", b"x")
    time.sleep(0.8)
    assert cb.get(b"post_remove", b"s") is None
    assert "dupid" not in shell_run(a, "query_dup dt").replace("(none)", "")
    ca.close()
    cb.close()


def test_duplication_freeze_then_start(two_clusters):
    a, b = two_clusters
    ca = make_client(a, "fz", partitions=1)
    cb = make_client(b, "fz", partitions=1)
    assert "freeze: true" in shell_run(a, "add_dup fz west -f")
    ca.set(b"h", b"s", b"frozen")
    time.sleep(0.8)
    assert cb.get(b"h", b"s") is None        # init: registered, not shipping
    assert "succeed" in shell_run(a, "start_dup fz 1")
    # catch_up replays the log written while frozen
    assert wait_until(lambda: cb.get(b"h", b"s") == b"frozen")
    ca.close()
    cb.close()


def test_duplication_survives_primary_failover(two_clusters):
    """The shippers survive a primary's death: paused writes the dead
    primary only queued are caught up by the promoted primary from its
    own log, which gc_log held at the duplication's confirmed decree
    although every replica's state is durable past it (the logs roll a
    segment per append). Without the floor the log drops those writes and
    they never reach the destination."""
    a, b = two_clusters
    ca = make_client(a, "fo", partitions=1)
    cb = make_client(b, "fo", partitions=1)
    app_id = ca.resolver.app_id
    pc = a.meta._parts[app_id][0]
    members = [pc.primary] + list(pc.secondaries)
    for m in members:
        a.replica(m, app_id, 0).plog.segment_bytes = 1
    assert "succeed" in shell_run(a, "add_dup fo west")
    for i in range(5):
        ca.set(b"pre%d" % i, b"s", b"v%d" % i)
    assert wait_until(lambda: cb.get(b"pre4", b"s") == b"v4")
    assert wait_until(lambda: any(
        int(v) > 0 for e in a.meta._dups.get(app_id, [])
        for v in e.get("confirmed", {}).values()))
    assert "succeed" in shell_run(a, "pause_dup fo 1")
    time.sleep(0.3)
    for i in range(5, 10):
        ca.set(b"pre%d" % i, b"s", b"v%d" % i)
    a.replica(pc.primary, app_id, 0).broadcast_commit_point()
    for m in members:
        rep = a.replica(m, app_id, 0)
        rep.gc_log(flush=True)
        assert rep.server.engine.last_durable_decree() >= 10
    victim = pc.primary
    a.kill_node(victim)
    assert a.meta._parts[app_id][0].primary in members[1:]
    assert "succeed" in shell_run(a, "start_dup fo 1")
    assert wait_until(lambda: all(
        cb.get(b"pre%d" % i, b"s") == b"v%d" % i for i in range(10)))
    ca.close()
    cb.close()


def test_relearned_replica_promoted_while_duplication_lags(two_clusters):
    """A replica that relearned while the duplication lagged, then took
    the primary (a propose, as balance moves primaries to a returned
    node), ships the decrees between the confirmed one and its learned
    checkpoint: the learn's tail reaches back to the duplication floor
    and the learner keeps it in its log. Before, the learner's log began
    at its checkpoint, its shipper caught up from there, and the paused
    writes never reached the destination."""
    from pegasus_tpu_torch.runtime.perf_counters import counters

    a, b = two_clusters
    ca = make_client(a, "rl", partitions=1)
    cb = make_client(b, "rl", partitions=1)
    app_id = ca.resolver.app_id
    pc = a.meta._parts[app_id][0]
    primary, keep, victim = pc.primary, pc.secondaries[0], pc.secondaries[1]
    for m in (primary, keep, victim):
        a.replica(m, app_id, 0).plog.segment_bytes = 1
    assert "succeed" in shell_run(a, "add_dup rl west")
    for i in range(5):
        ca.set(b"rl%d" % i, b"s", b"v%d" % i)
    assert wait_until(lambda: cb.get(b"rl4", b"s") == b"v4")
    assert wait_until(lambda: any(
        int(v) > 0 for e in a.meta._dups.get(app_id, [])
        for v in e.get("confirmed", {}).values()))
    a.meta.push_dup_envs()   # the members' log floors: the confirmed decree
    assert "succeed" in shell_run(a, "pause_dup rl 1")
    time.sleep(0.3)
    a.kill_node(victim)
    for i in range(5, 10):   # not shipped, and missed by the victim
        ca.set(b"rl%d" % i, b"s", b"v%d" % i)
    a.replica(primary, app_id, 0).broadcast_commit_point()
    for m in (primary, keep):
        rep = a.replica(m, app_id, 0)
        rep.gc_log(flush=True)
        assert rep.server.engine.last_durable_decree() >= 10
    a.restart_node(victim)
    assert wait_until(lambda: victim in a.meta._alive_nodes_locked())
    assert a.meta.repair_under_replication() == 1
    assert victim in a.meta._parts[app_id][0].secondaries
    learned = a.replica(victim, app_id, 0)
    assert learned.server.engine.last_committed_decree() >= 10
    gaps = counters.number("dup.gap_count").value()
    sh = Shell([a.meta_addr], out=io.StringIO())
    try:
        sh.run_line("use rl")
        sh.run_line(f"propose 0 {victim}")
        assert "OK" in sh.out.getvalue()
    finally:
        sh.pool.close()
    assert a.meta._parts[app_id][0].primary == victim
    assert "succeed" in shell_run(a, "start_dup rl 1")
    assert wait_until(lambda: all(
        cb.get(b"rl%d" % i, b"s") == b"v%d" % i for i in range(10)))
    assert set(learned.duplicators) == {1}
    assert counters.number("dup.gap_count").value() == gaps
    ca.close()
    cb.close()


def test_bootstrap_by_block_ship_then_cross_cluster_audit(two_clusters,
                                                          tmp_path):
    """A fresh destination seeds by block ship: the source checkpoints
    stream into a provider tree and the destination ingests them
    replicated; a re-run ships no block; then the live leg, and the
    cross-cluster audit anchored at the confirmed decrees matches, with
    equal record counts; the shell prints the same verdict."""
    from pegasus_tpu_torch.collector.cluster_doctor import \
        run_cross_cluster_audit
    from pegasus_tpu_torch.replication.bootstrap import \
        bootstrap_remote_cluster

    a, b = two_clusters
    ca = make_client(a, "bs", partitions=2)
    cb = make_client(b, "bs", partitions=2)
    for i in range(60):
        ca.set(b"bk%03d" % i, b"s", b"bv%d" % i)
    for stub in a.nodes.values():
        for rep in list(stub._replicas.values()):
            rep.server.engine.flush()
    stats = bootstrap_remote_cluster(
        [a.meta_addr], [b.meta_addr], "bs",
        provider_root=str(tmp_path / "provider"))
    assert stats["partitions"] == 2
    assert stats["blocks"] > 0 and stats["bytes"] > 0
    assert stats["ingested_records"] == 60
    assert all(cb.get(b"bk%03d" % i, b"s") == b"bv%d" % i
               for i in range(60))
    stats2 = bootstrap_remote_cluster(
        [a.meta_addr], [b.meta_addr], "bs",
        provider_root=str(tmp_path / "provider"))
    assert stats2["blocks"] == 0 and stats2["resumed"] > 0
    assert "succeed" in shell_run(a, "add_dup bs west")
    for i in range(60, 80):
        ca.set(b"bk%03d" % i, b"s", b"bv%d" % i)
    assert wait_until(lambda: all(
        cb.get(b"bk%03d" % i, b"s") == b"bv%d" % i for i in range(60, 80)))
    x = run_cross_cluster_audit([a.meta_addr], [b.meta_addr], "bs")
    assert x["match"] is True, x
    assert x["src"]["records"] == x["dst"]["records"] == 80
    assert set(x["anchors"]) == {f"{ca.resolver.app_id}.{p}" for p in (0, 1)}
    out = shell_run(a, f"cross_cluster_audit bs {b.meta_addr}")
    assert "cross-cluster audit OK: 80 records" in out
    ca.close()
    cb.close()


# ------------------------------------------------------ across packages


def test_destination_digests_equal_across_packages(tmp_path, monkeypatch):
    """A port source and a reference source, each duplicating one table
    into a port and a reference destination (port->port, port->reference,
    reference->port, reference->reference), with the replicas' clock
    pinned in both packages. The same writes, paused and then shipped,
    leave all four destinations with equal state digests per partition
    at the confirmed decrees, the two sources with equal digests too;
    and two write-write conflicts resolve alike everywhere: a destination
    value older than the shipped one loses, a newer one wins."""
    import pegasus_tpu.replication.replica as ref_rp
    import pegasus_tpu_torch.replication.replica as port_rp

    clock = _FrozenTime(time, 1.7e9)
    monkeypatch.setattr(port_rp, "time", clock)
    monkeypatch.setattr(ref_rp, "time", clock)
    dst = {"p": Cluster(tmp_path / "dp", cluster_id=2),
           "r": Cluster(tmp_path / "dr", kinds=("reference",) * 3,
                        ref_meta=True, cluster_id=2)}
    remotes = {"wp": [dst["p"].meta_addr], "wr": [dst["r"].meta_addr]}
    src = {"p": Cluster(tmp_path / "sp", cluster_id=1,
                        remote_clusters=remotes),
           "r": Cluster(tmp_path / "sr", kinds=("reference",) * 3,
                        ref_meta=True, cluster_id=1,
                        remote_clusters=remotes)}
    tables = {"p": "from_port", "r": "from_ref"}
    clients = []
    try:
        cs = {k: make_client(src[k], tables[k], partitions=2) for k in src}
        cd = {(k, t): make_client(dst[k], t, partitions=2)
              for k in dst for t in tables.values()}
        clients += list(cs.values()) + list(cd.values())
        for k, c in src.items():
            for remote in ("wp", "wr"):
                assert "succeed" in shell_run(c, f"add_dup {tables[k]} "
                                                 f"{remote}")
                dupid = shell_run(c, f"query_dup {tables[k]}").count("dupid=")
                assert "succeed" in shell_run(c, f"pause_dup {tables[k]} "
                                                 f"{dupid}")
        # destination writes: c1 older than the shipped value, c2 newer
        clock._t = 1.7e9 + 1
        for cli in cd.values():
            cli.set(b"c1", b"s", b"dst")
        clock._t = 1.7e9 + 2
        for k, cli in cs.items():
            for i in range(24):
                cli.set(b"k%02d" % i, b"s", b"v%d" % i)
            cli.multi_set(b"mh", {b"a": b"1", b"b": b"2"})
            cli.delete(b"k03", b"s")
            cli.set(b"c1", b"s", b"src")
            cli.set(b"c2", b"s", b"src")
        clock._t = 1.7e9 + 3
        for cli in cd.values():
            cli.set(b"c2", b"s", b"dst")
        for k, c in src.items():
            for dupid in (1, 2):
                assert "succeed" in shell_run(c, f"start_dup {tables[k]} "
                                                 f"{dupid}")

        def confirmed(k):
            c, app_id = src[k], cs[k].resolver.app_id
            last = {p: c.replica(c.meta._parts[app_id][p].primary, app_id,
                                 p).last_committed for p in (0, 1)}
            return all(int(e.get("confirmed", {}).get(str(p), 0)) >= last[p]
                       for e in c.meta._dups[app_id] for p in (0, 1))

        assert wait_until(lambda: confirmed("p") and confirmed("r"), 30)
        for cli in cd.values():
            assert cli.get(b"c1", b"s") == b"src"
            assert cli.get(b"c2", b"s") == b"dst"
            assert cli.get(b"k03", b"s") is None
            assert cli.get(b"k04", b"s") == b"v4"
        digests = {}
        for (k, t), cli in cd.items():
            app_id = cli.resolver.app_id
            digests[(k, t)] = [set(dst[k].digests(app_id, p).values())
                               for p in (0, 1)]
        first = next(iter(digests.values()))
        assert all(len(s) == 1 for s in first)
        assert all(v == first for v in digests.values()), digests
        src_digests = [[set(src[k].digests(cs[k].resolver.app_id, p)
                            .values()) for p in (0, 1)] for k in src]
        assert src_digests[0] == src_digests[1]
    finally:
        for cli in clients:
            cli.close()
        for c in list(src.values()) + list(dst.values()):
            c.stop()
