"""The port's PacificA replication against the JAX package's.

Three parts:

  * the mutation log: the port writes the same segment bytes as the
    reference for the same mutations (segment rolls included), and each
    package replays the other's log, a torn tail included;
  * a port ReplicaGroup and a reference ReplicaGroup (backend "cpu", and
    "tpu" on the JAX CPU platform) take the same writes, kills, restarts
    and learns with time.time pinned in both replica modules; afterwards
    every replica of both groups has the same state_digest and the
    primaries' plogs are byte-equal;
  * the cases of tests/test_replication.py, run on the port (engines on
    the cuda backend with device="cpu", the plain kernel versions).
"""

import os
import struct
import threading
import time

import numpy as np
import pytest

from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.replication import LogMutation as RefLogMutation
from pegasus_tpu.replication import MutationLog as RefMutationLog
from pegasus_tpu.replication import ReplicaGroup as RefGroup
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu_torch.base import key_schema
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.engine.replica_service import WRITE_CODES
from pegasus_tpu_torch.replication import (LogMutation, MutationLog,
                                           ReplicaError, ReplicaGroup)
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc import messages as msg
from pegasus_tpu_torch.rpc.messages import Status
from pegasus_tpu_torch.rpc.task_codes import RPC_MULTI_PUT, RPC_PUT, RPC_REMOVE
from pegasus_tpu_torch.runtime import fail_points as fp

NOW = 1_700_000_000


def K(i):
    return key_schema.generate_key(b"h%d" % (i % 17), b"s%05d" % i)


def put_req(i, gen=0, m=msg):
    return m.UpdateRequest(K(i), b"val%d.%d" % (i, gen), 0)


def _opts():
    return EngineOptions(device="cpu")


def _group(root, **kw):
    return ReplicaGroup(str(root), n=3, options_factory=_opts, **kw)


class _FrozenTime:
    """time.time() frozen so LogMutation timestamps (and the value
    timetags built from them) are reproducible; the rest passes
    through."""

    def __init__(self, real, t=1.7e9):
        self._real = real
        self._t = t

    def time(self):
        return self._t

    def __getattr__(self, name):
        return getattr(self._real, name)


def _plog_bytes(plog_dir):
    out = {}
    for name in sorted(os.listdir(plog_dir)):
        if name.startswith("log."):
            with open(os.path.join(plog_dir, name), "rb") as f:
                out[name] = f.read()
    return out


# ------------------------------------------------- plog across packages


def _mutations(mod, n=40):
    rng = np.random.default_rng(3)
    out = []
    for d in range(1, n + 1):
        k = int(rng.integers(1, 4))
        out.append(mod(decree=d, ballot=1 + d // 10,
                       timestamp_us=1_700_000_000_000_000 + d,
                       codes=["RPC_RRDB_RRDB_PUT"] * k,
                       bodies=[rng.bytes(int(rng.integers(0, 90)))
                               for _ in range(k)]))
    return out


@pytest.mark.parametrize("torn", [False, True])
def test_plog_segments_byte_equal_and_cross_replay(tmp_path, torn):
    """The same mutations (single appends and windows, 512-byte segments
    so the log rolls) give byte-equal segments in both packages, and each
    package replays the other's log; a torn tail (a crash mid-append: a
    frame header and part of its payload) stops both replays at the tear
    and is truncated away."""
    logs = {}
    for name, mlog, lm in (("port", MutationLog, LogMutation),
                           ("ref", RefMutationLog, RefLogMutation)):
        log = mlog(str(tmp_path / name), segment_bytes=512)
        ms = _mutations(lm)
        for i in range(0, 20):
            log.append(ms[i])
        for i in range(20, 40, 5):
            log.append_window(ms[i:i + 5])
        log.close()
        logs[name] = str(tmp_path / name)
    port_b, ref_b = _plog_bytes(logs["port"]), _plog_bytes(logs["ref"])
    assert len(port_b) > 2 and port_b == ref_b
    want = [(m.decree, m.ballot, m.timestamp_us, m.codes, m.bodies)
            for m in _mutations(LogMutation)]
    if torn:
        for d in logs.values():
            seg = os.path.join(d, sorted(os.listdir(d),
                                         key=lambda n: int(n[4:]))[-1])
            with open(seg, "ab") as f:
                f.write(struct.pack("<II", 100, 0) + b"\x99" * 7)
    for reader, d in ((MutationLog, logs["ref"]),
                      (RefMutationLog, logs["port"])):
        log = reader(d)
        got = [(m.decree, m.ballot, m.timestamp_us, m.codes, m.bodies)
               for m in log.replay(0)]
        assert got == want
        assert log.last_decree == 40
        assert [m.decree for m in log.replay(33)] == list(range(34, 41))
        log.close()
    if torn:  # both replays truncated the tear away again
        assert _plog_bytes(logs["port"]) == _plog_bytes(logs["ref"]) == ref_b


# --------------------------------------------- groups across packages


def _drive(group, mod, rng_seed=11):
    """The same writes, kills, restarts and learns on a group of either
    package; -> the keys touched."""
    rng = np.random.default_rng(rng_seed)
    keys = set()

    def burst(lo, hi):
        for i in range(lo, hi):
            kind = int(rng.integers(0, 5))
            if kind < 3:
                group.write(RPC_PUT, put_req(i, kind, mod))
                keys.add(K(i))
            elif kind == 3:
                group.write(RPC_REMOVE, mod.KeyRequest(K(i - 3)))
                keys.add(K(i - 3))
            else:
                hk = b"mh%d" % (i % 7)
                group.write(RPC_MULTI_PUT, mod.MultiPutRequest(
                    hash_key=hk, kvs=[mod.KeyValue(b"s%d" % j, b"mv%d.%d"
                                                   % (i, j))
                                      for j in range(3)],
                    expire_ts_seconds=0))
                keys.update(key_schema.generate_key(hk, b"s%d" % j)
                            for j in range(3))

    burst(0, 80)
    group.primary_replica().server.engine.flush()
    victim = next(n for n in group.names if n != group.primary)
    group.kill(victim)
    burst(80, 140)
    group.restart(victim)            # learns checkpoint + tail
    burst(140, 170)
    group.kill(group.primary)        # failover
    burst(170, 200)
    dead = next(n for n in group.names if n not in group.alive)
    group.restart(dead)
    burst(200, 220)
    group.primary_replica().broadcast_commit_point()
    return keys


@pytest.mark.parametrize("ref_backend", ["cpu", "tpu"])
def test_group_digests_equal_to_reference(tmp_path, monkeypatch,
                                         ref_backend):
    import pegasus_tpu.replication.replica as ref_rp
    import pegasus_tpu_torch.replication.replica as port_rp

    monkeypatch.setattr(port_rp, "time", _FrozenTime(time))
    monkeypatch.setattr(ref_rp, "time", _FrozenTime(time))
    port = _group(tmp_path / "port")
    ref = RefGroup(str(tmp_path / "ref"), n=3, options_factory=lambda:
                   RefOptions(backend=ref_backend))
    try:
        keys = _drive(port, msg)
        assert _drive(ref, ref_msg) == keys
        assert port.primary == ref.primary
        assert sorted(port.alive) == sorted(ref.alive) == port.names
        digests = set()
        for g in (port, ref):
            for rep in g.alive.values():
                assert rep.last_committed == 220
                digests.add(rep.server.engine.state_digest(
                    now=NOW)["digest"])
        assert len(digests) == 1
        assert _plog_bytes(port.primary_replica().plog.dir) == \
            _plog_bytes(ref.primary_replica().plog.dir)
        for k in sorted(keys):
            a, b = port.read(k, now=NOW), ref.read(k, now=NOW)
            assert (a.error, a.value) == (b.error, b.value)
    finally:
        port.close()
        ref.close()


# ------------------------------------- the reference's replication cases


def test_mutation_log_roundtrip_and_torn_tail(tmp_path):
    log = MutationLog(str(tmp_path / "plog"))
    for d in range(1, 21):
        log.append(LogMutation(decree=d, ballot=1, codes=["RPC_RRDB_RRDB_PUT"],
                               bodies=[b"body%d" % d]))
    got = list(log.replay(5))
    assert [m.decree for m in got] == list(range(6, 21))
    assert got[0].bodies == [b"body6"]
    log.close()
    seg = sorted((tmp_path / "plog").glob("log.*"))[0]
    with open(seg, "ab") as f:
        f.write(b"\x99" * 7)
    log2 = MutationLog(str(tmp_path / "plog"))
    assert [m.decree for m in log2.replay(0)] == list(range(1, 21))
    log2.close()


def test_mutation_log_gc_keeps_undurable(tmp_path):
    log = MutationLog(str(tmp_path / "plog"), segment_bytes=256)
    for d in range(1, 40):
        log.append(LogMutation(decree=d, codes=["c"], bodies=[b"x" * 64]))
    assert len(log._segments) > 2
    log.gc(durable_decree=20)
    remaining = [m.decree for m in log.replay(0)]
    assert set(range(21, 40)) <= set(remaining)
    log.close()


@pytest.fixture
def group(tmp_path):
    g = _group(tmp_path)
    yield g
    g.close()


def test_write_replicates_to_quorum(group):
    r = group.write(RPC_PUT, put_req(1))
    assert r.error == Status.OK
    for rep in group.alive.values():
        assert rep.last_prepared >= 1
    assert group.read(K(1)).error == Status.OK


def test_write_path_exports_replication_counters(group):
    from pegasus_tpu_torch.runtime.perf_counters import counters

    for i in range(5):
        group.write(RPC_PUT, put_req(100 + i))
    snap = counters.snapshot(prefix="replica.")
    prep = snap["replica.prepare_latency_us"]
    commit = snap["replica.commit_latency_us"]
    assert set(prep) == {"p50", "p90", "p95", "p99", "p999"}
    assert prep["p99"] > 0 and commit["p99"] > 0
    backlog = {k: v for k, v in snap.items() if k.endswith(".backlog")}
    assert backlog and all(v == 0 for v in backlog.values())
    assert any(k.endswith(".inflight") for k in snap)
    plog = counters.snapshot(prefix="plog.append.")
    assert plog["plog.append.count"] > 0
    assert plog["plog.append.bytes"] > 0
    assert plog["plog.append.duration_us"]["p99"] > 0


def test_secondary_commit_lags_until_next_prepare(group):
    group.write(RPC_PUT, put_req(1))
    group.write(RPC_PUT, put_req(2))
    prim = group.primary_replica()
    for name, rep in group.alive.items():
        if name != prim.name:
            assert rep.last_committed >= 1


def test_primary_failover_preserves_committed(group):
    for i in range(10):
        group.write(RPC_PUT, put_req(i))
    old_primary = group.primary
    group.kill(old_primary)
    assert group.primary != old_primary
    for i in range(10):
        assert group.read(K(i)).error == Status.OK, \
            f"lost write {i} after failover"
    group.write(RPC_PUT, put_req(99))
    assert group.read(K(99)).error == Status.OK


def test_duplicate_committed_prepares_not_staged(group):
    for i in range(5):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    sec = next(r for n, r in group.alive.items() if n != prim.name)
    sec.on_prepare(prim.ballot,
                   LogMutation(decree=sec.last_prepared, ballot=prim.ballot,
                               codes=["RPC_RRDB_RRDB_PUT"], bodies=[b"x"]),
                   sec.last_prepared)
    assert sec.last_committed == sec.last_prepared
    before = len(sec._uncommitted)
    for d in range(1, sec.last_committed + 1):
        sec.on_prepare(prim.ballot,
                       LogMutation(decree=d, ballot=prim.ballot,
                                   codes=["RPC_RRDB_RRDB_PUT"], bodies=[b"x"]),
                       sec.last_committed)
    assert len(sec._uncommitted) == before


def test_quorum_loss_rejects_writes(group):
    names = list(group.alive)
    group.kill(names[0])
    group.kill(names[1])
    with pytest.raises(ReplicaError):
        group.write(RPC_PUT, put_req(1))


def test_restart_rejoins_as_learner(group):
    for i in range(20):
        group.write(RPC_PUT, put_req(i))
    victim = [n for n in group.alive if n != group.primary][0]
    group.kill(victim)
    for i in range(20, 40):
        group.write(RPC_PUT, put_req(i))
    rep = group.restart(victim)
    assert rep.last_committed >= 39 or rep.last_prepared >= 39
    group.kill(group.primary)
    for i in range(40):
        assert group.read(K(i)).error == Status.OK


def test_restart_catches_up_writes_committed_during_the_learn(
        group, monkeypatch):
    """Writes committed after the learn fetched its tail (the learner not
    yet in the view) reach the learner when it joins, with no later
    write to carry them."""
    from pegasus_tpu_torch.replication.replica import Replica

    for i in range(10):
        group.write(RPC_PUT, put_req(i))
    victim = [n for n in group.alive if n != group.primary][0]
    group.kill(victim)
    swap = Replica._swap_learned_state

    def writes_then_swap(self, ckpt_dir, tail_state):
        for i in range(10, 15):
            group.write(RPC_PUT, put_req(i, gen=1))
        return swap(self, ckpt_dir, tail_state)

    monkeypatch.setattr(Replica, "_swap_learned_state", writes_then_swap)
    rep = group.restart(victim)
    prim = group.primary_replica()
    assert rep.last_committed == prim.last_committed
    for i in range(15):
        assert _read(rep, K(i)) == (Status.OK,
                                    b"val%d.%d" % (i, 1 if i >= 10 else 0))


def test_primary_catches_up_a_secondary_that_rejected_while_learning(
        group):
    """A secondary that rejected prepares while it learned, with no write
    after: the primary's catch_up_lagging (the stub calls it every
    beacon) brings it to the commit point."""
    for i in range(3):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    sec = next(r for n, r in group.alive.items() if n != group.primary)
    with sec._lock:
        sec._learning = True
    for i in range(3, 6):
        group.write(RPC_PUT, put_req(i, gen=1))
    with sec._lock:
        sec._learning = False
    assert sec.last_prepared < prim.last_committed
    assert prim.catch_up_lagging() == 1
    assert sec.last_committed == prim.last_committed
    assert prim.catch_up_lagging() == 0
    for i in range(6):
        assert _read(sec, K(i)) == (Status.OK,
                                    b"val%d.%d" % (i, 1 if i >= 3 else 0))


def test_primary_catches_up_a_secondary_new_to_its_view(group):
    """A secondary added to the primary's view after the writes it missed
    (the meta re-adds a learner once its learn ends) is pushed the commit
    point by catch_up_lagging, with no write after."""
    from pegasus_tpu_torch.replication.replica import GroupView

    for i in range(3):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    sec_name = next(n for n in group.alive if n != group.primary)
    others = [n for n in prim.view.secondaries if n != sec_name]
    prim.assume_view(GroupView(prim.ballot, prim.name, others))
    sec = group.alive[sec_name]
    for i in range(3, 6):
        group.write(RPC_PUT, put_req(i, gen=1))
    assert prim.catch_up_lagging() == 0      # no member lags
    prim.assume_view(GroupView(prim.ballot, prim.name, others + [sec_name]))
    assert sec.last_prepared < prim.last_committed
    assert prim.catch_up_lagging() == 1
    assert sec.last_committed == prim.last_committed
    for i in range(6):
        assert _read(sec, K(i)) == (Status.OK,
                                    b"val%d.%d" % (i, 1 if i >= 3 else 0))


def _power_loss(g):
    """Whole-group power loss: no flush, no close."""
    for n in list(g.alive):
        g.alive[n].plog.close()
    g.alive.clear()


def test_full_group_crash_recovers_all_committed(tmp_path):
    g = _group(tmp_path)
    for i in range(25):
        g.write(RPC_PUT, put_req(i))
    _power_loss(g)
    g2 = _group(tmp_path)
    for i in range(25):
        assert g2.read(K(i)).error == Status.OK, f"lost committed write {i}"
    g2.close()


def test_kill_loop_no_committed_write_lost(tmp_path):
    """The kill test proper: randomized kills/restarts under load."""
    rng = np.random.default_rng(7)
    g = _group(tmp_path)
    acked = {}
    i = 0
    for step in range(12):
        for _ in range(15):
            gen = int(rng.integers(0, 100))
            try:
                r = g.write(RPC_PUT, put_req(i, gen))
                if r.error == Status.OK:
                    acked[i] = gen
            except ReplicaError:
                pass
            i += 1
        action = rng.integers(0, 3)
        live = list(g.alive)
        if action == 0 and len(live) > 2:
            g.kill(live[int(rng.integers(0, len(live)))])
        elif action == 1:
            dead = [n for n in g.names if n not in g.alive]
            if dead:
                g.restart(dead[int(rng.integers(0, len(dead)))])
        elif action == 2 and len(live) > 2:
            victim = live[int(rng.integers(0, len(live)))]
            g.kill(victim)
            g.restart(victim)
    for n in g.names:
        if n not in g.alive:
            g.restart(n)
    for i, gen in acked.items():
        resp = g.read(K(i))
        assert resp.error == Status.OK, f"acked write {i} lost"
        assert resp.value == b"val%d.%d" % (i, gen)
    g.close()


def test_concurrent_writers_form_plog_groups(tmp_path, monkeypatch):
    """4 client threads on one partition form decree windows: the plog's
    appends-per-flush ratio exceeds 1 while every write commits. Each
    secondary prepare takes 2 ms, so writers always queue behind an
    in-flight round (the windows form by construction, not by luck)."""
    from pegasus_tpu_torch.replication.replica import Replica

    real = Replica.on_prepare_batch

    def slow(self, *a, **kw):
        time.sleep(0.002)
        return real(self, *a, **kw)

    monkeypatch.setattr(Replica, "on_prepare_batch", slow)
    g = _group(tmp_path)
    n_threads, per = 4, 25
    errs = []

    def w(tid):
        for i in range(per):
            try:
                g.write(RPC_PUT, put_req(tid * 1000 + i))
            except ReplicaError as e:
                errs.append(e)

    threads = [threading.Thread(target=w, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    prim = g.primary_replica()
    assert prim.last_committed == n_threads * per
    assert prim.plog.append_count == n_threads * per
    assert prim.plog.flush_count < prim.plog.append_count, \
        "no plog groups formed under 4 concurrent writers"
    for rep in g.alive.values():
        assert rep.last_prepared == n_threads * per
    g.close()


def test_single_writer_groups_of_one(tmp_path):
    g = _group(tmp_path)
    for i in range(20):
        g.write(RPC_PUT, put_req(i))
    prim = g.primary_replica()
    assert prim.plog.append_count == 20
    assert prim.plog.flush_count == 20
    g.close()


def test_window_gap_triggers_catch_up(group):
    for i in range(3):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    sec_name = next(n for n in group.alive if n != group.primary)
    sec = group.alive.pop(sec_name)  # unreachable (not killed: no election)
    for i in range(3, 6):
        group.write(RPC_PUT, put_req(i))
    group.alive[sec_name] = sec      # back, with a decree gap
    group.write(RPC_PUT, put_req(6))
    assert sec.last_prepared == prim.last_prepared
    assert sec.last_committed >= 6


def test_commit_point_broadcast_catches_up_a_lagging_secondary(group):
    """A secondary that missed decrees and sees no later write (a learner
    that joined after the last one) is caught up by the commit-point
    broadcast, not left behind the commit point until the next write."""
    for i in range(3):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    sec_name = next(n for n in group.alive if n != group.primary)
    sec = group.alive.pop(sec_name)  # unreachable (not killed: no election)
    for i in range(3, 6):
        group.write(RPC_PUT, put_req(i, gen=1))
    group.alive[sec_name] = sec      # back, with a decree gap, no write
    assert sec.last_prepared < prim.last_committed
    assert prim.broadcast_commit_point() == 2
    assert sec.last_prepared == sec.last_committed == prim.last_committed
    for i in range(6):
        assert _read(sec, K(i)) == _read(prim, K(i)) \
            == (Status.OK, b"val%d.%d" % (i, 1 if i >= 3 else 0))


def _trace_keys(trace) -> set:
    keys = set()
    for m in trace:
        for code, body in zip(m.codes, m.bodies):
            req = codec.decode(WRITE_CODES[code][0], body)
            if code == RPC_MULTI_PUT:
                keys.update(key_schema.generate_key(req.hash_key, kv.key)
                            for kv in req.kvs)
            else:
                keys.add(req.key)
    return keys


def _read(rep, key):
    resp = rep.server.on_get(key)
    return (resp.error, bytes(resp.value))


def test_batched_vs_serial_byte_identical(tmp_path, monkeypatch):
    """The same client trace through the decree-pipelined path
    (concurrent writers, mixed put/remove/multi_put, a secondary killed
    and re-seeded mid-stream) and through the serial path gives
    byte-identical plog files and identical reads."""
    import pegasus_tpu_torch.replication.replica as rp

    monkeypatch.setattr(rp, "time", _FrozenTime(time))

    def multi_put_req(j):
        return msg.MultiPutRequest(
            hash_key=b"mh%d" % (j % 7),
            kvs=[msg.KeyValue(b"s%d" % k, b"mv%d.%d" % (j, k))
                 for k in range(3)],
            expire_ts_seconds=0)

    ga = _group(tmp_path / "a")
    victim = next(n for n in ga.alive if n != ga.primary)

    def writer(tid):
        for i in range(18):
            j = tid * 100 + i
            kind = j % 5
            if kind < 3:
                ga.write(RPC_PUT, put_req(j))
            elif kind == 3:
                ga.write(RPC_REMOVE, msg.KeyRequest(K(j)))
            else:
                ga.write(RPC_MULTI_PUT, multi_put_req(j))

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    ga.kill(victim)
    time.sleep(0.05)
    ga.restart(victim)
    for t in threads:
        t.join()
    prim_a = ga.primary_replica()
    trace = sorted(prim_a.plog.replay(0), key=lambda m: m.decree)
    assert len(trace) == 4 * 18
    keys = _trace_keys(trace)
    state_a = {k: _read(prim_a, k) for k in keys}
    committed_a = prim_a.last_committed
    plog_a = _plog_bytes(prim_a.plog.dir)

    gb = _group(tmp_path / "b")
    for idx, m in enumerate(trace):
        if idx == len(trace) // 2:
            gb.kill(victim)
            gb.restart(victim)
        (code,) = m.codes
        req = codec.decode(WRITE_CODES[code][0], m.bodies[0])
        gb.write(code, req)
    prim_b = gb.primary_replica()
    assert prim_b.last_committed == committed_a
    assert {k: _read(prim_b, k) for k in keys} == state_a
    assert _plog_bytes(prim_b.plog.dir) == plog_a
    ga.close()
    gb.close()


def test_plog_group_raise_never_acks_lost_writes(tmp_path):
    """`plog.group` armed with raise() fails every group before its
    write: no failed write is acked, no acked write is lost after a
    power loss, and the log heals once the fault clears."""
    fp.setup()
    try:
        g = _group(tmp_path)
        g.write(RPC_PUT, put_req(0))
        fp.cfg("plog.group", "raise(chaos)")
        for i in range(1, 6):
            with pytest.raises(ReplicaError):
                g.write(RPC_PUT, put_req(i))
        fp.cfg("plog.group", "off()")
        g.write(RPC_PUT, put_req(9))
        _power_loss(g)
        g2 = _group(tmp_path)
        assert g2.read(K(0)).error == Status.OK
        assert g2.read(K(9)).error == Status.OK
        for i in range(1, 6):
            assert g2.read(K(i)).error == Status.NOT_FOUND, \
                f"write {i} failed its ack but appeared after replay"
        g2.close()
    finally:
        fp.teardown()


def test_plog_wedged_group_writer_degrades_not_hangs(tmp_path):
    """A group leader wedged between claim and flush does not hang the
    partition: appends it never claimed land on their own after the
    stall bound; the wedged group still lands (and only then acks)."""
    fp.setup()
    try:
        log = MutationLog(str(tmp_path / "plog"))
        log._stall_s = 0.2
        fp.cfg("plog.group", "1*sleep(2500)")
        errs = []

        def w(d):
            try:
                log.append(LogMutation(decree=d, codes=["c"], bodies=[b"x"]))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t_wedge = threading.Thread(target=w, args=(1,))
        t_wedge.start()
        time.sleep(0.3)
        others = [threading.Thread(target=w, args=(d,)) for d in range(2, 6)]
        t0 = time.monotonic()
        for t in others:
            t.start()
        for t in others:
            t.join(timeout=10)
            assert not t.is_alive(), "append hung behind the wedged leader"
        assert time.monotonic() - t0 < 2.0, \
            "degraded appends waited for the wedged group writer"
        t_wedge.join(timeout=10)
        assert not t_wedge.is_alive()
        assert not errs
        assert sorted(m.decree for m in log.replay(0)) == [1, 2, 3, 4, 5]
        log.close()
    finally:
        fp.teardown()


def test_remove_and_reopen_replays_tombstone(group):
    group.write(RPC_PUT, put_req(5))
    group.write(RPC_REMOVE, msg.KeyRequest(K(5)))
    assert group.read(K(5)).error == Status.NOT_FOUND
    group.kill(group.primary)
    assert group.read(K(5)).error == Status.NOT_FOUND


def test_log_gc_after_flush(group):
    for i in range(30):
        group.write(RPC_PUT, put_req(i))
    prim = group.primary_replica()
    prim.gc_log(flush=True)
    assert prim.server.engine.last_durable_decree() >= 30
    for i in range(30):
        assert group.read(K(i)).error == Status.OK


def test_failed_merge_fails_the_write_not_the_backend(tmp_path, monkeypatch):
    """No fallback: a merge failure on the primary's engine reaches the
    writer as ReplicaError and leaves every engine on its backend."""
    from pegasus_tpu_torch.engine import db as port_db

    g = _group(tmp_path)
    try:
        for i in range(3):
            g.write(RPC_PUT, put_req(i))

        def boom(*a, **kw):
            raise RuntimeError("merge failed on the card")

        monkeypatch.setattr(port_db, "compact_blocks", boom)
        prim = g.primary_replica()
        prim.server.engine.opts.l0_compaction_trigger = 1
        prim.server.engine.opts.memtable_bytes = 1
        with pytest.raises(ReplicaError, match="merge failed"):
            g.write(RPC_PUT, put_req(10))
        assert all(r.server.engine.opts.backend == "cuda"
                   for r in g.alive.values())
    finally:
        g.close()
