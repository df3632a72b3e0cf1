"""The port's streamed learn, engine checkpoints and scrub.

  * checkpoints: the same writes into a port engine and a reference
    engine give checkpoint dirs with equal dir_manifest (names, sizes,
    md5 digests: the same SST and MANIFEST bytes), equal in either
    package's dir_manifest, and equal checkpoint_digest;
  * the cases of tests/test_learn_ship.py (all but the RPC re-seed, which
    comes with the replica stub): byte identity across the learn paths,
    the delta kill switch, resume after a mid-ship kill or fail point,
    pin semantics, the digest proof, prepare rejection while learning,
    the lock-free monolithic fetch, the incremental arrival proof, the
    manifest fold and the sidecar resume;
  * the scrub cases of tests/test_integrity.py, and the corruption hook.

Engines run the cuda backend on device="cpu" unless a case says
otherwise.
"""

import glob
import os
import threading
import time

import pytest

from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine import LsmEngine as RefEngine
from pegasus_tpu.replication import learn as ref_learn
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.base.utils import epoch_now
from pegasus_tpu_torch.base.value_schema import SCHEMAS
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
from pegasus_tpu_torch.engine.sstable import CorruptionError
from pegasus_tpu_torch.replication import learn as learn_mod
from pegasus_tpu_torch.replication.mutation_log import LogMutation
from pegasus_tpu_torch.replication.replica import (GroupView, PrepareRejected,
                                                   Replica, ReplicaError)
from pegasus_tpu_torch.rpc import messages as msg
from pegasus_tpu_torch.rpc.task_codes import RPC_MULTI_PUT
from pegasus_tpu_torch.runtime import fail_points as fp
from pegasus_tpu_torch.runtime.perf_counters import counters


def _opts(**kw):
    """Many small SSTs (no L0 merge), so the block manifest has real
    granularity for the delta/resume assertions."""
    kw.setdefault("device", "cpu")
    kw.setdefault("memtable_bytes", 32 << 10)
    kw.setdefault("l0_compaction_trigger", 100)
    return EngineOptions(**kw)


def _load(prim, lo, hi):
    for base in range(lo, hi, 50):
        kvs = [msg.KeyValue(b"s%06d" % i, b"v%04d" % (i % 7919) + b"x" * 30)
               for i in range(base, min(base + 50, hi))]
        prim.client_write(RPC_MULTI_PUT, msg.MultiPutRequest(
            hash_key=b"h%03d" % (base % 31), kvs=kvs))


def _mk_primary(root, n=1500, **okw):
    prim = Replica("prim", str(root / "prim"), options=_opts(**okw),
                   quorum=1)
    prim.assume_view(GroupView(1, "prim", []))
    _load(prim, 0, n)
    prim.server.engine.flush()
    return prim


def _learner(root, name, **okw):
    return Replica(name, str(root / name), options=_opts(**okw), quorum=1)


def _totals():
    return {k: counters.rate("learn.ship." + k).total()
            for k in ("blocks", "bytes", "delta_skipped_blocks")}


def _delta(before, after):
    return {k: after[k] - before[k] for k in before}


def _assert_identical(prim, learner, now):
    assert learner.last_committed == prim.last_committed
    a = prim.server.engine.state_digest(now=now)
    b = learner.server.engine.state_digest(now=now)
    assert a["digest"] == b["digest"], "post-learn digest diverged"
    assert a["records"] == b["records"] > 0


# --------------------------------------------- checkpoints across packages


def _enc(payload: bytes) -> bytes:
    return SCHEMAS[2].generate_value(0, 0, payload)


@pytest.mark.parametrize("flush_between", [False, True])
def test_checkpoint_manifest_and_digest_equal_to_reference(tmp_path,
                                                           flush_between):
    """The same decree-numbered writes into a port engine and a reference
    engine: sync_checkpoint lands at the same decree, the checkpoint dirs
    hold the same bytes (dir_manifest equal, whichever package computes
    it), and checkpoint_digest is equal."""
    port = LsmEngine(str(tmp_path / "port"), EngineOptions(device="cpu"))
    ref = RefEngine(str(tmp_path / "ref"), RefOptions(backend="cpu"))
    try:
        for eng in (port, ref):
            for i in range(600):
                eng.put(generate_key(b"hk%d" % (i % 13), b"sk%04d" % i),
                        _enc(b"val%d" % i), decree=i + 1)
                if flush_between and i % 200 == 199:
                    eng.flush()
            for i in range(0, 600, 7):
                eng.delete(generate_key(b"hk%d" % (i % 13), b"sk%04d" % i),
                           decree=601 + i)
        dp, dr = port.sync_checkpoint(), ref.sync_checkpoint()
        assert dp == dr == ref.last_durable_decree() > 0
        assert port.list_checkpoints() == ref.list_checkpoints() == [dp]
        cp, cr = port.get_checkpoint_dir(), ref.get_checkpoint_dir()
        mp = learn_mod.dir_manifest(cp)
        assert mp == ref_learn.dir_manifest(cr) == ref_learn.dir_manifest(cp)
        assert len(mp) > 1 and any(e["name"] == "MANIFEST" for e in mp)
        assert learn_mod.manifest_fold(mp) == ref_learn.manifest_fold(mp)
        a, b = port.checkpoint_digest(dp), ref.checkpoint_digest(dr)
        assert (a["digest"], a["records"], a["pmask"]) == \
            (b["digest"], b["records"], b["pmask"])
        # a learned engine: either package opens the other's checkpoint
        got = LsmEngine.apply_checkpoint(cr, str(tmp_path / "applied"),
                                         EngineOptions(device="cpu"))
        assert got.state_digest(now=a["now"])["digest"] == a["digest"]
        got.close()
    finally:
        port.close()
        ref.close()


# ------------------------------------------------------ byte identity


class _MonolithicPeer:
    """Only the monolithic surface: learn_from takes the whole-state
    path against the same primary."""

    def __init__(self, prim):
        self.prim = prim

    def fetch_learn_state(self):
        return self.prim.fetch_learn_state()


def test_full_delta_and_monolithic_learns_are_byte_identical(tmp_path):
    """The three learn paths give identical engine digests at equal
    decrees, and the delta re-learn moves >= 5x fewer bytes than either
    full path while skipping the blocks the learner already held."""
    prim = _mk_primary(tmp_path, n=1500)
    now = epoch_now()
    mono = full = None
    try:
        t0 = _totals()
        mono = _learner(tmp_path, "mono")
        mono.learn_from(_MonolithicPeer(prim))
        t1 = _totals()
        _assert_identical(prim, mono, now)
        mono_bytes = _delta(t0, t1)["bytes"]
        assert mono_bytes > 0

        full = _learner(tmp_path, "full")
        full.learn_from(prim)
        t2 = _totals()
        _assert_identical(prim, full, now)
        d_full = _delta(t1, t2)
        assert d_full["bytes"] > 0 and d_full["blocks"] > 1
        assert d_full["delta_skipped_blocks"] == 0

        _load(prim, 1500, 1700)
        prim.server.engine.flush()
        now2 = epoch_now()
        full.learn_from(prim)
        t3 = _totals()
        _assert_identical(prim, full, now2)
        d_delta = _delta(t2, t3)
        assert d_delta["delta_skipped_blocks"] > 0
        assert d_delta["bytes"] * 5 <= mono_bytes
        assert d_delta["bytes"] * 5 <= d_full["bytes"]
    finally:
        for r in (prim, mono, full):
            if r is not None:
                r.close()


def test_delta_kill_switch_ships_everything(tmp_path, monkeypatch):
    prim = _mk_primary(tmp_path, n=500)
    lrn = _learner(tmp_path, "lrn")
    try:
        lrn.learn_from(prim)
        t0 = _totals()
        monkeypatch.setenv("PEGASUS_LEARN_DELTA", "0")
        lrn.learn_from(prim)
        d = _delta(t0, _totals())
        assert d["delta_skipped_blocks"] == 0
        assert d["blocks"] > 1 and d["bytes"] > 0
        _assert_identical(prim, lrn, epoch_now())
        monkeypatch.delenv("PEGASUS_LEARN_DELTA")
        prim.server.engine.sync_checkpoint()
        have = learn_mod.dir_manifest(prim.server.engine.get_checkpoint_dir())
        st = prim.prepare_learn_state(have=have, delta=False)
        try:
            assert st["missing"] == [e["name"] for e in st["blocks"]]
        finally:
            prim.finish_learn(st["learn_id"])
        st2 = prim.prepare_learn_state(have=have, delta=True)
        try:
            assert st2["missing"] == []
        finally:
            prim.finish_learn(st2["learn_id"])
    finally:
        prim.close()
        lrn.close()


# ------------------------------------------------- mid-ship kill + resume


class _FlakyPeer:
    """Drops the connection after N block waves on the first attempt."""

    def __init__(self, prim, fail_after_blocks):
        self.prim = prim
        self.fail_after = fail_after_blocks
        self.calls = 0
        self.armed = True

    def prepare_learn_state(self, have=None, delta=None):
        return self.prim.prepare_learn_state(have=have, delta=delta)

    def fetch_learn_chunks(self, learn_id, reqs):
        self.calls += 1
        if self.armed and self.calls > self.fail_after:
            raise ConnectionError("mid-ship drop")
        return self.prim.fetch_learn_chunks(learn_id, reqs)

    def fetch_learn_tail(self, learn_id):
        return self.prim.fetch_learn_tail(learn_id)

    def finish_learn(self, learn_id):
        self.prim.finish_learn(learn_id)


def test_mid_ship_kill_resumes_at_block_granularity(tmp_path):
    prim = _mk_primary(tmp_path, n=1200)
    now = epoch_now()
    lrn = _learner(tmp_path, "lrn")
    try:
        flaky = _FlakyPeer(prim, fail_after_blocks=3)
        t0 = _totals()
        with pytest.raises(ConnectionError):
            lrn.learn_from(flaky)
        t1 = _totals()
        first = _delta(t0, t1)
        assert first["blocks"] == 3
        assert not prim.learn_pins(), "failed learn leaked its pin"
        flaky.armed = False
        lrn.learn_from(flaky)
        second = _delta(t1, _totals())
        _assert_identical(prim, lrn, now)
        assert second["delta_skipped_blocks"] >= 3
        data = os.path.join(prim.path, "data")
        total_blocks = len([n for n in os.listdir(data)
                            if n.endswith(".sst") or n == "MANIFEST"])
        assert second["blocks"] + first["blocks"] \
            + second["delta_skipped_blocks"] >= total_blocks
    finally:
        prim.close()
        lrn.close()


def test_mid_ship_fail_point_aborts_then_resumes(tmp_path):
    prim = _mk_primary(tmp_path, n=800)
    now = epoch_now()
    lrn = _learner(tmp_path, "lrn")
    fp.setup()
    try:
        fp.cfg("learn.ship", "100%raise(chaos)")
        with pytest.raises(fp.FailPointError):
            lrn.learn_from(prim)
        assert lrn.status != "SECONDARY"
        fp.cfg("learn.ship", "off()")
        lrn.learn_from(prim)
        _assert_identical(prim, lrn, now)
    finally:
        fp.teardown()
        prim.close()
        lrn.close()


# ------------------------------------------------------- pin semantics


def test_gc_and_log_held_while_checkpoint_pinned(tmp_path):
    prim = _mk_primary(tmp_path, n=600, checkpoint_reserve_min_count=1)
    prim.plog.segment_bytes = 2048  # roll segments fast so GC has prey
    try:
        st = prim.prepare_learn_state(have=())
        lid, pinned_decree = st["learn_id"], st["ckpt_decree"]
        eng = prim.server.engine
        pinned_dir = eng.get_checkpoint_dir(pinned_decree)
        _load(prim, 600, 1200)
        prim.server.engine.flush()
        eng.sync_checkpoint()
        assert pinned_decree in eng.pinned_checkpoints()
        assert os.path.isdir(pinned_dir)
        prim.gc_log(flush=True)
        tail = [m.decree for m in prim.plog.replay(pinned_decree)]
        assert tail and tail[0] == pinned_decree + 1
        entry = next(e for e in st["blocks"] if e["name"] != "MANIFEST")
        ch = prim.fetch_learn_block(lid, entry["name"], 0, entry["size"])
        assert len(ch["data"]) == entry["size"]
        prim.finish_learn(lid)
        assert pinned_decree not in eng.pinned_checkpoints()
        eng.sync_checkpoint()
        assert not os.path.isdir(pinned_dir)
        with pytest.raises(ReplicaError):
            prim.fetch_learn_block(lid, entry["name"], 0, 16)
    finally:
        prim.close()


def test_expired_pin_is_reaped_and_fetch_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setenv("PEGASUS_LEARN_PIN_TTL_S", "0.05")
    prim = _mk_primary(tmp_path, n=300)
    try:
        st = prim.prepare_learn_state(have=())
        time.sleep(0.1)
        with pytest.raises(ReplicaError):
            prim.fetch_learn_block(st["learn_id"], st["blocks"][0]["name"],
                                   0, 16)
        prim.gc_log()  # reaps the expired pin
        assert not prim.learn_pins()
        assert not prim.server.engine.pinned_checkpoints()
    finally:
        prim.close()


# --------------------------------------------------- digest proof + locks


class _TamperingPeer(_FlakyPeer):
    """Corrupts the handshake digest: the learn must fail loudly."""

    def __init__(self, prim):
        super().__init__(prim, fail_after_blocks=1 << 30)

    def prepare_learn_state(self, have=None, delta=None):
        st = self.prim.prepare_learn_state(have=have, delta=delta)
        st["digest"] = "0" * 32
        return st


def test_digest_mismatch_fails_learn_loudly(tmp_path):
    prim = _mk_primary(tmp_path, n=400)
    lrn = _learner(tmp_path, "lrn")
    try:
        with pytest.raises(ReplicaError, match="digest mismatch"):
            lrn.learn_from(_TamperingPeer(prim))
        assert lrn.status != "SECONDARY"
        lrn.learn_from(prim)
        _assert_identical(prim, lrn, epoch_now())
    finally:
        prim.close()
        lrn.close()


def test_learning_replica_rejects_prepares(tmp_path):
    rep = _learner(tmp_path, "rep")
    try:
        with rep._lock:
            rep._learning = True
        m = LogMutation(decree=1, ballot=1, codes=["RPC_RRDB_RRDB_PUT"],
                        bodies=[b"x"])
        with pytest.raises(PrepareRejected) as ei:
            rep.on_prepare_batch(1, [m], 0)
        assert ei.value.reason == "learning"
        with rep._lock:
            rep._learning = False
        assert rep.on_prepare_batch(1, [m], 0) == 1
    finally:
        rep.close()


def test_fetch_learn_state_reads_outside_replica_lock(tmp_path):
    prim = _mk_primary(tmp_path, n=1000)
    try:
        locked_during_fetch = []
        stop = threading.Event()

        def prober():
            while not stop.is_set():
                got = prim._lock.acquire(timeout=0.02)
                if got:
                    prim._lock.release()
                locked_during_fetch.append(got)
                time.sleep(0.002)

        t = threading.Thread(target=prober)
        t.start()
        try:
            for _ in range(3):
                assert prim.fetch_learn_state()["files"]
        finally:
            stop.set()
            t.join()
        assert locked_during_fetch and \
            sum(locked_during_fetch) >= len(locked_during_fetch) * 0.8
    finally:
        prim.close()


def _verify_totals():
    return {k: counters.rate("learn.verify." + k).total()
            for k in ("incremental_count", "rescan_count")}


@pytest.mark.parametrize("incremental", [True, False])
def test_learn_arrival_proof(tmp_path, monkeypatch, incremental):
    """A fresh learn pays the full rescan; a delta re-learn proves
    arrival through the per-block fold, unless
    PEGASUS_LEARN_INCREMENTAL_DIGEST=0 sends it back to the rescan."""
    if not incremental:
        monkeypatch.setenv("PEGASUS_LEARN_INCREMENTAL_DIGEST", "0")
    prim = _mk_primary(tmp_path, n=1000)
    lrn = _learner(tmp_path, "lrn")
    try:
        v0 = _verify_totals()
        lrn.learn_from(prim)
        v1 = _verify_totals()
        assert v1["rescan_count"] - v0["rescan_count"] == 1
        assert v1["incremental_count"] == v0["incremental_count"]
        _load(prim, 1000, 1100)
        prim.server.engine.flush()
        lrn.learn_from(prim)
        v2 = _verify_totals()
        if incremental:
            assert v2["rescan_count"] == v1["rescan_count"]
            assert v2["incremental_count"] - v1["incremental_count"] == 1
        else:
            assert v2["rescan_count"] - v1["rescan_count"] == 1
            assert v2["incremental_count"] == v1["incremental_count"]
        _assert_identical(prim, lrn, epoch_now())
    finally:
        prim.close()
        lrn.close()


def test_manifest_fold_order_independent_and_sensitive():
    a = [{"name": "1.sst", "digest": "aa"}, {"name": "2.sst",
                                             "digest": "bb"}]
    assert learn_mod.manifest_fold(a) == learn_mod.manifest_fold(a[::-1]) \
        == ref_learn.manifest_fold(a)
    tampered = [{"name": "1.sst", "digest": "aa"},
                {"name": "2.sst", "digest": "cc"}]
    assert learn_mod.manifest_fold(a) != learn_mod.manifest_fold(tampered)
    assert learn_mod.manifest_fold([]) == f"{0:016x}{0:016x}"
    assert list(learn_mod.chunk_waves(10, 4, 8)) == \
        list(ref_learn.chunk_waves(10, 4, 8))


def test_sidecar_resume_skips_rehash(tmp_path, monkeypatch):
    prim = _mk_primary(tmp_path, n=900)
    lrn = _learner(tmp_path, "lrn")
    try:
        st = prim.prepare_learn_state(have=[], delta=True)
        ckpt_dir = os.path.join(lrn.path, "learn_ckpt")

        class _Abort(Exception):
            pass

        fetched = []
        real_fetch = learn_mod._fetch_block

        def flaky(source, learn_id, entry, dest_dir):
            if len(fetched) >= 1:
                raise _Abort()
            fetched.append(entry["name"])
            return real_fetch(source, learn_id, entry, dest_dir)

        monkeypatch.setattr(learn_mod, "_fetch_block", flaky)
        with pytest.raises(_Abort):
            learn_mod.stage_blocks(prim, st, ckpt_dir)
        monkeypatch.setattr(learn_mod, "_fetch_block", real_fetch)
        assert len(fetched) == 1

        hashed_ckpt = []
        real_digest = learn_mod.file_digest

        def spy(path):
            if "learn_ckpt" in path:
                hashed_ckpt.append(os.path.basename(path))
            return real_digest(path)

        monkeypatch.setattr(learn_mod, "file_digest", spy)
        stats = learn_mod.stage_blocks(prim, st, ckpt_dir)
        prim.finish_learn(st["learn_id"])
        assert stats["resumed"] == 1
        assert not (set(fetched) & set(hashed_ckpt)), (fetched, hashed_ckpt)
        assert stats["fold"] == learn_mod.manifest_fold(st["blocks"])
    finally:
        prim.close()
        lrn.close()


# ------------------------------------------------ scrub and corruption


def _filled_engine(path, n=60):
    eng = LsmEngine(str(path), EngineOptions(device="cpu"))
    keys = []
    for i in range(n):
        k = generate_key(b"hk%d" % (i % 5), b"sk%04d" % i)
        eng.put(k, _enc(b"val%d" % i))
        keys.append(k)
    eng.flush()
    return eng, keys


def _ssts(path) -> list:
    return sorted(glob.glob(os.path.join(str(path), "*.sst")),
                  key=os.path.getmtime)


def _flip_tail(path: str, nbytes: int = 8) -> None:
    """Corrupt the end of the last section, as real rot would: the header
    still parses and the finding is a crc mismatch."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - nbytes)
        tail = f.read(nbytes)
        f.seek(size - nbytes)
        f.write(bytes(b ^ 0xFF for b in tail))


def test_scrub_clean_then_finds_corruption(tmp_path):
    eng, _ = _filled_engine(tmp_path / "db")
    try:
        res = eng.scrub()
        assert res["files"] >= 1 and res["bytes"] > 0
        assert res["findings"] == [] and res["errors"] == []
        victim = _ssts(tmp_path / "db")[-1]
        _flip_tail(victim)
        res = eng.scrub()
        assert any(f["path"] == victim and "crc32 mismatch" in f["detail"]
                   for f in res["findings"]), res
        os.unlink(victim)
        res = eng.scrub()
        assert any(f["path"] == victim and "missing file" in f["detail"]
                   for f in res["findings"]), res
    finally:
        eng.close()


def test_scrub_failpoint_is_an_error_not_a_finding(tmp_path):
    eng, _ = _filled_engine(tmp_path / "db")
    fp.setup()
    try:
        fp.cfg("scrub.verify", "raise(chaos)")
        res = eng.scrub()
        assert res["findings"] == []
        assert res["errors"] and all("chaos" in e["detail"]
                                     for e in res["errors"])
        fp.cfg("scrub.verify", "off()")
        res = eng.scrub()
        assert res["errors"] == [] and res["findings"] == []
    finally:
        fp.teardown()
        eng.close()


def test_corruption_mid_read_is_typed_and_hooked(tmp_path):
    """Corruption landing after open (header cached, block not loaded):
    the read raises the typed error and fires the corruption hook; a
    replica's hook survives a learn's engine swap."""
    eng, keys = _filled_engine(tmp_path / "db")
    eng.close()
    _flip_tail(_ssts(tmp_path / "db")[-1])
    eng2 = LsmEngine(str(tmp_path / "db"), EngineOptions(device="cpu"))
    seen = []
    eng2.corruption_hook = seen.append
    before = counters.rate("engine.corruption_count").total()
    with pytest.raises(CorruptionError):
        eng2.get(keys[0], now=10)
    assert seen and isinstance(seen[0], CorruptionError)
    assert counters.rate("engine.corruption_count").total() > before
    eng2.close()

    prim = _mk_primary(tmp_path, n=300)
    lrn = _learner(tmp_path, "lrn")
    try:
        hook = []
        lrn.set_corruption_hook(hook.append)
        lrn.learn_from(prim)
        assert lrn.server.engine.corruption_hook is not None
        lrn.server.engine.corruption_hook(CorruptionError("p", "d"))
        assert len(hook) == 1
    finally:
        prim.close()
        lrn.close()
