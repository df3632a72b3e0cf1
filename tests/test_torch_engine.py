"""The port's LsmEngine against the JAX package's, end to end.

The same writes, deletes, TTLs, flushes, L0 compactions and a
manual_compact go into a pegasus_tpu engine (backend="tpu" on JAX-CPU)
and a port engine (backend="cuda", device="cpu"). Both must give the same
state_digest and the same get / get_batch / scan / scan_range_batch
answers, the port's batched reads must go through its device lookups,
and each package must open and serve the other's directory.
"""

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key, generate_next_bytes
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu.engine.db import EngineOptions as RefOptions
from pegasus_tpu.engine.db import LsmEngine as RefEngine
from pegasus_tpu.engine.db import WriteBatch as RefBatch
from pegasus_tpu_torch.engine import db as port_db
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine, WriteBatch
from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

NOW = 1000


@pytest.fixture(autouse=True)
def _device_reads_for_every_batch(monkeypatch):
    """Small tables give an SST few candidates per batch: probe the
    resident run from one candidate up, as the reference engines below
    do with device_read_min_batch=1."""
    monkeypatch.setattr(port_db, "DEVICE_READ_MIN_BATCH", 1)


def _drive(eng, batch_cls, seed=3):
    """Writes in decree windows, with deletes and TTLs (some expired at
    NOW), small memtables so flushes and L0 compactions happen, and a
    final manual_compact followed by a fresh L0 and memtable."""
    rng = np.random.default_rng(seed)
    decree = 0
    for round_ in range(6):
        pairs = []
        for _ in range(8):
            wb = batch_cls()
            for _ in range(12):
                i = int(rng.integers(0, 400))
                key = generate_key(b"h%03d" % (i % 37), b"s%05d" % i)
                if rng.random() < 0.12:
                    wb.delete(key)
                else:
                    exp = int(rng.choice([0, 0, NOW - 5, NOW + 50]))
                    wb.put(key, SCHEMAS[2].generate_value(
                        exp, 0, b"v%d-%d" % (i, round_)), exp)
            decree += 1
            pairs.append((wb, decree))
        eng.write_batch(pairs)
        if round_ == 3:
            eng.manual_compact(now=NOW)
    eng.flush()
    eng.put(generate_key(b"h001", b"memonly"),
            SCHEMAS[2].generate_value(0, 0, b"m"))


def _keys():
    ks = [generate_key(b"h%03d" % (i % 37), b"s%05d" % i) for i in range(420)]
    return ks + [generate_key(b"h001", b"memonly"), generate_key(b"zz", b"")]


def _ranges():
    rs = [(generate_key(b"h%03d" % h), generate_next_bytes(b"h%03d" % h))
          for h in range(0, 37, 3)]
    return rs + [(generate_key(b"h010", b"s00100"), None),
                 (b"", generate_key(b"h005"))]


def _answers(eng):
    keys = _keys()
    return {
        "digest": eng.state_digest(now=NOW),
        "get": [eng.get(k, now=NOW) for k in keys],
        "get_batch": eng.get_batch(keys, now=NOW),
        "scan": [list(eng.scan(s, t, now=NOW)) for s, t in _ranges()],
        "scan_range_batch": [list(it) for it in
                             eng.scan_range_batch(_ranges(), now=NOW)],
    }


def _ref_engine(path):
    return RefEngine(path, RefOptions(
        backend="tpu", memtable_bytes=4 << 10, l0_compaction_trigger=3,
        device_read_min_batch=1))


def _port_engine(path):
    return LsmEngine(path, EngineOptions(
        backend="cuda", device="cpu", memtable_bytes=4 << 10,
        l0_compaction_trigger=3))


@pytest.fixture
def engines(tmp_path):
    ref = _ref_engine(str(tmp_path / "ref"))
    port = _port_engine(str(tmp_path / "port"))
    _drive(ref, RefBatch)
    _drive(port, WriteBatch)
    port.wait_primes()  # flush outputs prime on a pool thread
    yield ref, port, tmp_path
    ref.close()
    port.close()


def test_same_state_and_answers_as_reference(engines):
    ref, port, _ = engines
    want = _answers(ref)
    with COMPACT_TRACER.session() as sess:
        got = _answers(port)
    assert got == want
    assert port.last_durable_decree() == ref.last_durable_decree() > 0
    assert port.last_committed_decree() == ref.last_committed_decree()
    assert want["digest"]["records"] > 100
    assert got["get_batch"] == got["get"]
    assert got["scan_range_batch"] == got["scan"]
    # the batched reads went through the device lookups
    stages = sess.summary()
    assert stages["read.lookup"]["calls"] > 0
    assert stages["read.range"]["calls"] > 0


def test_compacted_ssts_hold_resident_runs(engines):
    _, port, _ = engines
    ssts = port._all_ssts_locked()
    assert ssts and all(s.device_index is not None for s in ssts)
    assert port._device_resident_ssts == len(ssts)
    assert port._device_cache_used == sum(s._device_run.nbytes()
                                          for s in ssts)


def test_each_package_serves_the_others_directory(engines):
    ref, port, tmp_path = engines
    # the memtable is not durable (the replication log is the WAL): flush
    # it so the directory holds the whole state
    ref.flush()
    want = _answers(ref)
    ref.close()
    port.flush()
    port_answers = _answers(port)
    port.close()
    reopened = _port_engine(str(tmp_path / "ref"))
    try:
        got = _answers(reopened)
        assert got == want
        reopened.manual_compact(now=NOW)
        assert _answers(reopened) == want
    finally:
        reopened.close()
    ref_view = _ref_engine(str(tmp_path / "port"))
    try:
        assert _answers(ref_view) == port_answers
    finally:
        ref_view.close()


def test_value_residency_engine_matches_reference(tmp_path):
    """device_values=True: uniform-width outputs gather their values on
    the device; answers stay those of the reference engine."""
    ref = _ref_engine(str(tmp_path / "ref"))
    port = LsmEngine(str(tmp_path / "port"), EngineOptions(
        backend="cuda", device="cpu", memtable_bytes=4 << 10,
        l0_compaction_trigger=3, device_values=True))
    try:
        for eng, batch_cls in ((ref, RefBatch), (port, WriteBatch)):
            wb = batch_cls()
            for i in range(300):
                wb.put(generate_key(b"h%03d" % (i % 29), b"s%05d" % i),
                       SCHEMAS[2].generate_value(0, 0, b"pay%07d" % i))
            eng.write_batch([(wb, 1)])
            eng.manual_compact(now=NOW)
        ssts = port._all_ssts_locked()
        assert any(s._device_run.val2d is not None for s in ssts)
        assert _answers(port) == _answers(ref)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("pmask,file_bytes,mem_writes", [
    (0, None, False), (3, None, False), (31, None, False), (3, 4096, False),
    (0, None, True), (3, 4096, True)])
def test_single_run_digest_equals_the_merged_scan_and_reference(
        engines, pmask, file_bytes, mem_writes):
    """A fully compacted engine (one sorted level; its output in one
    file, or split into many; the memtable empty, or holding updates,
    deletes, new and expired keys over it) digests with array ops
    (_single_run_digest_rows): the same digest as the merged scan, and
    as the reference engine's after the same compaction and writes, with
    expired rows, tombstones and an ownership mask."""
    ref, port, _ = engines
    if file_bytes:
        port.opts.target_file_size_bytes = file_bytes
    for eng in (ref, port):
        eng.manual_compact(now=NOW)
    files = [f for fs in port._levels.values() for f in fs]
    assert (len(files) > 1) == bool(file_bytes)
    if mem_writes:
        keys = [port._levels[max(port._levels)][0].block().key(i)
                for i in (0, 3, 5)]
        for eng, batch_cls in ((ref, RefBatch), (port, WriteBatch)):
            wb = batch_cls()
            wb.put(keys[0], SCHEMAS[2].generate_value(0, 0, b"newer"), 0)
            wb.delete(keys[1])
            wb.put(keys[2], SCHEMAS[2].generate_value(NOW - 1, 0, b"x"),
                   NOW - 1)
            wb.put(generate_key(b"h999", b"fresh"),
                   SCHEMAS[2].generate_value(0, 0, b"f"), 0)
            eng.write_batch([(wb, eng.last_committed_decree() + 1)])
        assert len(port._mem) == 4
    assert port._single_run_digest_rows(NOW, pmask) is not None
    _assert_digests_agree(ref, port, pmask)


def _assert_digests_agree(ref, port, pmask):
    fast = port.state_digest(now=NOW, pmask=pmask)
    merged = list(port._merged_digest_rows(NOW, pmask))
    from pegasus_tpu_torch.base.crc64 import crc64_batch

    cs = [crc64_batch(*c) for c in merged]
    xor = add = 0
    for c in cs:
        xor ^= int(np.bitwise_xor.reduce(c)) if len(c) else 0
        add = (add + int(c.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
    assert fast["digest"] == f"{xor:016x}{add:016x}"
    assert fast["records"] == sum(len(c) for c in cs)
    assert fast == ref.state_digest(now=NOW, pmask=pmask)


@pytest.mark.parametrize("compacted,mem_rows", [(False, 0), (True, 0),
                                                 (False, 600), (True, 600)])
def test_wide_overlay_digest_equals_the_merged_scan_and_reference(
        tmp_path, compacted, mem_rows):
    """A base run under newer files holding far more rows than
    DIGEST_OVERLAY_MAX (a replica that learned a checkpoint with a second
    large run): the array path matches the overlay's keys by sorting
    (_wide_overlay_digest_rows) and its digest equals the merged scan's
    and the reference engine's, with updates, deletes, expired rows, keys
    that differ only by trailing zero bytes, an ownership mask and a
    memtable over it all."""
    ref = _ref_engine(str(tmp_path / "ref"))
    port = _port_engine(str(tmp_path / "port"))
    port.opts.memtable_bytes = 1 << 30       # one file per flush below
    port.opts.l0_compaction_trigger = 1 << 10
    rng = np.random.default_rng(11)
    n = 2 * port_db.DIGEST_OVERLAY_MAX
    try:
        steps = [[(k, 0) for k in range(n)],
                 [(int(k), int(op)) for k, op in zip(
                     rng.integers(0, n, n), rng.integers(0, 4, n))],
                 [(int(k), int(op)) for k, op in zip(
                     rng.integers(0, n, mem_rows), rng.integers(0, 4, mem_rows))]]
        for decree, step in enumerate(steps, 1):
            for eng, batch_cls in ((ref, RefBatch), (port, WriteBatch)):
                wb = batch_cls()
                for k, op in step:
                    key = generate_key(b"h%03d" % (k % 61),
                                       b"s%d" % (k // 3) + b"\0" * (k % 3))
                    exp = NOW - 1 if op == 1 else 0
                    if op == 3:
                        wb.delete(key)
                    else:
                        wb.put(key, SCHEMAS[2].generate_value(
                            exp, 0, b"v%d.%d" % (decree, k)), exp)
                if step:
                    eng.write_batch([(wb, decree)])
                if decree < 3:
                    eng.flush()
                if decree == 1 and compacted:
                    eng.manual_compact(now=NOW)
        newer = len(port._mem) + sum(
            f.n for f in (port._l0 if compacted else port._l0[:-1]))
        assert newer > port_db.DIGEST_OVERLAY_MAX
        for pmask in (0, 3):
            assert port._single_run_digest_rows(NOW, pmask) is not None
            _assert_digests_agree(ref, port, pmask)
    finally:
        ref.close()
        port.close()


def test_single_l0_file_digest_takes_the_array_path(tmp_path):
    """An engine whose one SST is an L0 flush (a checkpoint of a freshly
    loaded replica) digests with array ops too, equal to the merged scan
    and to the reference engine's."""
    ref = _ref_engine(str(tmp_path / "ref"))
    port = _port_engine(str(tmp_path / "port"))
    try:
        for eng, batch_cls in ((ref, RefBatch), (port, WriteBatch)):
            wb = batch_cls()
            for i in range(300):
                exp = NOW - 1 if i % 7 == 0 else 0
                wb.put(generate_key(b"h%03d" % (i % 31), b"s%d" % i),
                       SCHEMAS[2].generate_value(exp, 0, b"v%d" % i), exp)
            eng.write_batch([(wb, 1)])
            eng.flush()
        assert len(port._l0) == 1
        assert port._single_run_digest_rows(NOW, 3) is not None
        _assert_digests_agree(ref, port, 3)
    finally:
        ref.close()
        port.close()
