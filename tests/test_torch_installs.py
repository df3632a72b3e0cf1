"""The port engine's deferred installs and async device primes, held to
the JAX package's engine on the CPU.

Deferred installs (PEGASUS_COMPACT_PIPELINE_DEPTH > 1) swap an L0 or
cascade merge's outputs into the levels at once and write them on the
install pool; synchronous installs (depth 1) write them inline. Both
must serve and persist the data of the reference engine's compaction,
byte for byte, and reopen to it. A failed install job leaves the
pre-merge state on disk until the drain's repair pass lands the output.
An async prime whose upload raises (the `compact.h2d` fail point) makes
the next compaction or batched read raise, once; the run then primes
again on the device (no host pack). A checkpoint taken while an install
is in flight writes the unlanded output from its cached block.
An output consumed by the next merge before its install job landed it
is never written, and leaves no file behind.
"""

import hashlib
import os
import threading

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
from pegasus_tpu_torch.engine.sstable import SSTable
from pegasus_tpu_torch.runtime import fail_points as fp
from pegasus_tpu_torch.runtime.fail_points import FailPointError


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


@pytest.fixture
def failpoints():
    fp.setup()
    yield fp
    fp.teardown()


_SHAPE = dict(memtable_bytes=16 << 10, l0_compaction_trigger=2,
              target_file_size_bytes=24 << 10, level_base_bytes=48 << 10,
              level_size_ratio=4, max_levels=3)


def _port(path, backend="cuda", **kw):
    return LsmEngine(str(path), EngineOptions(
        backend=backend, device="cpu", **dict(_SHAPE, **kw)))


def _ref(path):
    from pegasus_tpu.engine import EngineOptions as RefOptions
    from pegasus_tpu.engine.db import LsmEngine as RefEngine

    return RefEngine(str(path), RefOptions(backend="cpu", **_SHAPE))


def _fill(eng, seed=3, n=2500, prefix=b"hk"):
    rng = np.random.default_rng(seed)
    for i in range(n):
        eng.put(generate_key(prefix + b"%04d" % rng.integers(0, 500),
                             b"s%d" % i),
                SCHEMAS[2].generate_value(
                    int(rng.integers(0, 60)) if i % 9 == 0 else 0, 0,
                    b"v%d" % i))
        if i % 23 == 0:
            eng.delete(generate_key(prefix + b"%04d" % rng.integers(0, 500),
                                    b"sX"))
    eng.flush()
    eng.compact(now=100)
    return eng


def _digest(eng):
    h = hashlib.sha256()
    for k, v, e in eng.scan(now=100):
        h.update(k)
        h.update(v)
        h.update(str(e).encode())
    return h.hexdigest()


def _settled(eng):
    """Every live file on disk, and the directory holds exactly the
    manifest's files."""
    live = {os.path.basename(s.path) for s in eng._all_ssts_locked()}
    for s in eng._all_ssts_locked():
        assert s._on_disk and os.path.exists(s.path), s.path
    on_disk = {f for f in os.listdir(eng.path) if f.endswith(".sst")}
    assert on_disk == live, (sorted(on_disk - live), sorted(live - on_disk))


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_installs_byte_equal_to_the_reference(tmp_path, monkeypatch, depth,
                                               backend):
    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", depth)
    want = _digest(_fill(_ref(tmp_path / "ref")))
    eng = _fill(_port(tmp_path / "port", backend))
    assert eng.stats()["level_files"], "the fill must reach the levels"
    assert _digest(eng) == want
    assert eng.compaction_debt()["pending_installs"] == 0
    _settled(eng)
    eng.close()
    reopened = _port(tmp_path / "port", backend)
    assert _digest(reopened) == want
    reopened.close()


def test_deferred_and_synchronous_installs_write_the_same_files(tmp_path,
                                                                monkeypatch):
    """Depth 2 and depth 1 leave the same SST bytes per level."""
    files = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", depth)
        eng = _fill(_port(tmp_path / depth))
        with eng._lock:
            files[depth] = {
                lv: [hashlib.sha256(open(s.path, "rb").read()).hexdigest()
                     for s in fs] for lv, fs in eng._levels.items()}
        eng.close()
    assert files["1"] == files["2"]


def test_failed_install_job_recovers_pre_merge_state(tmp_path, monkeypatch,
                                                     failpoints):
    """An install job that dies before writing keeps the durability
    invariant: the old manifest and inputs stay on disk until the
    drain's repair pass lands the output; reads serve the merged view
    throughout, and a reopen sees it."""
    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", "2")
    eng = _fill(_port(tmp_path / "db", "cpu"))
    # one-shot: the next pool task (an install job: a cpu engine primes
    # nothing) raises before it writes
    failpoints.cfg("compact.pipeline", "1*raise(injected install failure)")
    rng = np.random.default_rng(9)
    for i in range(2500):
        eng.put(generate_key(b"qk%04d" % rng.integers(0, 300), b"s%d" % i),
                SCHEMAS[2].generate_value(0, 0, b"w%d" % i))
    eng.flush()
    eng.compact(now=100)
    _settled(eng)
    digest = _digest(eng)
    eng.close()
    reopened = _port(tmp_path / "db", "cpu")
    assert _digest(reopened) == digest
    reopened.close()


def test_manifest_never_names_an_unwritten_file(tmp_path, monkeypatch):
    """While an install job is held, the on-disk manifest still names
    only the pre-merge files, every one of them on disk."""
    import json

    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", "2")
    eng = _port(tmp_path / "db", "cpu", l0_compaction_trigger=64)
    for i in range(300):
        eng.put(generate_key(b"m%03d" % i, b"s"), b"v" * 40)
        if i % 100 == 99:
            eng.flush()
    gate, entered = threading.Event(), threading.Event()
    job = LsmEngine._deferred_install_job

    def held(self, new_ssts):
        entered.set()
        gate.wait(10)
        return job(self, new_ssts)

    monkeypatch.setattr(LsmEngine, "_deferred_install_job", held)
    before = json.load(open(os.path.join(eng.path, "MANIFEST")))
    t = threading.Thread(target=eng.compact, kwargs={"now": 100})
    t.start()
    try:
        assert entered.wait(10)
        now = json.load(open(os.path.join(eng.path, "MANIFEST")))
        assert now["l0"] == before["l0"] and now["levels"] == before["levels"]
        for name in now["l0"]:
            assert os.path.exists(os.path.join(eng.path, name))
    finally:
        gate.set()
        t.join(10)
    after = json.load(open(os.path.join(eng.path, "MANIFEST")))
    assert after["l0"] == [] and after["levels"]["1"]
    _settled(eng)
    eng.close()


def test_checkpoint_while_an_install_is_in_flight(tmp_path, monkeypatch):
    """A checkpoint taken while an install job has not landed its output
    writes that output from the cached block: it succeeds, and the
    checkpoint reopens to the reference engine's data."""
    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", "2")

    def fill(eng):
        for i in range(300):
            eng.put(generate_key(b"m%03d" % i, b"s"), b"v%d" % i * 8)
            if i % 100 == 99:
                eng.flush()
        return eng

    ref = fill(_ref(tmp_path / "ref"))
    ref.compact(now=100)
    want = _digest(ref)
    eng = fill(_port(tmp_path / "db", "cpu", l0_compaction_trigger=64))
    gate, entered = threading.Event(), threading.Event()
    job = LsmEngine._deferred_install_job

    def held(self, new_ssts):
        entered.set()
        gate.wait(10)
        return job(self, new_ssts)

    monkeypatch.setattr(LsmEngine, "_deferred_install_job", held)
    t = threading.Thread(target=eng.compact, kwargs={"now": 100})
    t.start()
    try:
        assert entered.wait(10)
        assert any(not s._on_disk for s in eng._all_ssts_locked())
        decree = eng.sync_checkpoint(flush=False)
    finally:
        gate.set()
        t.join(10)
    restored = LsmEngine.apply_checkpoint(
        eng.get_checkpoint_dir(decree), str(tmp_path / "restored"),
        EngineOptions(backend="cpu", device="cpu", **_SHAPE))
    assert _digest(restored) == want
    restored.close()
    _settled(eng)
    eng.close()


def _write_path_flush(eng):
    """The flush a write's memtable rotation runs: it never raises an
    async prime's failure (flush() does, once the prime has failed)."""
    with eng._lock:
        eng._rotate_memtable_locked()
    eng._drain_imms()
    eng.wait_primes()


def test_async_prime_failure_raises_to_the_next_compact(tmp_path, failpoints):
    eng = _port(tmp_path / "db", l0_compaction_trigger=64)
    eng.put(generate_key(b"a", b"s"), b"v")
    failpoints.cfg("compact.h2d", "1*raise(device lost)")
    _write_path_flush(eng)
    sst = eng._l0[0]
    assert sst._device_run is None and sst._prime_error is not None
    eng.put(generate_key(b"b", b"s"), b"v")
    with pytest.raises(FailPointError, match="device lost"):
        eng.compact(now=100)
    # raised once; the run primes again on the device at its next use
    eng.flush()
    assert eng.compact(now=100)["input_records"] == 2
    # the outputs' primes run on the pool after their installs land
    eng.wait_primes()
    assert all(s._device_run is not None for s in eng._all_ssts_locked())
    assert eng.get(generate_key(b"a", b"s")) == b"v"
    eng.close()


def test_async_prime_failure_raises_to_the_caller_needing_the_run(
        tmp_path, failpoints):
    eng = _port(tmp_path / "db", l0_compaction_trigger=64)
    eng.put(generate_key(b"a", b"s"), b"v")
    failpoints.cfg("compact.h2d", "1*raise(device lost)")
    _write_path_flush(eng)
    sst = eng._l0[0]
    with pytest.raises(FailPointError):
        eng._device_run_budgeted(sst)
    # the engine-level slot went with it: a flush no longer raises
    eng.flush()
    assert eng._device_run_budgeted(sst) is not None
    eng.close()


def test_async_prime_failure_raises_to_a_batched_read(tmp_path, failpoints):
    """A batched get or scan that would probe a run whose async prime
    failed raises the failure; the next one primes the run on the
    device and reads it there, never by a host walk."""
    eng = _port(tmp_path / "db", l0_compaction_trigger=64)
    keys = [generate_key(b"a", b"s"), generate_key(b"b", b"s")]
    for k in keys:
        eng.put(k, b"v")
    failpoints.cfg("compact.h2d", "2*raise(device lost)")
    _write_path_flush(eng)
    sst = eng._l0[0]
    assert sst._device_run is None and sst._prime_error is not None
    with pytest.raises(FailPointError, match="device lost"):
        eng.get_batch(keys)
    # the kept failure is gone; the inline re-prime fails on the card too
    with pytest.raises(FailPointError, match="device lost"):
        eng.scan_range_batch([(keys[0], None), (keys[1], None)])
    assert eng.get_batch(keys) == [b"v", b"v"]
    assert sst.device_index is not None
    assert [len(list(it)) for it in eng.scan_range_batch(
        [(keys[0], None), (keys[1], None)])] == [2, 1]
    eng.close()


def test_async_prime_failure_raises_at_close(tmp_path, failpoints):
    eng = _port(tmp_path / "db", l0_compaction_trigger=64)
    eng.put(generate_key(b"a", b"s"), b"v")
    failpoints.cfg("compact.h2d", "1*raise(device lost)")
    _write_path_flush(eng)
    with pytest.raises(FailPointError):
        eng.close()
    assert eng._device_cache_used == 0


def test_consumed_before_landing_leaks_no_file(tmp_path, monkeypatch,
                                               failpoints):
    """Slow install jobs let a cascade consume outputs of the merge
    before them while their writes are still queued: those outputs are
    never written (their job skips them), no file is left behind, and
    the device budget returns to exactly the live runs."""
    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", "2")
    made = []
    orig = SSTable.from_block.__func__

    def record(cls, path, block, meta=None):
        sst = orig(cls, path, block, meta)
        made.append(sst)
        return sst

    monkeypatch.setattr(SSTable, "from_block", classmethod(record))
    failpoints.cfg("engine.sst_write", "sleep(20)")
    want = _digest(_fill(_ref(tmp_path / "ref")))
    eng = _fill(_port(tmp_path / "port", level_base_bytes=8 << 10,
                      target_file_size_bytes=8 << 10))
    superseded = [s for s in made if s._device_retired
                  and not os.path.exists(s.path)]
    assert made and superseded, "no output was consumed before landing"
    _settled(eng)
    eng.wait_primes()
    with eng._lock:
        live = eng._all_ssts_locked()
        resident = sum(s._device_run.nbytes() for s in live
                       if s._device_run is not None and s._device_budgeted)
        assert eng._device_cache_used == resident
    assert _digest(eng) == want
    eng.close()
