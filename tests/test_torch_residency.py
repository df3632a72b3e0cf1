"""Read residency: the engine's read-hot pin and its device-memory gauges,
and the replica stub's `detect_hotkey` / `set-read-residency` commands,
against pegasus_tpu's, in one process.

A port engine (backend="cuda", device="cpu": the kernels' plain versions)
runs in lockstep with a reference engine (backend="tpu" on JAX-CPU):

- the `engine.hbm.*` gauges register a cuda engine's budget at open,
  count its primes and releases, and drop it at close, as the
  reference's do for a tpu engine;
- `set_read_residency(True)` primes every current SST on the pipeline
  pool; off only clears the flag; `read_hot` is in `stats()`;
- at a device budget a little above one run, a cold engine's primes stop
  at 7/8 and a pinned engine fills the whole budget: the same resident
  SSTs and the same batched answers in both packages. The port holds u32
  lanes as int64, so a port run's nbytes is exactly twice the
  reference's less its padded length (the one-byte deleted column);
- a prime that fails under a pin raises to the next batched read (the
  port keeps an async prime's failure; ROADMAP Queue 3, PR 10);
- with the flag off, the engine writes the reference's SST bytes.

The stub commands answer the reference's reply lines.
"""

import os
import threading
import time

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu.engine.db import EngineOptions as RefOptions
from pegasus_tpu.engine.db import LsmEngine as RefEngine
from pegasus_tpu.runtime.perf_counters import counters as ref_counters
from pegasus_tpu_torch.engine import db as port_db
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
from pegasus_tpu_torch.runtime import fail_points as fp
from pegasus_tpu_torch.runtime.fail_points import FailPointError
from pegasus_tpu_torch.runtime.perf_counters import counters
from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

NOW = 100
V = SCHEMAS[2].generate_value(0, 0, b"")


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


@pytest.fixture(autouse=True)
def _every_batch_probes(monkeypatch):
    """Small tables give an SST few candidates per batch: probe the
    resident runs from one candidate up, as the reference engines do
    with device_read_min_batch=1."""
    monkeypatch.setattr(port_db, "DEVICE_READ_MIN_BATCH", 1)


@pytest.fixture
def failpoints():
    fp.setup()
    yield fp
    fp.teardown()


class _Pair:
    """A port cuda engine (device="cpu") and a reference tpu engine."""

    def __init__(self, root, **kw):
        kw = dict(dict(l0_compaction_trigger=100), **kw)
        self.port = LsmEngine(str(root / "port"),
                              EngineOptions(device="cpu", **kw))
        self.ref = RefEngine(str(root / "ref"), RefOptions(
            backend="tpu", device_reads=True, device_read_min_batch=1,
            **kw))
        self.both = (self.port, self.ref)

    def put(self, key, value):
        for e in self.both:
            e.put(key, value)

    def flush(self):
        for e in self.both:
            e.flush()
        self.port.wait_primes()

    def close(self):
        for e in self.both:
            e.close()


def _load(pair, seed=7, rounds=3, n=40):
    """Flushed runs of random keys under a few hash keys, one tombstone
    and one memtable-only row: the reads cross every layer."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for i in range(n):
            j = int(rng.integers(0, 200))
            pair.put(generate_key(b"h%d" % (j % 5), b"s%04d" % j),
                     V + b"v%d-%d" % (j, r))
        pair.flush()
    for e in pair.both:
        e.delete(generate_key(b"h0", b"s0000"))
    pair.put(generate_key(b"h2", b"memonly"), V + b"mem")


def _keys():
    ks = [generate_key(b"h%d" % (j % 5), b"s%04d" % j) for j in range(200)]
    return ks + [generate_key(b"h2", b"memonly"), generate_key(b"zz", b"")]


def _ssts(eng):
    with eng._lock:
        return eng._all_ssts_locked()


def _resident(eng):
    return [s for s in _ssts(eng) if s._device_budgeted]


def _run_bytes(eng):
    return sum(s._device_run.nbytes() for s in _resident(eng))


def test_hbm_residency_gauges(tmp_path):
    """Both packages publish their engines' budget at open, the primed
    runs' bytes and files, the release after a compaction, and drop the
    engine at close."""
    regs = (counters, ref_counters)
    names = ("engine.hbm.budget_bytes", "engine.hbm.resident_bytes",
             "engine.hbm.resident_ssts")
    before = [[c.number(n).value() for n in names] for c in regs]
    p = _Pair(tmp_path)
    try:
        for c, b, e in zip(regs, before, p.both):
            assert c.number(names[0]).value() >= b[0] + \
                e.opts.device_cache_bytes
        _load(p)
        for e in p.both:
            with e._lock:
                ssts = e._all_ssts_locked()
            for s in ssts:
                e._device_run_budgeted(s)
        res = [_resident(e) for e in p.both]
        assert len(res[0]) == len(res[1]) == 3
        for c, b, e, r in zip(regs, before, p.both, res):
            assert c.number(names[1]).value() >= b[1] + _run_bytes(e)
            assert c.number(names[2]).value() >= b[2] + len(r)
            st = e.stats()
            assert st["device_resident_ssts"] == len(r)
            assert st["device_resident_bytes"] == _run_bytes(e)
        # compaction consumes the inputs: the gauges release them
        for e in p.both:
            e.compact(now=NOW)
        p.port.wait_primes()
        assert p.port.stats()["device_resident_bytes"] >= 0
        assert [e.stats()["l0_files"] for e in p.both] == [0, 0]
        assert p.port.get_batch(_keys(), now=NOW) == \
            p.ref.get_batch(_keys(), now=NOW)
    finally:
        p.close()
    for c, b in zip(regs, before):
        assert c.number(names[0]).value() <= b[0]


def test_set_read_residency_primes_every_sst(tmp_path):
    """On: every current SST primes on the pipeline pool and `read_hot`
    reads True in stats(); off only clears the flag (resident runs
    stay)."""
    p = _Pair(tmp_path)
    try:
        # runs left unprimed at flush: the pin is what primes them
        p.port._prime_async = lambda sst: None
        _load(p)
        del p.port._prime_async
        assert [e.stats()["read_hot"] for e in p.both] == [False, False]
        assert not _resident(p.port)
        for e in p.both:
            e.set_read_residency(True)
        assert [e.stats()["read_hot"] for e in p.both] == [True, True]
        p.port.wait_primes()
        deadline = time.monotonic() + 10.0
        while not all(s.device_index is not None for s in _ssts(p.ref)):
            assert time.monotonic() < deadline, "reference primes"
            time.sleep(0.02)
        assert all(s.device_index is not None for s in _ssts(p.port))
        assert len(_resident(p.port)) == len(_resident(p.ref)) == 3
        for e in p.both:
            e.set_read_residency(False)
        assert [e.stats()["read_hot"] for e in p.both] == [False, False]
        assert len(_resident(p.port)) == 3
        assert p.port.get_batch(_keys(), now=NOW) == \
            p.ref.get_batch(_keys(), now=NOW)
    finally:
        p.close()


def test_read_hot_claims_the_reserved_budget_headroom(tmp_path, monkeypatch):
    """At a budget one byte above the first run's bytes, the cold engine
    stops the second run's prime at 7/8 of it and the pinned engine
    fills the whole budget; both packages hold the same resident SSTs
    and answer the same batched reads, on the device lanes."""
    p = _Pair(tmp_path)
    try:
        for e in p.both:
            monkeypatch.setattr(e, "_prime_async", lambda sst: None)
        for batch in range(2):
            for i in range(20):
                p.put(generate_key(b"h%d" % batch, b"s%03d" % i), V + b"v")
            p.flush()
        ssts = [_ssts(e) for e in p.both]
        assert [len(s) for s in ssts] == [2, 2]
        for e, s in zip(p.both, ssts):
            assert e._device_run_budgeted(s[0]) is not None
            # budget sized so only the FULL budget admits the second run
            e.opts.device_cache_bytes = e._device_cache_used + 1
        used = [e._device_cache_used for e in p.both]
        assert used[0] == 2 * used[1] - ssts[0][0]._device_run.padded_len
        for e, s in zip(p.both, ssts):
            e._device_run_budgeted(s[1])
            assert not s[1]._device_budgeted           # cold: 7/8
            assert e.stats()["device_resident_ssts"] == 1
        cold = [e.get_batch(_keys(), now=NOW) for e in p.both]
        assert cold[0] == cold[1]
        for e, s in zip(p.both, ssts):
            e.set_read_residency(True)
            assert e._device_run_budgeted(s[1]) is not None
            assert s[1]._device_budgeted               # hot: headroom
            st = e.stats()
            assert st["read_hot"] is True
            assert st["device_resident_ssts"] == 2
            assert st["device_resident_bytes"] > e.opts.device_cache_bytes \
                - (e.opts.device_cache_bytes >> 3)
        assert p.port.stats()["device_resident_bytes"] == \
            2 * p.ref.stats()["device_resident_bytes"] - sum(
                s._device_run.padded_len for s in ssts[0])
        with COMPACT_TRACER.session() as sess:
            hot = p.port.get_batch(_keys(), now=NOW)
        assert hot == p.ref.get_batch(_keys(), now=NOW) == cold[0]
        # both runs probed on the device lanes (one lookup per run)
        assert sess.summary()["read.lookup"]["calls"] == 2
    finally:
        p.close()


def test_pinned_prime_failure_raises_to_the_next_batched_read(tmp_path,
                                                              failpoints):
    """The pin's async prime fails on the device: the failure is kept
    and raised to the next batched read that needs the run, never a
    quiet host walk; the read after it primes and serves the run."""
    eng = LsmEngine(str(tmp_path / "db"), EngineOptions(
        device="cpu", l0_compaction_trigger=100))
    try:
        keys = [generate_key(b"a", b"s"), generate_key(b"b", b"s")]
        eng._prime_async = lambda sst: None   # the flush leaves it cold
        for k in keys:
            eng.put(k, b"v")
        eng.flush()
        del eng._prime_async
        sst = eng._l0[0]
        assert sst._device_run is None
        failpoints.cfg("compact.h2d", "2*raise(device lost)")
        eng.set_read_residency(True)
        eng.wait_primes()
        assert sst._prime_error is not None
        with pytest.raises(FailPointError, match="device lost"):
            eng.get_batch(keys)
        with pytest.raises(FailPointError, match="device lost"):
            eng.get_batch(keys)       # the inline re-prime fails too
        assert eng.get_batch(keys) == [b"v", b"v"]
        assert sst.device_index is not None
        assert eng.stats()["read_hot"] is True
    finally:
        eng.close()


def test_residency_off_writes_the_reference_bytes(tmp_path):
    """Flag never set: flushes and a compaction write the reference's SST
    bytes and the same digest; after a pin and an unpin, too."""
    p = _Pair(tmp_path)
    try:
        _load(p, seed=11)
        for e in p.both:
            e.set_read_residency(True)
            e.set_read_residency(False)
        _load(p, seed=12, rounds=2)
        for e in p.both:
            e.compact(now=NOW)
        p.port.wait_primes()
        files = []
        for e in p.both:
            files.append([open(os.path.join(e.path, f), "rb").read()
                          for f in sorted(os.listdir(e.path))
                          if f.endswith(".sst")])
        assert files[0] == files[1] and files[0]
        assert p.port.state_digest(now=NOW) == p.ref.state_digest(now=NOW)
    finally:
        p.close()


# ---------------------------------------------------------- stub commands


class _Rep:
    pass


def _stub_with(mod, server):
    stub = mod.ReplicaStub.__new__(mod.ReplicaStub)
    stub._lock = threading.Lock()
    rep = _Rep()
    rep.server = server
    stub._replicas = {(1, 0): rep}
    return stub


def test_stub_commands_answer_the_reference_lines(tmp_path):
    """detect_hotkey and set-read-residency on a one-replica stub of each
    package: the same reply lines for the same arguments, and the engine
    flag follows the pin."""
    from pegasus_tpu.engine.server_impl import PegasusServer as RefServer
    from pegasus_tpu.replication import replica_stub as ref_stub
    from pegasus_tpu_torch.engine.server_impl import PegasusServer
    from pegasus_tpu_torch.replication import replica_stub as port_stub

    port_srv = PegasusServer(str(tmp_path / "p"), app_id=1, pidx=0,
                             options=EngineOptions(device="cpu"))
    ref_srv = RefServer(str(tmp_path / "r"), app_id=1, pidx=0,
                        options=RefOptions(backend="tpu"))
    stubs = (_stub_with(port_stub, port_srv), _stub_with(ref_stub, ref_srv))
    try:
        for args in (["1.0", "read", "start"], ["1.0", "read", "query"],
                     ["1.0", "write", "start"], ["1.0", "write", "stop"],
                     ["1.0", "bogus", "start"], ["1.0", "read", "nope"],
                     ["9.9", "read", "query"], ["1.0", "read"],
                     ["1.0", "read", "stop"]):
            got = [s._cmd_detect_hotkey(list(args)) for s in stubs]
            assert got[0] == got[1], args
        for args in (["1.0", "on"], ["1.0", "off"], ["1.0"],
                     ["1.0", "maybe"], ["9.9", "on"], ["1.0", "on"]):
            got = [s._cmd_set_read_residency(list(args)) for s in stubs]
            assert got[0] == got[1], args
        assert port_srv.engine.stats()["read_hot"] is True
        assert ref_srv.engine.stats()["read_hot"] is True
        for s in stubs:
            s._cmd_set_read_residency(["1.0", "off"])
        assert port_srv.engine.stats()["read_hot"] is False
    finally:
        port_srv.close()
        ref_srv.close()
