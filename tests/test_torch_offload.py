"""The port's compaction-offload plane against the JAX package's.

The run wire and every ported message encode to the same bytes in both
packages and each package decodes the other's. Then real rounds over
loopback sockets: the port's client against the port's service, the
reference's client against the port's service and the port's client
against the reference's service, each output byte-equal (all nine
KVBlock columns) to the reference's compact_blocks(backend="cpu"),
with a default_ttl and with user rules too. The port's services run
backend="cuda" on device="cpu" (the device pipeline with the plain
merge); the reference's run backend="cpu". Then the failure paths (a
refusal, a dead service, a failed merge: each an OffloadError on the
tenant, never a local merge), the engine's placement lease, the
offload-status command and the server entry point as a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import typing

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu.engine import compaction_rules as ref_rules
from pegasus_tpu.engine.block import KVBlock as RefBlock
from pegasus_tpu.ops import compact as ref_compact
from pegasus_tpu.ops import packing as ref_packing
from pegasus_tpu.replication import compact_offload as ref_offload
from pegasus_tpu.replication import learn as ref_learn
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu.rpc import transport as ref_transport
from pegasus_tpu.runtime import remote_command as ref_rc
from pegasus_tpu_torch.engine import compaction_rules as port_rules
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine, WriteBatch
from pegasus_tpu_torch.ops import packing as port_packing
from pegasus_tpu_torch.ops.compact import CompactOptions
from pegasus_tpu_torch.parallel import sharded_compact as port_meshed
from pegasus_tpu_torch.replication import compact_offload as port_offload
from pegasus_tpu_torch.replication import learn as port_learn
from pegasus_tpu_torch.rpc import codec as port_codec
from pegasus_tpu_torch.rpc import messages as port_msg
from pegasus_tpu_torch.rpc import transport as port_transport
from pegasus_tpu_torch.runtime import remote_command as port_rc
from pegasus_tpu_torch.runtime.perf_counters import counters
from tests.test_torch_compact import FIELDS, assert_same, to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 100
RULE_SPEC = json.dumps({"ops": [
    {"type": "COT_DELETE", "params": "{}",
     "rules": [{"type": "FRT_HASHKEY_PATTERN", "params": json.dumps(
         {"pattern": "h01", "match_type": "SMT_MATCH_PREFIX"})}]},
    {"type": "COT_UPDATE_TTL", "params": json.dumps(
        {"type": "UTOT_FROM_NOW", "value": 500}),
     "rules": [{"type": "FRT_SORTKEY_PATTERN", "params": json.dumps(
         {"pattern": "7", "match_type": "SMT_MATCH_ANYWHERE"})}]}]})


def _ref_run(seed, n=300, keyspace=240):
    """A reference KVBlock: sorted unique keys, v2 values, some expired
    TTLs, some tombstones."""
    rng = np.random.default_rng(seed)
    recs = {}
    for i in rng.permutation(keyspace)[:n]:
        k = generate_key(b"h%03d" % (i % 23), b"s%05d" % i)
        exp = int(rng.choice([0, 0, 0, NOW - 10, NOW + 50]))
        recs[k] = (k, SCHEMAS[2].generate_value(exp, 0, b"v%d.%d" % (i, seed)),
                   exp, bool(rng.random() < 0.1))
    return RefBlock.from_records(sorted(recs.values(), key=lambda r: r[0]))


def _runs(k=3, seed=0):
    ref = [_ref_run(seed + s) for s in range(k)]
    return ref, [to_port(b) for b in ref]


def _to_ref(block) -> RefBlock:
    return RefBlock(*[np.array(getattr(block, f)) for f in FIELDS])


VARIANTS = {
    "plain": {},
    "default_ttl": {"default_ttl": 3600},
    "user_rules": {"rules": True},
    "split_gc": {"pidx": 1, "partition_mask": 3, "bottommost": False},
}


def _opts(variant):
    """(reference CompactOptions on cpu, port CompactOptions on cpu) for
    one VARIANTS entry."""
    kw = dict(VARIANTS[variant])
    rules = kw.pop("rules", False)
    ref = ref_compact.CompactOptions(
        backend="cpu", now=NOW, runs_sorted=True,
        user_ops=tuple(ref_rules.parse_user_specified_compaction(RULE_SPEC))
        if rules else (), **kw)
    port = CompactOptions(
        backend="cpu", now=NOW, runs_sorted=True,
        user_ops=tuple(port_rules.parse_user_specified_compaction(RULE_SPEC))
        if rules else (), **kw)
    return ref, port


@pytest.fixture
def port_svc(tmp_path):
    svc = port_offload.CompactOffloadService(
        str(tmp_path / "port_svc"), backend="cuda", device="cpu").start()
    yield svc
    svc.stop()


@pytest.fixture
def ref_svc(tmp_path):
    svc = ref_offload.CompactOffloadService(str(tmp_path / "ref_svc"),
                                            backend="cpu").start()
    yield svc
    svc.stop()


@pytest.fixture(autouse=True)
def _clean_ref_lane():
    ref_offload.OFFLOAD_LANE_GUARD.reset()
    yield
    ref_offload.OFFLOAD_LANE_GUARD.reset()


# ---------------------------------------------------------------- run wire


@pytest.mark.parametrize("kind", ["runs", "empty", "long_keys"])
def test_run_wire_same_bytes_both_packages(kind):
    if kind == "runs":
        ref_blocks = _runs(2)[0]
    elif kind == "empty":
        ref_blocks = [RefBlock.empty()]
    else:
        ref_blocks = [RefBlock.from_records(
            [(generate_key(b"h" * 40, b"s%03d" % i), b"v" * i, i, i % 5 == 0)
             for i in range(50)])]
    for rb in ref_blocks:
        pb = to_port(rb)
        want = ref_packing.pack_run_bytes(rb)
        assert port_packing.pack_run_bytes(pb) == want
        assert_same(rb, port_packing.unpack_run_bytes(want))
        assert_same(ref_packing.unpack_run_bytes(
            port_packing.pack_run_bytes(pb)), pb)


@pytest.mark.parametrize("data", [b"not a run at all" * 4, b"",
                                  b"PGRN1\n", b"PGRN1\n\x04\x00\x00\x00{}x",
                                  b"PGRN1\n\x02\x00\x00\x00{}",
                                  ref_packing.pack_run_bytes(
                                      _ref_run(3))[:-7]])
def test_run_wire_rejects_garbage(data):
    with pytest.raises(ValueError):
        port_packing.unpack_run_bytes(data)


def test_chunk_waves_same_grid():
    for total, chunk in ((0, 4096), (1, 4096), (4096, 4096),
                         (10 << 20, 1 << 20), (5_000_001, 65536)):
        assert list(port_learn.chunk_waves(total, chunk)) == \
            list(ref_learn.chunk_waves(total, chunk))


# ------------------------------------------------------------------- codec

MESSAGES = [
    (port_msg.LearnBlockEntry, ref_msg.LearnBlockEntry),
    (port_msg.LearnFetchResponse, ref_msg.LearnFetchResponse),
    (port_msg.OffloadBeginRequest, ref_msg.OffloadBeginRequest),
    (port_msg.OffloadBeginResponse, ref_msg.OffloadBeginResponse),
    (port_msg.OffloadShipRequest, ref_msg.OffloadShipRequest),
    (port_msg.OffloadShipResponse, ref_msg.OffloadShipResponse),
    (port_msg.OffloadMergeRequest, ref_msg.OffloadMergeRequest),
    (port_msg.OffloadMergeResponse, ref_msg.OffloadMergeResponse),
    (port_msg.OffloadFetchRequest, ref_msg.OffloadFetchRequest),
    (port_msg.OffloadFinishRequest, ref_msg.OffloadFinishRequest),
    (port_transport.RpcHeader, ref_transport.RpcHeader),
    (port_rc.RemoteCommandRequest, ref_rc.RemoteCommandRequest),
    (port_rc.RemoteCommandResponse, ref_rc.RemoteCommandResponse),
]


def _value(t, rng, cls_of):
    """A seeded value of annotation `t`; nested dataclasses are built as
    cls_of(port class)."""
    origin = typing.get_origin(t)
    if origin in (list, typing.List):
        (item,) = typing.get_args(t)
        return [_value(item, rng, cls_of)
                for _ in range(int(rng.integers(0, 4)))]
    if dataclasses.is_dataclass(t):
        return _instance(t, rng, cls_of)
    if t is bool:
        return bool(rng.integers(0, 2))
    if t is int:
        return int(rng.choice([0, 1, -1, 127, 128, -(1 << 40), (1 << 62),
                               int(rng.integers(-10**9, 10**9))]))
    if t is str:
        return "".join(rng.choice(list("abcxyz:.éλ0")) for _ in
                       range(int(rng.integers(0, 12))))
    if t is bytes:
        return rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
    raise TypeError(t)


def _instance(port_cls, rng, cls_of):
    hints = typing.get_type_hints(port_cls)
    return cls_of(port_cls)(**{f.name: _value(hints[f.name], rng, cls_of)
                               for f in dataclasses.fields(port_cls)})


@pytest.mark.parametrize("port_cls,ref_cls", MESSAGES,
                         ids=[p.__name__ for p, _ in MESSAGES])
def test_codec_same_bytes_both_packages(port_cls, ref_cls):
    """Field names, order, types and defaults equal; seeded instances
    (non-default trace_id and sharded headers included) encode to the
    same bytes in both packages, and each decodes the other's."""
    pf, rf = dataclasses.fields(port_cls), dataclasses.fields(ref_cls)
    assert [f.name for f in pf] == [f.name for f in rf]
    assert typing.get_type_hints(port_cls).keys() == \
        typing.get_type_hints(ref_cls).keys()
    assert port_codec.encode(port_cls()) == ref_codec.encode(ref_cls())
    pairs = dict((p, r) for p, r in MESSAGES)
    for seed in range(12):
        port_obj = _instance(port_cls, np.random.default_rng(seed),
                             lambda c: c)
        ref_obj = _instance(port_cls, np.random.default_rng(seed),
                            lambda c: pairs[c])
        wire = port_codec.encode(port_obj)
        assert wire == ref_codec.encode(ref_obj)
        assert dataclasses.asdict(ref_codec.decode(ref_cls, wire)) == \
            dataclasses.asdict(port_obj)
        assert dataclasses.asdict(port_codec.decode(port_cls, wire)) == \
            dataclasses.asdict(ref_obj)


def test_header_with_trace_fields_decodes_in_the_port():
    h = ref_transport.RpcHeader(seq=7, code="RPC_X", trace_id=(1 << 60) + 3,
                                trace_sampled=True, sharded=True,
                                error=6, error_text="boom", is_response=True)
    got = port_codec.decode(port_transport.RpcHeader, ref_codec.encode(h))
    assert dataclasses.asdict(got) == dataclasses.asdict(h)


# ------------------------------------------------------------ merge rounds


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_client_port_service(port_svc, variant):
    ref_runs, port_runs = _runs()
    ref_opts, port_opts = _opts(variant)
    want = ref_compact.compact_blocks(ref_runs, ref_opts).block
    got = port_offload.offload_compact_blocks(port_runs, port_opts,
                                              port_svc.address, tenant="t1")
    assert_same(want, got.block)
    assert got.stats["offloaded"] is True
    assert got.stats["service"] == port_svc.address
    assert got.stats["shipped_runs"] == 3 and got.stats["skipped_runs"] == 0
    assert got.stats["shipped_bytes"] > 0 and got.stats["fetched_bytes"] > 0
    assert [s["name"] for s in got.stats["service_spans"]] == [
        "offload.svc.begin", "offload.svc.load", "offload.svc.merge",
        "offload.svc.publish"]
    assert port_svc.status()["merges_done"] == 1
    if variant == "default_ttl":
        assert int(got.block.expire_ts.max()) == NOW + 3600


@pytest.mark.parametrize("variant", ["plain", "default_ttl", "user_rules"])
def test_reference_client_port_service(port_svc, variant):
    """A pegasus_tpu tenant merges on the port's service: byte-equal, and
    its lane records no fallback, so the merge really ran there."""
    ref_runs, _ = _runs(seed=5)
    ref_opts, _ = _opts(variant)
    want = ref_compact.compact_blocks(ref_runs, ref_opts).block
    got = ref_offload.offload_compact_blocks(ref_runs, ref_opts,
                                             port_svc.address, tenant="ref")
    assert_same(want, got.block)
    assert got.stats["offloaded"] is True
    assert ref_offload.OFFLOAD_LANE_GUARD.state()["fallbacks"] == 0
    assert port_svc.status()["merges_done"] == 1


@pytest.mark.parametrize("variant", ["plain", "default_ttl", "user_rules"])
def test_port_client_reference_service(ref_svc, variant):
    ref_runs, port_runs = _runs(seed=9)
    ref_opts, port_opts = _opts(variant)
    want = ref_compact.compact_blocks(ref_runs, ref_opts).block
    got = port_offload.offload_compact_blocks(port_runs, port_opts,
                                              ref_svc.address, tenant="p")
    assert_same(want, got.block)
    assert ref_svc.status()["merges_done"] == 1


def test_second_round_ships_nothing(port_svc):
    ref_runs, port_runs = _runs(seed=2)
    ref_opts, port_opts = _opts("plain")
    want = ref_compact.compact_blocks(ref_runs, ref_opts).block
    first = port_offload.offload_compact_blocks(port_runs, port_opts,
                                                port_svc.address)
    again = port_offload.offload_compact_blocks(port_runs, port_opts,
                                                port_svc.address)
    assert first.stats["shipped_runs"] == 3
    assert again.stats["shipped_bytes"] == 0
    assert again.stats["skipped_runs"] == 3 and again.stats["shipped_runs"] == 0
    assert_same(want, first.block)
    assert_same(want, again.block)


def test_two_tenants_at_once(port_svc):
    """max_concurrent 2: two concurrent rounds both merge, neither is
    refused, each byte-equal to its own cpu merge."""
    jobs = [(_runs(seed=20), "default_ttl"), (_runs(seed=40), "user_rules")]
    out, errs = {}, []

    def tenant(i):
        try:
            (_, port_runs), variant = jobs[i]
            out[i] = port_offload.offload_compact_blocks(
                port_runs, _opts(variant)[1], port_svc.address,
                tenant=f"t{i}")
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=tenant, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    for i, ((ref_runs, _), variant) in enumerate(jobs):
        want = ref_compact.compact_blocks(ref_runs, _opts(variant)[0]).block
        assert_same(want, out[i].block)
    assert port_svc.status()["merges_done"] == 2


# ------------------------------------------------------------ failure paths


def test_admission_gate_refuses_with_offload_error(tmp_path, monkeypatch):
    svc = port_offload.CompactOffloadService(
        str(tmp_path / "svc"), backend="cuda", device="cpu",
        max_concurrent=1).start()
    release = threading.Event()
    real = port_meshed.compact_blocks_meshed

    def held(blocks, opts, mesh=None):
        release.wait(20.0)
        return real(blocks, opts, mesh)

    monkeypatch.setattr(port_meshed, "compact_blocks_meshed", held)
    _, runs_a = _runs(seed=60)
    _, runs_b = _runs(2, seed=70)
    opts = _opts("plain")[1]
    rejects = counters.rate("offload.service.reject_count").total()
    box = {}
    t = threading.Thread(target=lambda: box.update(
        a=port_offload.offload_compact_blocks(runs_a, opts, svc.address)))
    t.start()
    try:
        deadline = time.monotonic() + 10.0
        while svc.status()["running_merges"] < 1:
            assert time.monotonic() < deadline, "merge never started"
            time.sleep(0.02)
        with pytest.raises(port_offload.OffloadError, match="busy"):
            port_offload.offload_compact_blocks(runs_b, opts, svc.address)
        assert counters.rate(
            "offload.service.reject_count").total() >= rejects + 1
    finally:
        release.set()
        t.join(timeout=30.0)
        svc.stop()
    assert not t.is_alive() and box["a"].stats["offloaded"]


def test_dead_service_raises_fast():
    _, runs = _runs(2)
    t0 = time.monotonic()
    with pytest.raises(port_offload.OffloadError):
        port_offload.offload_compact_blocks(runs, _opts("plain")[1],
                                            "127.0.0.1:1")
    assert time.monotonic() - t0 < 20.0


def test_stopped_service_fails_its_tenant(tmp_path):
    """A service stopped in-process drops its live connections: the next
    round fails at once instead of waiting out a timeout."""
    svc = port_offload.CompactOffloadService(
        str(tmp_path / "svc"), backend="cuda", device="cpu").start()
    _, runs = _runs(2, seed=80)
    opts = _opts("plain")[1]
    port_offload.offload_compact_blocks(runs, opts, svc.address)
    svc.stop()
    t0 = time.monotonic()
    with pytest.raises(port_offload.OffloadError):
        port_offload.offload_compact_blocks(runs, opts, svc.address)
    assert time.monotonic() - t0 < 20.0


def test_failed_merge_reaches_the_tenant_as_error(port_svc, monkeypatch):
    def broken(blocks, opts, mesh=None):
        raise RuntimeError("merge_path merge kernel launch failed: "
                           "cudaError 700")

    monkeypatch.setattr(port_meshed, "compact_blocks", broken)
    _, runs = _runs(2, seed=90)
    with pytest.raises(port_offload.OffloadError, match="cudaError 700"):
        port_offload.offload_compact_blocks(runs, _opts("plain")[1],
                                            port_svc.address)
    st = port_svc.status()
    assert st["merges_done"] == 0 and st["running_merges"] == 0


def test_meshed_merge_takes_one_card_only():
    _, runs = _runs(2)
    opts = CompactOptions(backend="cuda", device="cpu", now=NOW,
                          runs_sorted=True)
    one = port_meshed.compact_blocks_meshed(runs, opts, mesh=["cpu"])
    none = port_meshed.compact_blocks_meshed(runs, opts)
    assert_same(_to_ref(none.block), one.block)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        port_meshed.compact_blocks_meshed(runs, opts, mesh=["cpu", "cpu"])


def test_default_service_merges_on_the_card_only(tmp_path):
    """With no device the service merges on CUDA; without a card the
    tenant gets the failure, never a CPU merge in its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path runs there")
    svc = port_offload.CompactOffloadService(str(tmp_path / "s")).start()
    try:
        assert svc.backend == "cuda" and svc.device is None
        with pytest.raises(port_offload.OffloadError):
            port_offload.offload_compact_blocks(_runs(2)[1],
                                                _opts("plain")[1],
                                                svc.address)
        assert svc.status()["merges_done"] == 0
    finally:
        svc.stop()


def test_service_takes_cuda_or_cpu_only(tmp_path):
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_offload.CompactOffloadService(str(tmp_path / "s"),
                                           backend="tpu")


# ------------------------------------------------------------------ engine


def _load(eng, n=900, flush_every=300):
    for i in range(n):
        k = generate_key(b"h%03d" % (i % 40), b"s%05d" % (i % 350))
        wb = WriteBatch()
        if i % 11 == 0:
            wb.delete(k)
        else:
            wb.put(k, SCHEMAS[2].generate_value(0, 0, b"v%06d" % i))
        eng.write(wb, i + 1)
        if i % flush_every == flush_every - 1:
            eng.flush()


def test_engine_placement_lease(tmp_path, port_svc):
    opts = dict(backend="cpu", l0_compaction_trigger=2, memtable_bytes=1 << 20)
    local = LsmEngine(str(tmp_path / "local"), EngineOptions(**opts))
    offl = LsmEngine(str(tmp_path / "offl"), EngineOptions(**opts))
    offl.set_offload_target(port_svc.address, ttl_s=600)
    before = counters.rate("engine.compact.offload_count").total()
    try:
        assert offl.offload_target() == port_svc.address
        _load(local)
        _load(offl)
        local.manual_compact(now=NOW)
        offl.manual_compact(now=NOW)
        assert offl.state_digest(now=NOW) == local.state_digest(now=NOW)
        done = port_svc.status()["merges_done"]
        assert done >= 1
        assert counters.rate(
            "engine.compact.offload_count").total() >= before + 1
        # a lapsed lease compacts locally again
        offl.set_offload_target(port_svc.address, ttl_s=0.0)
        assert offl.offload_target() is None
        for eng in (local, offl):
            eng.put(generate_key(b"h999", b"late"),
                    SCHEMAS[2].generate_value(0, 0, b"x"))
            eng.manual_compact(now=NOW)
        assert port_svc.status()["merges_done"] == done
        assert offl.state_digest(now=NOW) == local.state_digest(now=NOW)
    finally:
        local.close()
        offl.close()


def test_cuda_engine_never_offloads(tmp_path, port_svc):
    eng = LsmEngine(str(tmp_path / "e"), EngineOptions(
        backend="cuda", device="cpu", l0_compaction_trigger=2,
        memtable_bytes=1 << 20))
    eng.set_offload_target(port_svc.address, ttl_s=600)
    try:
        _load(eng, n=400)
        eng.manual_compact(now=NOW)
    finally:
        eng.close()
    assert port_svc.status()["merges_done"] == 0


# ------------------------------------------------------- status and server


def _remote_command(addr, command, args=()):
    """offload-status and friends over the wire, with the reference's
    connection and RemoteCommandResponse."""
    host, _, port = addr.rpartition(":")
    conn = ref_transport.RpcConnection((host, int(port)))
    try:
        _, body = conn.call("RPC_CLI_CLI_CALL", ref_codec.encode(
            ref_rc.RemoteCommandRequest(command, list(args))), timeout=10)
    finally:
        conn.close()
    return ref_codec.decode(ref_rc.RemoteCommandResponse, body).output


def test_offload_status_over_the_wire(port_svc):
    _, runs = _runs(2, seed=11)
    port_offload.offload_compact_blocks(runs, _opts("plain")[1],
                                        port_svc.address)
    st = json.loads(_remote_command(port_svc.address, "offload-status"))
    assert st["backend"] == "cuda" and st["free_slots"] == 2
    assert st["merges_done"] == 1 and st["address"] == port_svc.address
    counters_out = json.loads(_remote_command(
        port_svc.address, "perf-counters-by-prefix", ["offload.service."]))
    assert "offload.service.merge_count" in counters_out
    assert "offload-status" in _remote_command(port_svc.address, "help")
    ev = json.loads(_remote_command(port_svc.address, "events-dump",
                                    ["50", "offload."]))
    assert any(e["name"] == "offload.merge" for e in
               next(iter(ev.values())))


def _ini(tmp_path, body: str) -> str:
    path = tmp_path / "server.ini"
    path.write_text(body)
    return str(path)


def _server(ini, *args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "pegasus_tpu_torch.server", "--config", ini,
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(os.path.dirname(ini)))


def test_entry_point_boots_answers_and_stops(tmp_path):
    ini = _ini(tmp_path, f"""
[apps.offload]
type = compact_offload
backend = cpu
port = 0
job_dir = {tmp_path / "jobs"}

[apps.other]
type = compact_offload
run = false
""")
    proc = _server(ini, "--app", "offload")
    try:
        line = ""
        deadline = time.monotonic() + 60
        while "started" not in line:
            assert time.monotonic() < deadline and proc.poll() is None, \
                proc.stderr.read()
            line = proc.stdout.readline()
        assert line.startswith("[pegasus-tpu] app offload started ")
        addr = line.split()[-1]
        st = json.loads(_remote_command(addr, "offload-status"))
        assert st["backend"] == "cpu" and st["free_slots"] == 2
        ref_runs, port_runs = _runs(2, seed=13)
        ref_opts, port_opts = _opts("default_ttl")
        got = port_offload.offload_compact_blocks(port_runs, port_opts, addr)
        assert_same(ref_compact.compact_blocks(ref_runs, ref_opts).block,
                    got.block)
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    assert rc == 0


@pytest.mark.parametrize("section", [
    "[apps.collector]\ntype = collector\nport = 0\n",
    "[apps.offload]\ntype = compact_offload\nbackend = tpu\nport = 0\n",
])
def test_entry_point_refuses_what_the_port_lacks(tmp_path, section):
    if "collector" in section:
        # the collector role is served now: it boots (its meta is a dead
        # address) and stops on SIGTERM with rc 0
        proc = _server(_ini(tmp_path, section + "[pegasus.server]\n"
                            "meta_servers = 127.0.0.1:1\n"))
        try:
            line = proc.stdout.readline()
            assert line.startswith("[pegasus-tpu] collector rpc on ")
            assert proc.stdout.readline().startswith(
                "[pegasus-tpu] app collector started ")
        finally:
            proc.terminate()
            _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        return
    proc = _server(_ini(tmp_path, section))
    _, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "cuda or cpu" in err
