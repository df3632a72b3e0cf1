"""The port's partition data plane against the JAX package's, over real
sockets, and the cross-package byte identity of every rrdb message.

The shapes of tests/test_rpc_onebox.py: two RpcServers ("nodes"), four
partitions split across them, each partition a PegasusServer behind a
ReplicaService, and a PegasusClient routing by partition hash through a
StaticResolver. Every scenario runs in all four mixes of a port or
reference client against port or reference servers, and its answers
must equal those of the reference client against reference servers:
point ops with TTLs, multi ops, incr, CAS, check_and_mutate, hash and
full-table scanners, batch_get, the async wrappers, scan sessions,
misrouted requests, and a bulk-load ingest through RPC_BULK_LOAD_INGEST
of raw sets written by the other package. The port's servers run the
cuda backend on device="cpu"; the reference's the cpu backend.
"""

import dataclasses
import threading
import time
import typing

import numpy as np
import pytest
import torch

from pegasus_tpu import client as ref_client
from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine import bulk_load as ref_bulk
from pegasus_tpu.engine.replica_service import ReplicaService as RefService
from pegasus_tpu.engine.server_impl import PegasusServer as RefServer
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu.rpc import transport as ref_transport
from pegasus_tpu_torch import client as port_client
from pegasus_tpu_torch.base.key_schema import (generate_key,
                                               generate_next_bytes, key_hash)
from pegasus_tpu_torch.engine import bulk_load as port_bulk
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.engine.replica_service import ReplicaService
from pegasus_tpu_torch.engine.server_impl import PegasusServer
from pegasus_tpu_torch.ops import device_watchdog
from pegasus_tpu_torch.rpc import codec as port_codec
from pegasus_tpu_torch.rpc import messages as port_msg
from pegasus_tpu_torch.rpc import task_codes as codes
from pegasus_tpu_torch.rpc import transport as port_transport
from tests.test_torch_offload import _value

N_PARTITIONS = 4
APP_ID = 7

PKG = {"port": (port_client, port_msg, port_transport, port_codec),
       "ref": (ref_client, ref_msg, ref_transport, ref_codec)}


class Onebox:
    """Two RpcServers of one package, four partitions split across them."""

    def __init__(self, root, kind: str, device=None):
        self.kind = kind
        transport = PKG[kind][2]
        self.rpcs, self.servers, addr = [], [], {}
        for node in range(2):
            svc = ReplicaService() if kind == "port" else RefService()
            rpc = transport.RpcServer()
            if kind == "ref":
                # poll the accept loop as often as the port's does, so a
                # stop waits 50 ms, not half a second
                rpc._thread = threading.Thread(
                    target=rpc._srv.serve_forever,
                    kwargs={"poll_interval": 0.05}, daemon=True)
            rpc.start()
            for pidx in range(N_PARTITIONS):
                if pidx % 2 != node:
                    continue
                path = str(root / f"{kind}_p{pidx}")
                if kind == "port":
                    ps = PegasusServer(path, app_id=APP_ID, pidx=pidx,
                                       server=f"node{node}",
                                       options=EngineOptions(device=device))
                else:
                    ps = RefServer(path, app_id=APP_ID, pidx=pidx,
                                   options=RefOptions(backend="cpu"),
                                   server=f"node{node}")
                svc.add_replica(ps, N_PARTITIONS)
                self.servers.append(ps)
                addr[pidx] = rpc.address
            rpc.register_serverlet(svc)
            self.rpcs.append(rpc)
        self.addresses = [addr[p] for p in range(N_PARTITIONS)]

    def client(self, kind: str, **kw):
        mod = PKG[kind][0]
        return mod.PegasusClient(mod.StaticResolver(APP_ID, self.addresses),
                                 **kw)

    def close(self):
        for r in self.rpcs:
            r.stop()
        for s in self.servers:
            s.close()


def _plain(x):
    """Answers as plain values: dataclasses to dicts, enums to ints."""
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, bool) or x is None or isinstance(x, (bytes, str)):
        return x
    if isinstance(x, int):
        return int(x)
    return x


def _wait_len(items: list, n: int, timeout: float = 30.0) -> None:
    """Future callbacks run after the waiters wake: wait for them."""
    deadline = time.monotonic() + timeout
    while len(items) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(items) == n


def _err(mod, fn):
    """fn() -> ("ok", answer) or ("error", status) on a PegasusError."""
    try:
        return ("ok", _plain(fn()))
    except mod.PegasusError as e:
        return ("error", int(e.status))


# --------------------------------------------------------------- scenarios


def sc_point_ops(c, m, mod, box, tmp):
    out = []
    c.set(b"user1", b"k1", b"v1")
    c.set(b"user2", b"k1", b"v2", ttl_seconds=1000)
    out += [c.get(b"user1", b"k1"), c.get(b"user2", b"k1"),
            c.get(b"user1", b"missing"), c.exist(b"user1", b"k1"),
            c.exist(b"nope", b"k1"), c.ttl(b"user1", b"k1"),
            990 < c.ttl(b"user2", b"k1") <= 1000, c.ttl(b"gone", b"x")]
    c.delete(b"user1", b"k1")
    out.append(c.get(b"user1", b"k1"))
    return out


def sc_routing(c, m, mod, box, tmp):
    seen = set()
    for i in range(64):
        hk = b"route%d" % i
        c.set(hk, b"s", b"v%d" % i)
        seen.add(key_hash(generate_key(hk, b"s")) % N_PARTITIONS)
    assert seen == set(range(N_PARTITIONS))
    return [c.get(b"route%d" % i, b"s") for i in range(64)]


def sc_multi_ops(c, m, mod, box, tmp):
    c.multi_set(b"mh", {b"a": b"1", b"b": b"2", b"c": b"3"})
    c.multi_set(b"rev", {b"k%02d" % i: b"v%02d" % i for i in range(10)},
                ttl_seconds=3600)
    return [c.multi_get(b"mh"), c.multi_get(b"mh", sort_keys=[b"a", b"c",
                                                              b"zz"]),
            c.sortkey_count(b"mh"), c.multi_del(b"mh", [b"a", b"b"]),
            c.multi_get(b"mh"),
            c.multi_get(b"rev", max_kv_count=3, reverse=True),
            c.multi_get(b"rev", max_kv_count=3),
            c.multi_get(b"rev", start_sortkey=b"k03", stop_sortkey=b"k06",
                        stop_inclusive=True, no_value=True)]


def sc_incr_cas(c, m, mod, box, tmp):
    out = [c.incr(b"cnt", b"x", 5), c.incr(b"cnt", b"x", -2),
           c.get(b"cnt", b"x")]
    c.set(b"cnt", b"bad", b"notanumber")
    out.append(_err(mod, lambda: c.incr(b"cnt", b"bad", 1)))
    ct = m.CasCheckType
    out.append(c.check_and_set(b"cas", b"ck", ct.VALUE_NOT_EXIST, b"",
                               b"ck", b"first"))
    out.append(c.check_and_set(b"cas", b"ck", ct.VALUE_NOT_EXIST, b"",
                               b"ck", b"second"))
    out.append(c.check_and_set(b"cas", b"ck", ct.VALUE_BYTES_EQUAL, b"first",
                               b"other", b"written", return_check_value=True))
    out.append(c.get(b"cas", b"other"))
    c.set(b"cam", b"guard", b"go")
    out.append(c.check_and_mutate(
        b"cam", b"guard", ct.VALUE_BYTES_EQUAL, b"go",
        [("set", b"m1", b"v1", 0), ("del", b"guard")],
        return_check_value=True))
    out += [c.get(b"cam", b"m1"), c.get(b"cam", b"guard")]
    out.append(c.check_and_mutate(b"cam", b"guard", ct.VALUE_EXIST, b"",
                                  [("set", b"m2", b"v2", 0)]))
    return out


def sc_scanners(c, m, mod, box, tmp):
    rows = {b"s%02d" % i: b"val%d" % i for i in range(25)}
    c.multi_set(b"scanhk", rows)
    for i in range(40):
        c.set(b"spread%d" % i, b"s", b"x%d" % i)
    out = [list(c.get_scanner(b"scanhk", batch_size=7)),
           list(c.get_scanner(b"scanhk", b"s05", b"s12", batch_size=3))]
    full = []
    for sc in c.get_unordered_scanners(batch_size=9):
        full.append(list(sc))
    out.append(full)
    out.append([list(sc) for sc in c.get_unordered_scanners(
        batch_size=9, prefetch=False)])
    out.append(list(c.get_scanner(batch_size=11)))
    return out


def sc_scan_session(c, m, mod, box, tmp):
    c.multi_set(b"ctxhk", {b"s%02d" % i: b"v" for i in range(30)})
    start = generate_key(b"ctxhk", b"")
    pidx, h = c._route(start)
    req = m.GetScannerRequest(start_key=start,
                              stop_key=generate_next_bytes(b"ctxhk"),
                              batch_size=5, validate_partition_hash=False)
    r1 = c._call(codes.RPC_GET_SCANNER, pidx, h, req, m.ScanResponse)
    cid = r1.context_id
    r2 = c._call(codes.RPC_SCAN, pidx, h, m.ScanRequest(cid), m.ScanResponse)
    c._call(codes.RPC_CLEAR_SCANNER, pidx, h, m.ScanRequest(cid), None)
    r3 = c._call(codes.RPC_SCAN, pidx, h, m.ScanRequest(cid), m.ScanResponse)
    return [int(r1.error), [kv.key for kv in r1.kvs], cid >= 0,
            r2.context_id == cid, [kv.key for kv in r2.kvs], int(r3.error),
            r3.context_id]


def sc_batch_get_async(c, m, mod, box, tmp):
    for i in range(30):
        c.set(b"bg%d" % (i % 7), b"s%d" % i, b"v%d" % i)
    items = [(b"bg%d" % (i % 7), b"s%d" % i) for i in range(0, 40, 3)]
    out = [c.batch_get(items)]
    got = []
    futs = [c.async_set(b"as", b"k%d" % i, b"a%d" % i) for i in range(5)]
    [f.result(timeout=30) for f in futs]
    futs = [c.async_get(b"as", b"k%d" % i, callback=lambda e, r:
                        got.append((e, r))) for i in range(6)]
    out.append([f.result(timeout=30) for f in futs])
    out += [c.async_incr(b"as", b"n", 3).result(timeout=30),
            c.async_multi_get(b"as").result(timeout=30),
            c.async_sortkey_count(b"as").result(timeout=30),
            c.async_multi_set(b"as2", {b"x": b"1"}).result(timeout=30),
            c.async_multi_del(b"as", [b"k0"]).result(timeout=30),
            c.async_del(b"as", b"k1").result(timeout=30),
            _plain(c.async_check_and_set(
                b"as", b"k2", m.CasCheckType.VALUE_EXIST, b"", b"k9",
                b"z").result(timeout=30)),
            _plain(c.async_check_and_mutate(
                b"as", b"k9", m.CasCheckType.VALUE_EXIST, b"",
                [("del", b"k9")]).result(timeout=30))]
    bad = []
    c.set(b"as", b"nan", b"q")
    c.async_incr(b"as", b"nan", 1, callback=lambda e, r: bad.append(
        (int(e), r))).exception(timeout=30)
    _wait_len(got, 6)
    _wait_len(bad, 1)
    out += [sorted(got, key=repr), bad]
    return out


def sc_misroute(c, m, mod, box, tmp):
    c.set(b"misroute", b"s", b"v")
    key = generate_key(b"misroute", b"s")
    h = key_hash(key)
    wrong = (h % N_PARTITIONS + 1) % N_PARTITIONS
    transport = PKG["port" if mod is port_client else "ref"][2]
    conn = c.pool.get(c.resolver.resolve(wrong))
    codec = port_codec if mod is port_client else ref_codec
    try:
        conn.call(codes.RPC_GET, codec.encode(m.KeyRequest(key)),
                  app_id=APP_ID, partition_index=wrong, partition_hash=h,
                  timeout=5)
        rejected = None
    except transport.RpcError as e:
        rejected = e.err
    try:
        conn.call(codes.RPC_GET, codec.encode(m.KeyRequest(key)),
                  app_id=APP_ID + 1, partition_index=0, timeout=5)
        unknown = None
    except transport.RpcError as e:
        unknown = e.err
    r = c._call(codes.RPC_GET, wrong, h, m.KeyRequest(key), m.ReadResponse)
    return [rejected, unknown, int(r.error), r.value]


def sc_bulk_ingest(c, m, mod, box, tmp):
    """Raw sets written by the OTHER package than the servers', four
    partitions x 3 files, every file holding rows of every partition
    (each server keeps its own), ingested with RPC_BULK_LOAD_INGEST."""
    writer = ref_bulk if box.kind == "port" else port_bulk
    root = tmp / "provider"
    rng = np.random.default_rng(11)
    for pidx in range(N_PARTITIONS):
        pdir = root / "tbl" / str(N_PARTITIONS) / str(pidx)
        pdir.mkdir(parents=True)
        for f in range(3):
            recs = [(b"bl%d" % (i % 53), b"f%03d" % i, b"v%d.%d" % (i, f),
                     0) for i in rng.permutation(200)[:150]]
            writer.write_raw_set(str(pdir / f"{f}.raw"), recs)
    c.set(b"bl1", b"f001", b"before")
    counts = []
    for pidx in range(N_PARTITIONS):
        r = c._call(codes.RPC_BULK_LOAD_INGEST, pidx, 0,
                    m.BulkLoadIngestRequest(str(root), "tbl", N_PARTITIONS),
                    m.BulkLoadIngestResponse)
        counts.append((int(r.error), r.ingested_records, r.partition_index))
    return [counts, [list(c.get_scanner(b"bl%d" % i)) for i in range(53)],
            c.batch_get([(b"bl%d" % (i % 53), b"f%03d" % i)
                         for i in range(0, 200, 9)])]


def sc_throttles(c, m, mod, box, tmp):
    """The read throttle (1 read per second, then reject) answers
    ERR_BUSY, which the client raises as TRY_AGAIN; writes still pass."""
    c.set(b"thr", b"s", b"v")
    for s in box.servers:
        s.update_app_envs({"replica.read_throttling": "1*reject*0"})
    got = [_err(mod, lambda: c.get(b"thr", b"s")) for _ in range(6)]
    c.set(b"thr", b"s2", b"w")
    for s in box.servers:
        s.update_app_envs({"replica.read_throttling": ""})
    busy = sum(g == ("error", int(m.Status.TRY_AGAIN)) for g in got)
    return [busy >= 4, set(g[0] for g in got), c.get(b"thr", b"s2")]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_point_ops, sc_routing, sc_multi_ops, sc_incr_cas, sc_scanners,
    sc_scan_session, sc_batch_get_async, sc_misroute, sc_bulk_ingest,
    sc_throttles)}
MIXES = [("port", "port"), ("port", "ref"), ("ref", "port"), ("ref", "ref")]


def _run(tmp_path, tag, client_kind, server_kind, scenario):
    root = tmp_path / tag
    root.mkdir()
    box = Onebox(root, server_kind, device="cpu")
    c = box.client(client_kind)
    try:
        return _plain(SCENARIOS[scenario](c, PKG[client_kind][1],
                                          PKG[client_kind][0], box, root))
    finally:
        c.close()
        box.close()


@pytest.fixture(scope="module", autouse=True)
def _stop_watchdogs():
    yield
    device_watchdog.watchdog_for("cpu").stop()


_BASELINE = {}   # scenario -> answers of the reference client and servers


def _baseline(tmp_path_factory, scenario):
    if scenario not in _BASELINE:
        _BASELINE[scenario] = _run(tmp_path_factory.mktemp("base"), "base",
                                   "ref", "ref", scenario)
    return _BASELINE[scenario]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("client_kind,server_kind", MIXES,
                         ids=[f"{c}_client-{s}_servers" for c, s in MIXES])
def test_onebox_answers_equal_in_every_mix(tmp_path, tmp_path_factory,
                                           client_kind, server_kind,
                                           scenario):
    want = _baseline(tmp_path_factory, scenario)
    got = _run(tmp_path, "mix", client_kind, server_kind, scenario)
    assert got == want


# ------------------------------------------------------------------- codec

MESSAGES = [(getattr(port_msg, n), getattr(ref_msg, n)) for n in (
    "KeyRequest", "UpdateRequest", "UpdateResponse", "ReadResponse",
    "TTLResponse", "CountResponse", "KeyValue", "MultiPutRequest",
    "MultiRemoveRequest", "MultiRemoveResponse", "MultiGetRequest",
    "MultiGetResponse", "IncrRequest", "IncrResponse", "CheckAndSetRequest",
    "CheckAndSetResponse", "Mutate", "CheckAndMutateRequest",
    "CheckAndMutateResponse", "GetScannerRequest", "ScanRequest",
    "ScanResponse", "BulkLoadIngestRequest", "BulkLoadIngestResponse",
    "DuplicateRequest", "DuplicateResponse", "TriggerAuditRequest",
    "TriggerAuditResponse")]


def test_every_data_message_is_ported():
    ported = {p.__name__ for p, _ in MESSAGES}
    for name in ("KeyRequest", "ScanResponse", "BulkLoadIngestRequest"):
        assert name in ported
    for enum_name in ("Status", "FilterType", "CasCheckType",
                      "MutateOperation"):
        assert {e.name: int(e) for e in getattr(port_msg, enum_name)} == \
            {e.name: int(e) for e in getattr(ref_msg, enum_name)}


def _optional_value(t, rng, cls_of):
    """The offload byte tests' value maker, plus Optional[int]
    (KeyValue's expire_ts_seconds)."""
    if typing.get_origin(t) is typing.Union:
        (inner,) = [a for a in typing.get_args(t) if a is not type(None)]
        return None if rng.integers(0, 2) else _value(inner, rng, cls_of)
    return _value(t, rng, cls_of)


def _seeded(port_cls, rng, cls_of):
    hints = typing.get_type_hints(port_cls)
    kw = {}
    for f in dataclasses.fields(port_cls):
        t = hints[f.name]
        if typing.get_origin(t) in (list, typing.List) and \
                dataclasses.is_dataclass(typing.get_args(t)[0]):
            kw[f.name] = [_seeded(typing.get_args(t)[0], rng, cls_of)
                          for _ in range(int(rng.integers(0, 4)))]
        else:
            kw[f.name] = _optional_value(t, rng, cls_of)
    return cls_of(port_cls)(**kw)


@pytest.mark.parametrize("port_cls,ref_cls", MESSAGES,
                         ids=[p.__name__ for p, _ in MESSAGES])
def test_message_same_bytes_both_packages(port_cls, ref_cls):
    """Field names, order, types and defaults equal; seeded instances
    (nested lists of messages and Optional fields included) encode to the
    same bytes in both packages, and each decodes the other's."""
    pf, rf = dataclasses.fields(port_cls), dataclasses.fields(ref_cls)
    assert [f.name for f in pf] == [f.name for f in rf]
    assert [str(typing.get_type_hints(port_cls)[f.name]) for f in pf] == \
        [str(typing.get_type_hints(ref_cls)[f.name]).replace(
            "pegasus_tpu.", "pegasus_tpu_torch.") for f in rf]
    assert [f.default for f in pf] == [f.default for f in rf]
    required = [f.name for f in pf
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING]
    if not required:
        assert port_codec.encode(port_cls()) == ref_codec.encode(ref_cls())
    pairs = dict(MESSAGES)
    for seed in range(12):
        port_obj = _seeded(port_cls, np.random.default_rng(seed),
                           lambda c: c)
        ref_obj = _seeded(port_cls, np.random.default_rng(seed),
                          lambda c: pairs[c])
        wire = port_codec.encode(port_obj)
        assert wire == ref_codec.encode(ref_obj)
        assert dataclasses.asdict(ref_codec.decode(ref_cls, wire)) == \
            dataclasses.asdict(port_obj)
        assert dataclasses.asdict(port_codec.decode(port_cls, wire)) == \
            dataclasses.asdict(ref_obj)


def test_sharded_connection_sets_the_header_flag():
    """A client connection keyed by partition marks its frames sharded,
    as the reference client's do; a reference server decodes them."""
    seen = []
    srv = ref_transport.RpcServer()
    srv.register("PEEK", lambda h, b: (seen.append(
        (h.sharded, h.app_id, h.partition_index, h.partition_hash)), b)[1])
    srv.start()
    pool = port_transport.ConnectionPool()
    try:
        pool.get(srv.address, shard=3).call("PEEK", b"x", app_id=7,
                                            partition_index=3,
                                            partition_hash=11, timeout=10)
        pool.get(srv.address).call_many(
            [("PEEK", b"y", 7, 1, 5), ("PEEK", b"z")], timeout=10)
        pool.invalidate(srv.address)
        assert pool.get(srv.address, shard=3).call(
            "PEEK", b"w", timeout=10)[1] == b"w"
    finally:
        pool.close()
        srv.stop()
    assert seen == [(True, 7, 3, 11), (False, 7, 1, 5), (False, 0, 0, 0),
                    (True, 0, 0, 0)]


def test_device_failure_reaches_the_rpc_caller(tmp_path, monkeypatch):
    """A failure in the device path is not papered over: an ingest whose
    merge fails answers ERR_INVALID_DATA with the error's repr, which the
    client raises."""
    box = Onebox(tmp_path, "port", device="cpu")
    c = box.client("port")
    try:
        root = tmp_path / "provider"
        pdir = root / "tbl" / str(N_PARTITIONS) / "0"
        pdir.mkdir(parents=True)
        port_bulk.write_raw_set(str(pdir / "a.raw"),
                                [(b"k", b"s", b"v", 0)])

        def boom(*a, **k):
            raise RuntimeError("merge_path partition kernel launch failed: "
                               "cudaError 2")
        import pegasus_tpu_torch.ops.compact as port_compact

        monkeypatch.setattr(port_compact, "compact_blocks", boom)
        with pytest.raises(port_client.PegasusError) as ei:
            c._call(codes.RPC_BULK_LOAD_INGEST, 0, 0,
                    port_msg.BulkLoadIngestRequest(str(root), "tbl",
                                                   N_PARTITIONS),
                    port_msg.BulkLoadIngestResponse)
        assert "cudaError 2" in str(ei.value)
    finally:
        c.close()
        box.close()


def test_corrupt_sst_answers_invalid_data(tmp_path):
    """A read that hits an SST whose section checksum no longer matches
    is refused as ERR_INVALID_DATA naming the corruption, never served
    garbage."""
    box = Onebox(tmp_path, "port", device="cpu")
    c = box.client("port")
    try:
        for i in range(50):
            c.set(b"corrupt%d" % i, b"s", b"v%d" % i)
        for s in box.servers:
            s.engine.flush()
    finally:
        c.close()
        box.close()
    for f in tmp_path.glob("port_p*/*.sst"):
        raw = bytearray(f.read_bytes())
        raw[-3] ^= 0xFF   # inside the last data section
        f.write_bytes(bytes(raw))
    box = Onebox(tmp_path, "port", device="cpu")
    c = box.client("port")
    try:
        with pytest.raises(port_client.PegasusError) as ei:
            for i in range(50):
                c.get(b"corrupt%d" % i, b"s")
        assert int(ei.value.status) == int(port_msg.Status.IO_ERROR)
        assert "on-disk corruption" in str(ei.value)
    finally:
        c.close()
        box.close()


@pytest.mark.cuda
def test_onebox_on_the_card(tmp_path):
    """The port's servers on the card (no device argument) against the
    reference's, through both clients: the point-op, scanner and ingest
    scenarios answer alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: python -m pytest "
                    "-m cuda tests/test_torch_*.py)")
    for scenario in ("point_ops", "scanners", "bulk_ingest"):
        want = _run(tmp_path, f"base_{scenario}", "ref", "ref", scenario)
        root = tmp_path / f"card_{scenario}"
        root.mkdir()
        box = Onebox(root, "port")
        c = box.client("port")
        try:
            got = _plain(SCENARIOS[scenario](c, port_msg, port_client, box,
                                             root))
        finally:
            c.close()
            box.close()
        assert got == want
