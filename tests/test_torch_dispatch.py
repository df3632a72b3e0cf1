"""The port's batch dispatch against the JAX package's, over real sockets.

A pipelined wave of point gets, multi_gets and scans is binned per task
code by the frame reader (_FrameReader.wave_batched) and a bin of one
hot code runs as ONE batch-handler call (ReplicaService.
rpc_batch_handlers -> PegasusServer.on_get_batch for the gets). Pinned:

  * the binning is equal between the packages;
  * every response frame of the wave is byte-equal between the port's
    batch path, the port's per-frame path (the `serve.native` fail point
    or a traced frame forces it, as in the JAX package), and the JAX
    package's server for the same frames, including under an armed
    `serve.dispatch` (ERR_BUSY for every frame);
  * the batch path ticks the per-frame counters once per frame;
  * on_get_batch answers byte-equal to on_get and to the reference's
    on_get_batch, and a wave of gets reaches the device lookup.

The port's servers run the cuda backend on device="cpu"; the reference's
the cpu backend.
"""

import socket
import struct
import threading

import pytest

from pegasus_tpu.client import PegasusClient as RefClient
from pegasus_tpu.client import StaticResolver as RefResolver
from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine.replica_service import ReplicaService as RefService
from pegasus_tpu.engine.server_impl import PegasusServer as RefServer
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu.rpc import transport as ref_transport
from pegasus_tpu.runtime import fail_points as ref_fp
from pegasus_tpu_torch.base import key_schema
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.engine.replica_service import ReplicaService
from pegasus_tpu_torch.engine.server_impl import PegasusServer
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc import messages as msg
from pegasus_tpu_torch.rpc import transport
from pegasus_tpu_torch.rpc.task_codes import (RPC_GET, RPC_GET_SCANNER,
                                              RPC_MULTI_GET, RPC_SCAN)
from pegasus_tpu_torch.rpc.transport import RpcHeader, RpcServer
from pegasus_tpu_torch.runtime import fail_points
from pegasus_tpu_torch.runtime.perf_counters import counters
from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

APP_ID = 9
N_PARTITIONS = 2
NOW = 1000


def _frame(seq, code, body, pidx=0, trace_id=0):
    h = codec.encode(RpcHeader(seq=seq, code=code, app_id=APP_ID,
                               partition_index=pidx, trace_id=trace_id))
    return struct.pack("<II", 4 + len(h) + len(body), len(h)) + h + body


# ------------------------------------------------------------- binning


def test_wave_batched_binning_matches_reference():
    """Hot codes coalesce at their first arrival, others stay singleton,
    arrival order kept: the same entries from both packages' readers."""
    blob = b"".join([
        _frame(1, RPC_GET, b"a"), _frame(2, "RPC_RRDB_RRDB_PUT", b"w"),
        _frame(3, RPC_GET, b"b"), _frame(4, RPC_SCAN, b"s"),
        _frame(5, RPC_GET, b"c"), _frame(6, RPC_SCAN, b"t"),
        _frame(7, "RPC_RRDB_RRDB_PUT", b"x")])
    hot = (RPC_GET, RPC_SCAN)
    waves = []
    for reader_cls in (transport._FrameReader, ref_transport._FrameReader):
        a, b = socket.socketpair()
        try:
            a.sendall(blob)
            waves.append([(code, [(h.seq, body) for h, body in fs])
                          for code, fs in reader_cls(b, hot=hot)
                          .wave_batched()])
        finally:
            a.close()
            b.close()
    assert waves[0] == waves[1] == [
        (RPC_GET, [(1, b"a"), (3, b"b"), (5, b"c")]),
        ("RPC_RRDB_RRDB_PUT", [(2, b"w")]),
        (RPC_SCAN, [(4, b"s"), (6, b"t")]),
        ("RPC_RRDB_RRDB_PUT", [(7, b"x")]),
    ]


# ------------------------------------------------------- byte identity


class _Node:
    """One RpcServer of one package serving N_PARTITIONS partitions,
    loaded with fixed data through that package's client."""

    def __init__(self, root, kind: str):
        self.kind = kind
        if kind == "port":
            svc, self.rpc = ReplicaService(), RpcServer()
            mk = lambda p: PegasusServer(  # noqa: E731
                str(root / f"p{p}"), app_id=APP_ID, pidx=p, server="node0",
                options=EngineOptions(device="cpu"))
        else:
            svc, self.rpc = RefService(), ref_transport.RpcServer()
            # the port's accept-loop poll, so stop() takes 50 ms
            self.rpc._thread = threading.Thread(
                target=self.rpc._srv.serve_forever,
                kwargs={"poll_interval": 0.05}, daemon=True)
            mk = lambda p: RefServer(  # noqa: E731
                str(root / f"p{p}"), app_id=APP_ID, pidx=p, server="node0",
                options=RefOptions(backend="cpu"))
        self.rpc.start()
        self.servers = [mk(p) for p in range(N_PARTITIONS)]
        for s in self.servers:
            svc.add_replica(s, N_PARTITIONS)
        self.rpc.register_serverlet(svc)
        client = RefClient(RefResolver(APP_ID, [self.rpc.address]
                                       * N_PARTITIONS))
        try:
            for i in range(8):
                client.set(b"hk%d" % i, b"sk", b"val-%d" % i)
            client.multi_set(b"multi", {b"a": b"1", b"b": b"2", b"c": b"3"})
        finally:
            client.close()

    def wave(self, frames) -> dict:
        """Send `frames` as one pipelined write; -> {seq: raw response}."""
        s = socket.create_connection(self.rpc.address)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(b"".join(frames))
            got, buf = {}, bytearray()
            while len(got) < len(frames):
                chunk = s.recv(1 << 16)
                assert chunk, "server closed mid-response"
                buf += chunk
                while len(buf) >= 8:
                    plen, hlen = struct.unpack_from("<II", buf, 0)
                    if len(buf) < 4 + plen:
                        break
                    frame = bytes(buf[: 4 + plen])
                    header = codec.decode(RpcHeader, frame[8: 8 + hlen])
                    got[header.seq] = frame
                    del buf[: 4 + plen]
            return got
        finally:
            s.close()

    def close(self):
        self.rpc.stop()
        for s in self.servers:
            s.close()


def _identity_wave(trace_id=0):
    """Point gets (hits, a miss, an unserved partition), multi_gets, an
    exhausting scanner open per partition and a bogus-context scan."""
    frames, seq = [], 0

    def add(code, body, pidx=0):
        nonlocal seq
        seq += 1
        frames.append(_frame(seq, code, body, pidx=pidx, trace_id=trace_id))

    for i in range(8):
        key = key_schema.generate_key(b"hk%d" % i, b"sk")
        add(RPC_GET, codec.encode(msg.KeyRequest(key=key)),
            pidx=key_schema.key_hash(key) % N_PARTITIONS)
    miss = key_schema.generate_key(b"nope", b"sk")
    add(RPC_GET, codec.encode(msg.KeyRequest(key=miss)),
        pidx=key_schema.key_hash(miss) % N_PARTITIONS)
    add(RPC_GET, codec.encode(msg.KeyRequest(key=b"x")), pidx=7)
    mkey = key_schema.generate_key(b"multi", b"")
    mpidx = key_schema.key_hash(mkey) % N_PARTITIONS
    add(RPC_MULTI_GET, codec.encode(msg.MultiGetRequest(hash_key=b"multi")),
        pidx=mpidx)
    add(RPC_MULTI_GET, codec.encode(msg.MultiGetRequest(
        hash_key=b"multi", sort_keys=[b"a", b"zz"])), pidx=mpidx)
    for pidx in range(N_PARTITIONS):
        add(RPC_GET_SCANNER, codec.encode(msg.GetScannerRequest(
            batch_size=10_000, validate_partition_hash=False)), pidx=pidx)
    add(RPC_SCAN, codec.encode(msg.ScanRequest(context_id=12345)), pidx=0)
    add(RPC_SCAN, codec.encode(msg.ScanRequest(context_id=54321)), pidx=1)
    return frames


@pytest.fixture(scope="module")
def ref_frames(tmp_path_factory):
    """The reference server's answers to the identity wave, once per
    mode that changes them (untraced; serve.dispatch armed)."""
    out = {}
    node = _Node(tmp_path_factory.mktemp("ref"), "ref")
    try:
        out["plain"] = node.wave(_identity_wave())
        ref_fp.setup()
        try:
            ref_fp.cfg("serve.dispatch", "raise(chaos)")
            out["busy"] = node.wave(_identity_wave())
        finally:
            ref_fp.teardown()
    finally:
        node.close()
    return out


@pytest.mark.parametrize("mode", ["batch", "native_fallback", "traced",
                                  "dispatch_busy"])
def test_wave_responses_byte_equal_to_reference(tmp_path, ref_frames, mode):
    """Every response frame of the wave is byte-equal to the reference
    server's, whichever way the port dispatched it."""
    node = _Node(tmp_path, "port")
    calls = []
    real = node.rpc._batch_handlers[RPC_GET]
    node.rpc._batch_handlers[RPC_GET] = \
        lambda hs, bs: calls.append(len(hs)) or real(hs, bs)
    fail_points.setup()
    try:
        if mode == "native_fallback":
            fail_points.cfg("serve.native", "return()")
        if mode == "dispatch_busy":
            fail_points.cfg("serve.dispatch", "raise(chaos)")
        got = node.wave(_identity_wave(trace_id=7 if mode == "traced"
                                       else 0))
    finally:
        fail_points.teardown()
        node.close()
    want = ref_frames["busy" if mode == "dispatch_busy" else "plain"]
    assert set(got) == set(want) == set(range(1, len(want) + 1))
    for seq in want:
        assert got[seq] == want[seq], f"seq {seq} diverged ({mode})"
    # the batch handler ran exactly where the port batches
    if mode == "batch":
        assert calls and sum(calls) >= 10
    else:
        assert calls == []


@pytest.mark.parametrize("path", ["batch", "per_frame"])
def test_dispatch_counter_cardinality(tmp_path, path):
    """One rpc.server.qps tick and one latency sample per frame, and one
    get_qps tick per get, on the batch path as on the per-frame path."""
    node = _Node(tmp_path, "port")
    lat = counters.percentile("rpc.server.latency_us")
    names = ["rpc.server.qps", "rpc.server.error_count"] + [
        f"app.{APP_ID}.{p}.get_qps" for p in range(N_PARTITIONS)]
    keys = [key_schema.generate_key(b"hk%d" % i, b"sk") for i in range(8)]
    frames = [_frame(i + 1, RPC_GET, codec.encode(msg.KeyRequest(key=k)),
                     pidx=key_schema.key_hash(k) % N_PARTITIONS)
              for i, k in enumerate(keys)]
    frames.append(_frame(9, RPC_GET, codec.encode(msg.KeyRequest(key=b"x")),
                         pidx=7))
    fail_points.setup()
    try:
        if path == "per_frame":
            fail_points.cfg("serve.native", "return()")
        with lat._lock:
            lat._samples.clear()
            lat._idx = 0
        before = {n: counters.rate(n).total() for n in names}
        node.wave(frames)
        after = {n: counters.rate(n).total() for n in names}
        n_lat = len(lat._samples)
    finally:
        fail_points.teardown()
        node.close()
    d = {n: after[n] - before[n] for n in names}
    assert d["rpc.server.qps"] == 9
    assert d["rpc.server.error_count"] == 1   # the unserved partition
    assert n_lat == 9
    per_part = [sum(1 for k in keys if key_schema.key_hash(k)
                    % N_PARTITIONS == p) for p in range(N_PARTITIONS)]
    assert [d[f"app.{APP_ID}.{p}.get_qps"]
            for p in range(N_PARTITIONS)] == per_part


# ------------------------------------------------------- on_get_batch


def test_on_get_batch_equal_to_on_get_and_reference(tmp_path):
    """PegasusServer.on_get_batch answers byte-equal to on_get per key
    and to the reference's on_get_batch; a batch over a flushed (so
    resident) run goes through the device lookup."""
    port = PegasusServer(str(tmp_path / "port"), app_id=1, pidx=0,
                         options=EngineOptions(device="cpu"))
    ref = RefServer(str(tmp_path / "ref"), app_id=1, pidx=0,
                    options=RefOptions(backend="cpu"))
    try:
        for srv, m in ((port, msg), (ref, ref_msg)):
            reqs = [(  # decree-pinned puts, the same bytes in both
                "RPC_RRDB_RRDB_PUT",
                m.UpdateRequest(key_schema.generate_key(b"h%d" % (i % 5),
                                                        b"s%03d" % i),
                                b"v%d" % i, 0)) for i in range(200)]
            srv.on_batched_write_requests(1, 1000, reqs)
            srv.engine.flush()
        # a flush primes its run asynchronously: under load the batch
        # could otherwise arrive before the run is resident
        port.engine.wait_primes()
        keys = [key_schema.generate_key(b"h%d" % (i % 5), b"s%03d" % i)
                for i in range(0, 240, 3)]
        with COMPACT_TRACER.session() as sess:
            got = port.on_get_batch(keys, now=NOW)
        assert sess.summary().get("read.lookup", {}).get("calls", 0) >= 1
        want = ref.on_get_batch(keys, now=NOW)
        single = [port.on_get(k, now=NOW) for k in keys]
        assert [codec.encode(r) for r in got] == \
            [ref_codec.encode(r) for r in want] == \
            [codec.encode(r) for r in single]
        assert port.on_get_batch([], now=NOW) == []
    finally:
        port.close()
        ref.close()


def test_get_batch_errors_match_the_per_frame_handler(tmp_path):
    """Every failure of a batched get is the error _on_get raises for the
    same frame: an unserved partition, a bad partition hash, a garbled
    body, and on-disk corruption (ERR_INVALID_DATA naming the replica)."""
    from pegasus_tpu_torch.engine.sstable import CorruptionError
    from pegasus_tpu_torch.rpc.transport import RpcError

    svc = ReplicaService()
    srv = PegasusServer(str(tmp_path / "p0"), app_id=APP_ID, pidx=0,
                        options=EngineOptions(device="cpu"))
    svc.add_replica(srv, 1)
    ok = codec.encode(msg.KeyRequest(key=key_schema.generate_key(b"h",
                                                                 b"s")))
    frames = [(RpcHeader(seq=1, code=RPC_GET, app_id=APP_ID), ok),
              (RpcHeader(seq=2, code=RPC_GET, app_id=APP_ID,
                         partition_index=3), ok),
              (RpcHeader(seq=3, code=RPC_GET, app_id=APP_ID), b"\xff")]

    def outcome(fn):
        try:
            return ("ok", fn())
        except RpcError as e:
            return ("rpc", e.err, e.text)
        except Exception as e:  # noqa: BLE001
            return ("exc", type(e).__name__)

    def compare():
        batch = svc._on_get_batch([h for h, _ in frames],
                                  [b for _, b in frames])
        for (h, b), res in zip(frames, batch):
            single = outcome(lambda: svc._on_get(h, b))
            got = (("rpc", res.err, res.text) if isinstance(res, RpcError)
                   else ("exc", type(res).__name__)
                   if isinstance(res, Exception) else ("ok", res))
            assert got[0] == single[0] and got[1:2] == single[1:2], \
                (h.seq, got, single)
            if got[0] == "rpc":
                assert got == single

    try:
        compare()

        def rot(*a, **kw):
            raise CorruptionError("x.sst", "section keys crc32 mismatch")

        srv.engine.get_batch = rot
        srv.engine.get = rot
        compare()
    finally:
        srv.close()
