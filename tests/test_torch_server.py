"""The port's PegasusServer and manual-compact service against the JAX
package's, in-process.

The cases of tests/test_server_impl.py and tests/test_manual_compact.py,
driven through a pegasus_tpu PegasusServer(options=EngineOptions(backend=
"cpu")) and a port PegasusServer(options=EngineOptions(device="cpu"))
(the cuda backend: its
read coalescers, device lookups and merge pipeline, with the plain
versions of the kernels) side by side. The same requests, decree,
timestamp_us and `now` go to both; every response must encode
(codec.encode) to the same bytes, and the engines' state_digest must be
equal after each case. Then the port's own guarantees: a failed merge is
recorded by the manual-compact service and persists no finish time,
reads racing a manual compaction answer right, the watchdog probes its
device, and (on a card, `cuda` marker) the same path through the kernels.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pegasus_tpu.base import consts as ref_consts
from pegasus_tpu.base.key_schema import (generate_key, generate_next_bytes,
                                         restore_key)
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine import bulk_load as ref_bulk
from pegasus_tpu.engine import manual_compact_service as ref_mcs
from pegasus_tpu.engine.server_impl import PegasusServer as RefServer
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu.rpc import task_codes as ref_codes
from pegasus_tpu.runtime.perf_counters import counters as ref_counters
from pegasus_tpu_torch.base import consts
from pegasus_tpu_torch.engine import bulk_load as port_bulk
from pegasus_tpu_torch.engine import manual_compact_service as port_mcs
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.engine.server_impl import PegasusServer
from pegasus_tpu_torch.ops import device_watchdog
from pegasus_tpu_torch.rpc import codec as port_codec
from pegasus_tpu_torch.rpc import messages as port_msg
from pegasus_tpu_torch.rpc import task_codes as codes
from pegasus_tpu_torch.runtime.perf_counters import counters as port_counters
from tests.test_server_impl import CAS_CASES

NOW = 1000
TS_US = 1000


class Pair:
    """A reference server and a port server over their own directories,
    driven with the same inputs."""

    def __init__(self, root, app_id=1, pidx=0, opts=None, **kw):
        opts = dict(opts or {})
        self.ref = RefServer(str(root / "ref"), app_id=app_id, pidx=pidx,
                             options=RefOptions(backend="cpu", **opts), **kw)
        self.port = PegasusServer(str(root / "port"), app_id=app_id,
                                  pidx=pidx,
                                  options=EngineOptions(device="cpu", **opts),
                                  **kw)
        # scan-context ids carry random high bits: pin them alike
        self.ref._contexts._high_bits = self.port._contexts._high_bits = \
            7 << 32

    def both(self, fn):
        """fn(server, messages module) -> response (or list of them) on
        each server; the encodings must be byte-equal."""
        r, p = fn(self.ref, ref_msg), fn(self.port, port_msg)
        rl, pl = (r, p) if isinstance(r, list) else ([r], [p])
        assert len(rl) == len(pl)
        for a, b in zip(rl, pl):
            assert port_codec.encode(b) == ref_codec.encode(a), (a, b)
        return r, p

    def write(self, code, mk, now=None, ts=TS_US):
        def f(s, m):
            d = s.engine.last_committed_decree() + 1
            return s.on_batched_write_requests(d, ts, [(code, mk(m))],
                                               now=now)[0]
        return self.both(f)[1]

    def put(self, hk, sk, value, expire=0):
        key = generate_key(hk, sk)
        return self.write(codes.RPC_PUT,
                          lambda m: m.UpdateRequest(key, value, expire))

    def get(self, hk, sk, now=None):
        r = self.both(lambda s, m: s.on_get(generate_key(hk, sk),
                                            now=now))[1]
        return None if r.error == port_msg.Status.NOT_FOUND else r.value

    def read(self, method, mk, **kw):
        return self.both(lambda s, m: getattr(s, method)(mk(m), **kw))[1]

    def flush(self):
        self.ref.engine.flush()
        self.port.engine.flush()

    def envs(self, envs):
        self.ref.update_app_envs(envs)
        self.port.update_app_envs(envs)

    def assert_same_state(self, now=NOW):
        assert self.port.engine.state_digest(now=now) == \
            self.ref.engine.state_digest(now=now)
        assert self.port.engine.last_committed_decree() == \
            self.ref.engine.last_committed_decree()

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.assert_same_state()
    p.close()


@pytest.fixture(scope="module", autouse=True)
def _stop_watchdogs():
    yield
    device_watchdog.watchdog_for("cpu").stop()


# ------------------------------------------------------------------ writes


def test_batched_puts_and_removes_one_decree(pair):
    reqs = [
        (codes.RPC_PUT, lambda m: m.UpdateRequest(generate_key(b"h", b"a"),
                                                  b"1", 0)),
        (codes.RPC_PUT, lambda m: m.UpdateRequest(generate_key(b"h", b"b"),
                                                  b"2", 0)),
        (codes.RPC_REMOVE, lambda m: m.KeyRequest(generate_key(b"h", b"a"))),
    ]
    _, resps = pair.both(lambda s, m: s.on_batched_write_requests(
        1, TS_US, [(c, mk(m)) for c, mk in reqs]))
    assert len(resps) == 3 and all(r.error == 0 for r in resps)
    assert pair.port.engine.last_committed_decree() == 1
    assert pair.get(b"h", b"a") is None
    assert pair.get(b"h", b"b") == b"2"


def test_empty_batch_advances_decree(pair):
    pair.both(lambda s, m: s.on_batched_write_requests(1, 0, []))
    assert pair.port.engine.last_committed_decree() == 1


def test_batched_write_window(pair):
    """A committed decree window: batchable stretches collapse into one
    engine call, the rest dispatch per decree."""
    def window(m):
        k = [generate_key(b"w", b"%d" % i) for i in range(4)]
        return [(1, 10, [(codes.RPC_PUT, m.UpdateRequest(k[0], b"a", 0))]),
                (2, 11, [(codes.RPC_PUT, m.UpdateRequest(k[1], b"b", 0)),
                         (codes.RPC_REMOVE, m.KeyRequest(k[0]))]),
                (3, 12, [(codes.RPC_INCR, m.IncrRequest(k[2], 5, 0))]),
                (4, 13, [(codes.RPC_PUT, m.UpdateRequest(k[3], b"d", 0))])]

    def f(s, m):
        out = s.on_batched_write_window(window(m), now=NOW)
        return [r for d in sorted(out) for r in out[d]]
    pair.both(f)
    assert pair.get(b"w", b"2") == b"5"


def test_incr_semantics(pair):
    key = generate_key(b"i", b"k")
    for by in (10, -4, 0):
        r = pair.write(codes.RPC_INCR, lambda m: m.IncrRequest(key, by, 0))
    assert (r.error, r.new_value) == (0, 6)
    pair.put(b"i", b"bad", b"xyz")
    r = pair.write(codes.RPC_INCR, lambda m: m.IncrRequest(
        generate_key(b"i", b"bad"), 1))
    assert r.error == port_msg.Status.INVALID_ARGUMENT
    pair.put(b"i", b"max", str(2**63 - 1).encode())
    r = pair.write(codes.RPC_INCR, lambda m: m.IncrRequest(
        generate_key(b"i", b"max"), 1))
    assert r.error == port_msg.Status.INVALID_ARGUMENT


def test_incr_ttl_interaction(pair):
    key = generate_key(b"i", b"ttl")
    for expire, want in ((NOW + 50, 50), (0, 50), (-1, -1)):
        pair.write(codes.RPC_INCR, lambda m: m.IncrRequest(key, 1, expire),
                   now=NOW)
        assert pair.read("on_ttl", lambda m: key, now=NOW).ttl_seconds == want


@pytest.mark.parametrize("ct,existing,operand,expect", CAS_CASES)
def test_check_and_set_matrix(pair, ct, existing, operand, expect):
    hk = b"cas%d" % int(ct)
    if existing is not None:
        pair.put(hk, b"ck", existing)
    r = pair.write(codes.RPC_CHECK_AND_SET, lambda m: m.CheckAndSetRequest(
        hash_key=hk, check_sort_key=b"ck", check_type=ct,
        check_operand=operand, set_diff_sort_key=True, set_sort_key=b"out",
        set_value=b"WROTE", return_check_value=True))
    assert r.error == (0 if expect else port_msg.Status.TRY_AGAIN)
    assert pair.get(hk, b"out") == (b"WROTE" if expect else None)


def test_check_and_set_int_invalid_and_same_sortkey(pair):
    pair.put(b"casx", b"ck", b"notint")
    r = pair.write(codes.RPC_CHECK_AND_SET, lambda m: m.CheckAndSetRequest(
        hash_key=b"casx", check_sort_key=b"ck",
        check_type=m.CasCheckType.VALUE_INT_EQUAL, check_operand=b"5",
        set_diff_sort_key=True, set_sort_key=b"out", set_value=b"x"))
    assert r.error == port_msg.Status.INVALID_ARGUMENT
    pair.put(b"cassame", b"k", b"old")
    r = pair.write(codes.RPC_CHECK_AND_SET, lambda m: m.CheckAndSetRequest(
        hash_key=b"cassame", check_sort_key=b"k",
        check_type=m.CasCheckType.VALUE_BYTES_EQUAL, check_operand=b"old",
        set_diff_sort_key=False, set_sort_key=b"k", set_value=b"new",
        return_check_value=True))
    assert r.error == 0 and r.check_value == b"old"
    assert pair.get(b"cassame", b"k") == b"new"


@pytest.mark.parametrize("case", ["multi_ops", "failed_check", "empty"])
def test_check_and_mutate(pair, case):
    pair.put(b"cam", b"g", b"42")

    def req(m):
        ml = [] if case == "empty" else [
            m.Mutate(m.MutateOperation.PUT, b"a", b"1", 0),
            m.Mutate(m.MutateOperation.PUT, b"b", b"2", NOW + 9),
            m.Mutate(m.MutateOperation.DELETE, b"g")]
        return m.CheckAndMutateRequest(
            hash_key=b"cam", check_sort_key=b"g",
            check_type=m.CasCheckType.VALUE_INT_GREATER_OR_EQUAL,
            check_operand=b"50" if case == "failed_check" else b"40",
            mutate_list=ml, return_check_value=True)
    r = pair.write(codes.RPC_CHECK_AND_MUTATE, req)
    want = {"multi_ops": 0, "failed_check": port_msg.Status.TRY_AGAIN,
            "empty": port_msg.Status.INVALID_ARGUMENT}[case]
    assert r.error == want
    assert pair.get(b"cam", b"a") == (b"1" if case == "multi_ops" else None)


def test_multi_put_multi_remove(pair):
    pair.write(codes.RPC_MULTI_PUT, lambda m: m.MultiPutRequest(
        b"mp", [m.KeyValue(b"s%d" % i, b"v%d" % i) for i in range(5)],
        NOW + 100))
    r = pair.write(codes.RPC_MULTI_REMOVE, lambda m: m.MultiRemoveRequest(
        b"mp", [b"s1", b"s3", b"zz"]))
    assert r.count == 3
    pair.write(codes.RPC_MULTI_PUT, lambda m: m.MultiPutRequest(b"mp", []))
    pair.write(codes.RPC_MULTI_REMOVE, lambda m: m.MultiRemoveRequest(b"mp"))
    r = pair.read("on_multi_get", lambda m: m.MultiGetRequest(b"mp"),
                  now=NOW)
    assert [kv.key for kv in r.kvs] == [b"s0", b"s2", b"s4"]


def test_duplicate_apply_and_stale_drop(pair):
    """The local apply of a duplicated mutation: written with the origin
    timestamp and cluster; a stale one (older timetag) is dropped; a
    non-duplicable code is refused."""
    key = generate_key(b"dup", b"k")

    def dup(ts, cluster, value, code=codes.RPC_PUT, verify=True):
        def mk(m):
            inner = (m.UpdateRequest(key, value, 0) if code == codes.RPC_PUT
                     else m.KeyRequest(key))
            codec = port_codec if m is port_msg else ref_codec
            return m.DuplicateRequest(ts, code, codec.encode(inner), cluster,
                                      verify)
        return pair.write(codes.RPC_DUPLICATE, mk, now=NOW)
    dup(5000, 2, b"first")
    r = dup(4000, 1, b"stale")
    assert r.error_hint == "ignored stale duplicate"
    assert pair.get(b"dup", b"k", now=NOW) == b"first"
    dup(6000, 3, b"", code=codes.RPC_REMOVE)
    r = dup(7000, 1, b"x", code=codes.RPC_GET)
    assert r.error == port_msg.Status.INVALID_ARGUMENT


def test_trigger_audit_digest(pair):
    for i in range(30):
        pair.put(b"aud%d" % (i % 4), b"s%d" % i, b"v%d" % i,
                 expire=NOW + 5 if i % 7 == 0 else 0)
    pair.flush()
    r = pair.write(codes.RPC_TRIGGER_AUDIT,
                   lambda m: m.TriggerAuditRequest(9, NOW + 10, 0))
    assert r.digest and r.records == 30 - 5
    assert pair.port.last_audit["digest"] == r.digest


# ------------------------------------------------------------------- reads


def fill_range(pair, hk, n=10):
    for i in range(n):
        pair.put(hk, b"s%02d" % i, b"v%02d" % i)


@pytest.mark.parametrize("flushed", [False, True])
def test_multi_get_windows(pair, flushed):
    """Inclusivity, filters, forward/reverse limits, no_value and the
    specified-sort_keys batch, from the memtable and from a flushed run."""
    fill_range(pair, b"mg", 12)
    pair.put(b"mgf", b"aa1", b"x")
    pair.put(b"mgf", b"ab2", b"y")
    pair.put(b"mgf", b"bb3", b"z")
    if flushed:
        pair.flush()
    f = port_msg.FilterType
    cases = [
        dict(start_sortkey=b"s02", stop_sortkey=b"s05", start_inclusive=True,
             stop_inclusive=True),
        dict(start_sortkey=b"s02", stop_sortkey=b"s05",
             start_inclusive=False, stop_inclusive=False),
        dict(max_kv_count=4), dict(max_kv_count=4, reverse=True),
        dict(reverse=True), dict(no_value=True), dict(max_kv_size=20),
        dict(sort_keys=[b"s01", b"nope", b"s07"]),
    ]
    for kw in cases:
        pair.read("on_multi_get", lambda m: m.MultiGetRequest(b"mg", **kw),
                  now=NOW)
    for ft, pat in ((f.MATCH_PREFIX, b"a"), (f.MATCH_POSTFIX, b"3"),
                    (f.MATCH_ANYWHERE, b"b")):
        pair.read("on_multi_get", lambda m: m.MultiGetRequest(
            b"mgf", sort_key_filter_type=ft, sort_key_filter_pattern=pat),
            now=NOW)


def test_limiter_caps_iteration(pair):
    fill_range(pair, b"lim", 50)
    pair.envs({consts.ROCKSDB_ITERATION_THRESHOLD_COUNT: "10"})
    r = pair.read("on_multi_get", lambda m: m.MultiGetRequest(b"lim"),
                  now=NOW)
    assert r.error == port_msg.Status.INCOMPLETE
    r = pair.read("on_multi_get", lambda m: m.MultiGetRequest(
        b"lim", max_kv_count=5, reverse=True), now=NOW)
    assert [kv.key for kv in r.kvs] == [b"s49", b"s48", b"s47", b"s46",
                                        b"s45"]
    r = pair.read("on_sortkey_count", lambda m: b"lim", now=NOW)
    assert r.error == port_msg.Status.INCOMPLETE
    pair.envs({consts.ROCKSDB_ITERATION_THRESHOLD_COUNT: "1000"})
    assert pair.read("on_sortkey_count", lambda m: b"lim",
                     now=NOW).count == 50


def test_get_scanner_prefix_narrowing_and_ttl(pair):
    pair.put(b"pfx_a", b"s", b"1")
    pair.put(b"pfx_b", b"s", b"2", expire=NOW + 1)
    pair.put(b"other", b"s", b"3")
    for now in (NOW, NOW + 1):
        r = pair.read("on_get_scanner", lambda m: m.GetScannerRequest(
            hash_key_filter_type=m.FilterType.MATCH_PREFIX,
            hash_key_filter_pattern=b"pfx_", validate_partition_hash=False,
            return_expire_ts=True), now=now)
        assert {restore_key(kv.key)[0] for kv in r.kvs} == (
            {b"pfx_a", b"pfx_b"} if now == NOW else {b"pfx_a"})
    assert pair.get(b"pfx_b", b"s", now=NOW) == b"2"
    assert pair.get(b"pfx_b", b"s", now=NOW + 1) is None
    assert pair.read("on_ttl", lambda m: generate_key(b"other", b"s"),
                     now=NOW).ttl_seconds == -1
    assert pair.read("on_ttl", lambda m: generate_key(b"gone", b"s"),
                     now=NOW).error == port_msg.Status.NOT_FOUND


def _drain_scan(pair, first):
    """Follow a scan session to its end on both servers in lockstep."""
    rounds = [first[1]]
    r = first[1]
    while r.context_id >= 0:
        r = pair.both(lambda s, m: s.on_scan(m.ScanRequest(r.context_id),
                                             now=NOW))[1]
        rounds.append(r)
        assert len(rounds) < 100
    return rounds


def test_scan_limiter_partial_batches_resume(pair):
    for i in range(120):
        pair.put(b"scl", b"s%03d" % i, b"v")
    pair.flush()
    pair.envs({consts.ROCKSDB_ITERATION_THRESHOLD_COUNT: "25"})
    first = pair.both(lambda s, m: s.on_get_scanner(m.GetScannerRequest(
        start_key=generate_key(b"scl", b""),
        stop_key=generate_next_bytes(b"scl"), batch_size=1000,
        validate_partition_hash=False,
        sort_key_filter_type=m.FilterType.MATCH_POSTFIX,
        sort_key_filter_pattern=b"7"), now=NOW))
    rounds = _drain_scan(pair, first)
    assert len(rounds) >= 4
    got = [restore_key(kv.key)[1] for r in rounds for kv in r.kvs]
    assert got == [b"s%03d" % i for i in range(120) if i % 10 == 7]
    # a finished session is gone
    pair.both(lambda s, m: s.on_scan(m.ScanRequest(7 << 32), now=NOW))


def test_scan_session_survives_manual_compact(pair):
    """A scan session opened before a manual compaction keeps its snapshot
    after the compaction swaps and unlinks every file it points at (and
    releases their device runs), on both servers, byte for byte."""
    for i in range(80):
        pair.put(b"scc", b"s%03d" % i, b"v%d" % i)
    pair.flush()
    for i in range(80, 160):
        pair.put(b"scc", b"s%03d" % i, b"v%d" % i)
    pair.flush()
    pair.envs({consts.ROCKSDB_ITERATION_THRESHOLD_COUNT: "30"})
    r = pair.both(lambda s, m: s.on_get_scanner(m.GetScannerRequest(
        start_key=generate_key(b"scc", b""),
        stop_key=generate_next_bytes(b"scc"), batch_size=25,
        validate_partition_hash=False), now=NOW))[1]
    got = list(r.kvs)
    for s in (pair.ref, pair.port):
        s.engine.manual_compact(now=NOW)
    for i in range(160, 200):
        pair.put(b"scc", b"s%03d" % i, b"x")
    pair.flush()
    for s in (pair.ref, pair.port):
        s.engine.manual_compact(now=NOW)
    while r.context_id >= 0:
        r = pair.both(lambda s, m: s.on_scan(m.ScanRequest(r.context_id),
                                             now=NOW))[1]
        got.extend(r.kvs)
    assert [(restore_key(kv.key)[1], kv.value) for kv in got] == \
        [(b"s%03d" % i, b"v%d" % i) for i in range(160)]


def test_reads_from_cold_reopened_files(tmp_path):
    """multi_get, sortkey_count, hash scans and point gets over eight L0
    files reopened cold (the bloom-pruned walks)."""
    opts = {"l0_compaction_trigger": 100}
    p = Pair(tmp_path, opts=opts)
    for h in range(8):
        for s in range(20):
            p.put(b"user%d" % h, b"sk%05d" % s, b"v%d.%d" % (h, s))
        p.flush()
    p.close()
    p = Pair(tmp_path, opts=opts)
    assert p.port.engine.stats()["l0_files"] == 8
    r = p.read("on_multi_get", lambda m: m.MultiGetRequest(b"user3"),
               now=NOW)
    assert len(r.kvs) == 20
    assert p.read("on_sortkey_count", lambda m: b"user5", now=NOW).count == 20
    r = p.read("on_get_scanner", lambda m: m.GetScannerRequest(
        start_key=generate_key(b"user2", b""),
        stop_key=generate_next_bytes(b"user2"), batch_size=100), now=NOW)
    assert len(r.kvs) == 20
    assert p.get(b"user7", b"sk00001", now=NOW) == b"v7.1"
    p.assert_same_state()
    p.close()


def test_engine_reverse_scan_matches_forward(pair):
    fill_range(pair, b"revscan", 12)
    pair.flush()
    for s in (pair.ref, pair.port):
        fwd = [k for k, _, _ in s.engine.scan(b"", None, now=1)]
        rev = [k for k, _, _ in s.engine.scan(b"", None, now=1,
                                              reverse=True)]
        assert rev == list(reversed(fwd)) and len(fwd) == 12


def test_capacity_units_match(tmp_path):
    """Per-op capacity units and byte counters move alike in both
    packages (the same counter names)."""
    p = Pair(tmp_path, app_id=77)
    names = ["app.77.0.recent_read_cu", "app.77.0.recent_write_cu",
             "app.77.0.get_bytes", "app.77.0.put_bytes",
             "app.77.0.check_and_set_bytes"]

    def snap():
        return ([ref_counters.rate(n).total() for n in names],
                [port_counters.rate(n).total() for n in names])
    r0, p0 = snap()
    p.put(b"h", b"s", b"v")
    p.write(codes.RPC_INCR, lambda m: m.IncrRequest(generate_key(b"h", b"c"),
                                                    1))
    p.write(codes.RPC_CHECK_AND_SET, lambda m: m.CheckAndSetRequest(
        hash_key=b"h", check_sort_key=b"s",
        check_type=m.CasCheckType.VALUE_EXIST, set_diff_sort_key=True,
        set_sort_key=b"s2", set_value=b"nv"))
    p.get(b"h", b"s")
    r1, p1 = snap()
    assert [b - a for a, b in zip(p0, p1)] == [b - a for a, b in zip(r0, r1)]
    # read CU, write CU, get and check_and_set bytes moved (a lone put
    # takes the batched write path, which charges no CU in either)
    assert [b > a for a, b in zip(p0, p1)] == [True, True, True, False,
                                                True]
    p.close()


# ---------------------------------------------------------------- app envs


def test_app_envs_hot_apply(pair):
    """default_ttl, user_specified_compaction, the throttles and the
    usage scenario hot-apply alike; a manual compaction then rewrites
    both tables to the same digest."""
    spec = ('{"ops":[{"type":"COT_DELETE","params":"{}","rules":[{"type":'
            '"FRT_HASHKEY_PATTERN","params":"{\\"pattern\\":\\"h1\\",'
            '\\"match_type\\":\\"SMT_MATCH_PREFIX\\"}"}]}]}')
    for i in range(40):
        pair.put(b"h%d" % (i % 3), b"s%02d" % i, b"v%d" % i)
    pair.envs({consts.TABLE_LEVEL_DEFAULT_TTL: "3600",
               consts.USER_SPECIFIED_COMPACTION: spec,
               consts.ENV_WRITE_THROTTLING: "100000*delay*1",
               consts.ENV_READ_THROTTLING: "bogus",
               consts.ENV_USAGE_SCENARIO_KEY: consts.USAGE_SCENARIO_BULK_LOAD})
    for s in (pair.ref, pair.port):
        assert s.engine.opts.default_ttl == 3600
        assert len(s.engine.opts.user_ops) == 1
        assert s.write_qps_throttler.enabled
        assert not s.read_qps_throttler.enabled
        assert s.engine.opts.l0_compaction_trigger == 1 << 30
        s.engine.manual_compact(now=NOW)
    r = pair.read("on_multi_get", lambda m: m.MultiGetRequest(b"h1"),
                  now=NOW)
    assert r.kvs == []
    assert pair.port.app_envs == pair.ref.app_envs


def test_abnormal_size_and_slow_query(pair, capsys):
    pair.envs({consts.ENV_ABNORMAL_GET_SIZE: "8",
               consts.ENV_SLOW_QUERY_THRESHOLD: "0"})
    pair.put(b"big", b"s", b"x" * 64)
    capsys.readouterr()
    pair.get(b"big", b"s")
    out = capsys.readouterr().out.splitlines()
    ref_lines = [ln for ln in out if ln.startswith("[abnormal-size]")]
    assert len(ref_lines) == 2 and ref_lines[0] == ref_lines[1]


# ---------------------------------------------------------------- bulk load


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ingestion_files_from_either_writer(tmp_path, writer):
    """RPC_BULK_LOAD_INGEST's apply: 3 unsorted raw-set files, written by
    either package, holding rows of every partition of a 4-way table;
    each server keeps its own partition's rows, merged newest-file-first,
    the same bytes."""
    root = tmp_path / "provider"
    pdir = root / "t" / "4" / "2"
    pdir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    wr = ref_bulk.write_raw_set if writer == "reference" \
        else port_bulk.write_raw_set
    for f in range(3):
        recs = []
        for i in rng.permutation(300)[:200]:
            recs.append((b"user%d" % (i % 61), b"f%d" % i, b"v%d.%d" % (i, f),
                         int(rng.choice([0, NOW + 100]))))
        wr(str(pdir / ("%d.raw" % f)), recs)
    p = Pair(tmp_path / "srv", pidx=2)
    p.put(b"user1", b"f1", b"old")
    r = p.write(codes.RPC_BULK_LOAD_INGEST, lambda m: m.BulkLoadIngestRequest(
        str(root), "t", 4))
    assert 0 < r.ingested_records < 300
    assert all(s.engine.stats()["l0_files"] == 2 for s in (p.ref, p.port))
    missing = p.write(codes.RPC_BULK_LOAD_INGEST,
                      lambda m: m.BulkLoadIngestRequest(str(root), "u", 4))
    assert missing.ingested_records == 0
    p.assert_same_state()
    p.close()


@pytest.mark.parametrize("shape", ["mixed", "uniform", "empty", "wide"])
def test_raw_sets_same_bytes_both_packages(tmp_path, shape):
    """write_raw_set writes the reference's bytes; read_raw_set and
    load_ingest_file (every value schema) read either package's files as
    the reference does, for mixed-length, uniform (the speculated
    stretches), empty and long-field record sets."""
    rng = np.random.default_rng(len(shape))

    def blob(hi):
        return rng.integers(0, 256, int(rng.integers(0, hi)),
                            dtype=np.uint8).tobytes()
    recs = {"mixed": [(blob(20), blob(5), blob(40),
                       int(rng.choice([0, 7, 2**32 - 1])))
                      for _ in range(300)],
            "uniform": [(b"user%06d" % i, b"field0", b"v" * 100, i)
                        for i in range(500)]
            + [(b"u", b"", b"", 0)] + [(b"user%06d" % i, b"f", b"w", 0)
                                       for i in range(40)],
            "empty": [],
            "wide": [(b"h" * 65534, b"s" * 300, b"v" * 5000, 9)]}[shape]
    a, b = str(tmp_path / "a.raw"), str(tmp_path / "b.raw")
    ref_bulk.write_raw_set(a, recs)
    port_bulk.write_raw_set(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(port_bulk.read_raw_set(a)) == list(
        ref_bulk.read_raw_set(a)) == recs
    from pegasus_tpu_torch.base.value_schema import SCHEMAS as PS

    for ver in (0, 1, 2):
        r = ref_bulk.load_ingest_file(a, SCHEMAS[ver])
        p = port_bulk.load_ingest_file(a, PS[ver])
        assert [r.key(i) for i in range(r.n)] == \
            [p.key(i) for i in range(p.n)]
        assert [r.value(i) for i in range(r.n)] == \
            [p.value(i) for i in range(p.n)]
        for col in ("expire_ts", "hash32", "deleted"):
            np.testing.assert_array_equal(getattr(p, col), getattr(r, col))
    if shape == "wide":  # a hash key too long for a stored key: both refuse
        ref_bulk.write_raw_set(a, [(b"h" * 65535, b"", b"", 0)])
        for mod, schema in ((ref_bulk, SCHEMAS[2]), (port_bulk, PS[2])):
            with pytest.raises(ValueError):
                mod.load_ingest_file(a, schema)


def test_truncated_raw_set_raises(tmp_path):
    """A raw set cut inside a record is refused with ValueError (the
    ingest answers IO_ERROR); cut at a record boundary it is a shorter
    valid set."""
    a = str(tmp_path / "a.raw")
    port_bulk.write_raw_set(a, [(b"h", b"s", b"v" * 10, 3)] * 5)
    raw = open(a, "rb").read()
    rec = (len(raw) - len(port_bulk.RAW_MAGIC)) // 5
    for cut in range(len(port_bulk.RAW_MAGIC) + 1, len(raw)):
        with open(a, "wb") as f:
            f.write(raw[:cut])
        whole = (cut - len(port_bulk.RAW_MAGIC)) % rec == 0
        if whole:
            assert port_bulk.load_ingest_file(a, SCHEMAS[2]).n == \
                (cut - len(port_bulk.RAW_MAGIC)) // rec
        else:
            with pytest.raises(ValueError):
                port_bulk.load_ingest_file(a, SCHEMAS[2])
    with open(a, "wb") as f:
        f.write(b"PGRAW2\n")
    with pytest.raises(ValueError):
        port_bulk.load_ingest_file(a, SCHEMAS[2])


def test_ingest_drops_rows_of_other_partitions(tmp_path):
    """The ingest filter: only rows whose key hashes to the partition
    (under partition_count - 1) survive, whatever their TTL (now = 0)."""
    from pegasus_tpu_torch.base.key_schema import key_hash

    root = tmp_path / "provider"
    pdir = root / "t" / "8" / "5"
    pdir.mkdir(parents=True)
    recs = [(b"k%d" % i, b"s", b"v", 1) for i in range(400)]
    port_bulk.write_raw_set(str(pdir / "a.raw"), recs)
    srv = PegasusServer(str(tmp_path / "db"), pidx=5,
                        options=EngineOptions(device="cpu"))
    resp = srv.on_batched_write_requests(1, TS_US, [(
        codes.RPC_BULK_LOAD_INGEST,
        port_msg.BulkLoadIngestRequest(str(root), "t", 8))])[0]
    want = sorted(generate_key(hk, sk) for hk, sk, _, _ in recs
                  if key_hash(generate_key(hk, sk)) % 8 == 5)
    got = [k for k, _, _ in srv.engine.scan(now=0)]
    assert resp.ingested_records == len(want) and got == want
    srv.close()


# ------------------------------------------------------- manual compaction


class McPair(Pair):
    def fill(self, n=20):
        for i in range(n):
            key = generate_key(b"h", b"s%03d" % i)
            self.ref.engine.put(key, SCHEMAS[2].generate_value(0, 0, b"v"))
            self.port.engine.put(key, SCHEMAS[2].generate_value(0, 0, b"v"))

    def services(self, mock_now=None):
        return (ref_mcs.ManualCompactService(self.ref, mock_now=mock_now),
                port_mcs.ManualCompactService(self.port, mock_now=mock_now))

    def start(self, svcs, envs):
        got = [s.start_manual_compact_if_needed(envs) for s in svcs]
        assert got[0] == got[1]
        return got[1]


@pytest.fixture
def mc(tmp_path):
    p = McPair(tmp_path)
    p.fill()
    yield p
    p.assert_same_state()
    p.close()


def test_mc_disabled_and_future(mc):
    svcs = mc.services(mock_now=1000)
    assert not mc.start(svcs, {consts.MANUAL_COMPACT_DISABLED_KEY: "true",
                               consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY:
                               "500"})
    assert not mc.start(svcs, {
        consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "5000"})


def test_mc_once_trigger_fires_once(mc):
    svcs = mc.services(mock_now=1000)
    envs = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900"}
    assert mc.start(svcs, envs)
    assert mc.port.engine.stats()["l0_files"] == 0
    for s in svcs:
        s.set_mock_now(2000)
    assert not mc.start(svcs, envs)
    envs[consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY] = "1500"
    assert mc.start(svcs, envs)


def test_mc_periodic_trigger(mc):
    now = time.time()
    lt = time.localtime(now)
    midnight = int(now) - (lt.tm_hour * 3600 + lt.tm_min * 60 + lt.tm_sec)
    svcs = mc.services(mock_now=midnight + 4 * 3600 + 30 * 60)
    envs = {consts.MANUAL_COMPACT_PERIODIC_TRIGGER_TIME_KEY: "3:00,21:00"}
    assert mc.start(svcs, envs)
    assert not mc.start(svcs, envs)
    for s in svcs:
        s.set_mock_now(midnight + 21 * 3600 + 60)
    assert mc.start(svcs, envs)


def test_mc_concurrency_cap(mc):
    svcs = mc.services(mock_now=1000)
    envs = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900",
            consts.MANUAL_COMPACT_MAX_CONCURRENT_RUNNING_COUNT_KEY: "1"}
    ref_mcs.GATE.running = port_mcs.GATE.running = 1
    try:
        assert not mc.start(svcs, envs)
    finally:
        ref_mcs.GATE.running = port_mcs.GATE.running = 0
    assert mc.start(svcs, envs)


def test_mc_bottommost_and_target_level(mc):
    svcs = mc.services(mock_now=1000)
    envs = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900",
            consts.MANUAL_COMPACT_ONCE_KEY_PREFIX
            + consts.MANUAL_COMPACT_TARGET_LEVEL_KEY: "1",
            consts.MANUAL_COMPACT_ONCE_KEY_PREFIX
            + consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_KEY:
            consts.MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_FORCE}
    assert mc.start(svcs, envs)
    assert mc.port.engine.stats()["level_files"] == \
        mc.ref.engine.stats()["level_files"] == {1: 1}


def test_mc_finish_time_persisted_and_state_string(mc, tmp_path):
    svcs = mc.services(mock_now=1000)
    assert "never compacted" in svcs[1].query_compact_state()
    mc.start(svcs, {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900"})
    assert "idle; last finish" in svcs[1].query_compact_state()
    for s in (mc.ref, mc.port):
        assert s.engine.meta_store[
            "pegasus_last_manual_compact_finish_time"] == 1000
    assert port_mcs.ManualCompactService(
        mc.port, mock_now=1000).last_finish_time_ms == 1000 * 1000
    # the engine's own finish time is in the manifest: a reopened engine
    # reads it
    mc.port.close()
    again = PegasusServer(str(tmp_path / "port"),
                          options=EngineOptions(device="cpu"))
    assert again.manual_compact_service.last_finish_time_ms > 0
    again.close()


def test_mc_app_env_update_path(mc):
    for s in (mc.ref, mc.port):
        s.manual_compact_service.set_mock_now(1000)
    mc.envs({consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900"})
    assert mc.port.engine.stats()["l0_files"] == 0
    assert mc.ref.engine.stats()["l0_files"] == 0


def test_mc_failed_merge_is_recorded_not_persisted(tmp_path, monkeypatch):
    """No lane guard: a merge that raises (a device or kernel failure)
    reaches the caller, the service records it for query_compact_state,
    and no finish time is persisted, so the once-trigger retries."""
    srv = PegasusServer(str(tmp_path / "db"),
                        options=EngineOptions(device="cpu"))
    for i in range(20):
        srv.engine.put(generate_key(b"h", b"s%03d" % i),
                       SCHEMAS[2].generate_value(0, 0, b"v"))
    from pegasus_tpu_torch.engine import db as port_db

    def boom(*a, **k):
        raise RuntimeError("merge_path merge kernel launch failed: "
                           "cudaError 700")
    monkeypatch.setattr(port_db, "compact_blocks", boom)
    svc = port_mcs.ManualCompactService(srv, mock_now=1000)
    envs = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "900"}
    with pytest.raises(RuntimeError, match="cudaError 700"):
        svc.start_manual_compact_if_needed(envs)
    state = svc.query_compact_state()
    assert "FAILED" in state and "cudaError 700" in state
    assert svc.last_finish_time_ms == 0
    assert "pegasus_last_manual_compact_finish_time" not in \
        srv.engine.meta_store
    assert srv.engine.stats()["l0_files"] == 1   # the inputs stay
    monkeypatch.undo()
    assert svc.start_manual_compact_if_needed(envs)   # the retry runs
    assert "FAILED" not in svc.query_compact_state()
    srv.close()


def test_watchdog_probes_the_engines_device(tmp_path):
    wd = device_watchdog.watchdog_for("cpu")
    assert wd.probe() and wd.state()["wedged_at_stage"] is None
    bad = device_watchdog.DeviceHealthWatchdog(
        "cpu", probe_fn=lambda: (_ for _ in ()).throw(RuntimeError("gone")))
    assert not bad.probe() and not bad.probe()
    assert bad.state()["wedged_at_stage"] == "idle"
    assert "gone" in bad.state()["last_error"]
    hung = device_watchdog.DeviceHealthWatchdog(
        "cpu", probe_fn=lambda: time.sleep(5))
    t0 = time.perf_counter()
    assert not hung.probe(timeout_s=0.2)
    assert not hung.probe(timeout_s=0.2)   # fails fast: the probe is hung
    assert time.perf_counter() - t0 < 2
    if not torch.cuda.is_available():
        assert not device_watchdog.DeviceHealthWatchdog().probe(
            timeout_s=5)


# ------------------------------------------------- reads against compaction


def test_reads_racing_manual_compaction(tmp_path):
    """RPC-thread point and range reads while manual compactions release
    and re-prime the resident runs: every answer is the written value."""
    srv = PegasusServer(str(tmp_path / "db"),
                        options=EngineOptions(device="cpu",
                                              memtable_bytes=4096))
    want = {}
    for i in range(600):
        key = generate_key(b"r%02d" % (i % 17), b"s%04d" % i)
        want[key] = b"v%d" % i
        srv.on_batched_write_requests(i + 1, TS_US, [(
            codes.RPC_PUT, port_msg.UpdateRequest(key, want[key], 0))])
    keys = sorted(want)
    errors, stop = [], threading.Event()

    def reader(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                k = keys[int(rng.integers(len(keys)))]
                r = srv.on_get(k, now=NOW)
                if r.value != want[k] or r.error:
                    errors.append((k, r))
                hk = restore_key(k)[0]
                mg = srv.on_multi_get(port_msg.MultiGetRequest(hk), now=NOW)
                if len(mg.kvs) != sum(1 for x in keys
                                      if restore_key(x)[0] == hk):
                    errors.append((hk, len(mg.kvs)))
            except Exception as e:  # noqa: BLE001 - collected and asserted
                errors.append(e)

    threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            srv.manual_compact(now=NOW)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    srv.close()


def test_default_server_targets_the_card(tmp_path):
    """No device argument: the engine's device is cuda (on a CPU-only
    machine its first flush raises instead of running on the CPU)."""
    srv = PegasusServer(str(tmp_path / "db"))
    assert srv.engine.device == torch.device("cuda")
    assert srv.engine.opts.backend == "cuda"
    if not torch.cuda.is_available():
        srv.on_batched_write_requests(1, TS_US, [(
            codes.RPC_PUT, port_msg.UpdateRequest(generate_key(b"h", b"s"),
                                                  b"v", 0))])
        with pytest.raises((RuntimeError, AssertionError)):
            srv.engine.flush()


@pytest.mark.cuda
def test_server_on_the_card(tmp_path):
    """The same parity run with the port's server on the card: writes,
    flushes, a manual compaction through the merge-path kernel and the
    batched device reads, byte-equal to the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: python -m pytest "
                    "-m cuda tests/test_torch_*.py)")
    from pegasus_tpu_torch.ops.merge_path import LAUNCHES

    ref = RefServer(str(tmp_path / "ref"), options=RefOptions(backend="cpu"))
    port = PegasusServer(str(tmp_path / "port"))
    for i in range(2000):
        key = generate_key(b"c%03d" % (i % 97), b"s%05d" % i)
        for s, m in ((ref, ref_msg), (port, port_msg)):
            s.on_batched_write_requests(i + 1, TS_US, [(
                codes.RPC_PUT, m.UpdateRequest(key, b"v%d" % i, 0))])
        if i % 500 == 499:
            ref.engine.flush()
            port.engine.flush()
    launches = LAUNCHES["merge_path"]
    ref.engine.manual_compact(now=NOW)
    port.engine.manual_compact(now=NOW)
    assert LAUNCHES["merge_path"] > launches
    keys = [generate_key(b"c%03d" % (i % 97), b"s%05d" % i)
            for i in range(0, 2000, 7)]
    for k in keys:
        assert port_codec.encode(port.on_get(k, now=NOW)) == \
            ref_codec.encode(ref.on_get(k, now=NOW))
    assert port.engine.state_digest(now=NOW) == \
        ref.engine.state_digest(now=NOW)
    ref.close()
    port.close()


def test_consts_and_codes_match_the_reference():
    for name in dir(ref_consts):
        if name.isupper() and hasattr(consts, name):
            assert getattr(consts, name) == getattr(ref_consts, name), name
    for name in dir(ref_codes):
        if name.startswith("RPC_") or name == "BATCHABLE":
            assert getattr(codes, name) == getattr(ref_codes, name), name


def test_c_escape_string_matches_the_reference():
    """The slow-query and abnormal-size logs print hash keys through
    c_escape_string: the same text as the reference for every byte."""
    from pegasus_tpu.base.utils import c_escape_string as ref_escape
    from pegasus_tpu_torch.base.utils import c_escape_string

    rng = np.random.default_rng(5)
    for data in (bytes(range(256)), b'user"1\\x', b"",
                 rng.integers(0, 256, 500, dtype=np.uint8).tobytes()):
        assert c_escape_string(data) == ref_escape(data)
