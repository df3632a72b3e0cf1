"""The port's per-table ledger (pegasus_tpu_torch/runtime/table_stats.py)
held to the JAX package's on the CPU.

fold_snapshots and top_k give the reference's answers on the same
fragments; a ledger charged alike exports the reference's snapshot; a
port server charges its table as the reference's server does for the
same requests; the stub's beacon fragment is byte-equal through both
codecs; the meta folds the fragments its beacons carry as the
reference's fold does; `table-stats` answers pid-keyed JSON and the
shell's `tables` folds every node's fragment; a rejected dispatch is
charged to its table.
"""

import io
import json
import os
import time

import numpy as np
import pytest

import pegasus_tpu.runtime.table_stats as ref_ts
import pegasus_tpu_torch.runtime.table_stats as port_ts
from pegasus_tpu_torch.runtime.table_stats import TABLE_STATS


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


def _fragments(seed):
    rng = np.random.default_rng(seed)
    frags = []
    for _ in range(int(rng.integers(2, 6))):
        frag = {}
        for t in rng.choice(["gold", "silver", "bronze", "tin"],
                            size=int(rng.integers(1, 4)), replace=False):
            m = {k: int(rng.integers(0, 1000)) for k in port_ts._SUM_KEYS}
            m["device_seconds"] = float(rng.random())
            for k in port_ts._PCTL_KEYS:
                m[k] = {q: int(rng.integers(0, 5000))
                        for q in ("p50", "p90", "p95", "p99", "p999")}
            frag[str(t)] = m
        frags.append(frag)
    return frags + [None, {"junk": 3}, "x"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fold_and_top_k_equal_the_reference(seed):
    frags = _fragments(seed)
    folded = port_ts.fold_snapshots(frags)
    assert folded == ref_ts.fold_snapshots(frags)
    for k in (1, 2, 5):
        assert port_ts.top_k(folded, k) == ref_ts.top_k(folded, k)


def _charge(mod, name):
    led = mod.TableStats().ledger(name)
    led.charge_read(120, 64)
    led.charge_read(80)
    led.charge_write(300, nbytes_in=200, n_ops=3)
    led.charge_scan(900, nbytes_out=4096)
    led.charge_bytes_in(10)
    led.charge_error(2)
    led.charge_throttle_delay(12.5)
    led.charge_device_read(7)
    led.set_hbm_resident(1 << 20)
    led.set_device_attribution(0.25, 512)
    return led.snapshot()


def test_ledger_snapshot_equals_the_reference():
    port = _charge(port_ts, "t_snap_port")
    ref = _charge(ref_ts, "t_snap_ref")
    assert port == ref
    assert port["read_qps"] == 2 and port["write_qps"] == 3
    assert port["bytes_out"] == 64 + 4096 and port["bytes_in"] == 210


def test_attribute_jobs_charges_compact_jobs_to_tables():
    for mod in (port_ts, ref_ts):
        ts = mod.TableStats()
        ts.register_gpid(4, 0, "gold")
        ts.register_gpid(5, 1, "silver")
        ts.attribute_jobs([
            {"kind": "compact", "status": "ok", "duration_us": 2_000_000,
             "attrs": {"pidx": 0},
             "hops": [{"name": "offload.ship", "nbytes": 100}]},
            {"kind": "compact", "status": "ok", "duration_us": 500_000,
             "attrs": {"gpid": "5.1"}, "hops": []},
            {"kind": "learn", "status": "ok", "duration_us": 9,
             "attrs": {"pidx": 0}, "hops": []}])
        snap = ts.snapshot()
        assert snap["gold"]["device_seconds"] == 2.0
        assert snap["gold"]["offload_bytes"] == 100
        assert snap["silver"]["device_seconds"] == 0.5
        ts.reset()


def test_server_charges_equal_the_reference(tmp_path):
    from tests.test_torch_server import Pair
    from pegasus_tpu_torch.rpc import task_codes as codes

    p = Pair(tmp_path)
    try:
        p.ref.set_table_name("t_srv_ref")
        p.port.set_table_name("t_srv_port")
        for i in range(6):
            p.put(b"h%d" % i, b"s", b"v" * (i + 1))
        p.write(codes.RPC_MULTI_PUT, lambda m: m.MultiPutRequest(
            b"mh", [m.KeyValue(b"a", b"1"), m.KeyValue(b"b", b"22")], 0))
        p.flush()
        for i in range(4):
            p.get(b"h%d" % i, b"s")
        p.get(b"nope", b"s")
        p.read("on_multi_get", lambda m: m.MultiGetRequest(
            b"mh", [b"a", b"b"]))
        p.read("on_get_scanner", lambda m: m.GetScannerRequest(
            batch_size=100, validate_partition_hash=False))
        keys = ("read_qps", "write_qps", "scan_qps", "bytes_in",
                "bytes_out", "errors")
        got = TABLE_STATS.snapshot()["t_srv_port"]
        want = ref_ts.TABLE_STATS.snapshot()["t_srv_ref"]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert got["read_qps"] == 6 and got["write_qps"] == 7
        assert got["scan_qps"] == 1 and got["bytes_out"] > 0
        assert TABLE_STATS.table_for_gpid("1.0") == "t_srv_port"
    finally:
        p.close()


def test_beacon_fragment_is_byte_equal_through_the_codec():
    from pegasus_tpu.meta import messages as ref_mm
    from pegasus_tpu.replication.replica_stub import ReplicaStub as RefStub
    from pegasus_tpu.rpc import codec as ref_codec
    from pegasus_tpu_torch.meta import messages as port_mm
    from pegasus_tpu_torch.replication.replica_stub import ReplicaStub
    from pegasus_tpu_torch.rpc import codec as port_codec

    class _NoReplicas:
        _replicas = {}

    for mod in (port_ts, ref_ts):
        led = mod.TABLE_STATS.ledger("t_beacon")
        led.charge_write(100, nbytes_in=30, n_ops=2)
        led.charge_read(50, 9)
    port_frag = json.loads(
        ReplicaStub._table_stats_fragment_locked(_NoReplicas()))
    ref_frag = json.loads(RefStub._table_stats_fragment(_NoReplicas()))
    assert port_frag["gpid"] == ref_frag["gpid"] == f"tables@pid:{os.getpid()}"
    assert port_frag["status"] == ref_frag["status"] == "TABLE_STATS"
    assert port_frag["tables"]["t_beacon"] == ref_frag["tables"]["t_beacon"]
    frag = json.dumps({"gpid": port_frag["gpid"], "status": "TABLE_STATS",
                       "tables": {"t_beacon": port_frag["tables"]["t_beacon"]}})
    port_bytes = port_codec.encode(port_mm.BeaconRequest(
        node="n:1", alive_replicas=["1.0"], replica_states=[frag]))
    ref_bytes = ref_codec.encode(ref_mm.BeaconRequest(
        node="n:1", alive_replicas=["1.0"], replica_states=[frag]))
    assert port_bytes == ref_bytes
    back = port_codec.decode(port_mm.BeaconRequest, ref_bytes)
    assert json.loads(back.replica_states[0]) == json.loads(frag)


# ------------------------------------------------------------ the cluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from tests.test_torch_cluster import Cluster, make_client

    c = Cluster(tmp_path_factory.mktemp("tables"))
    gold = make_client(c, "gold", partitions=2)
    tin = make_client(c, "tin", partitions=2)
    yield c, gold, tin
    gold.close()
    tin.close()
    c.stop()


def _wait_folded(c, table, n_writes, n_reads=0):
    """The meta's fold once the beacons carried the charges."""
    deadline = time.time() + 10
    while True:
        folded = c.meta.table_stats()["tables"]
        t = folded.get(table, {})
        if t.get("write_qps", 0) >= n_writes and \
                t.get("read_qps", 0) >= n_reads:
            return folded
        assert time.time() < deadline, folded
        time.sleep(0.1)


def test_meta_folds_the_beacon_fragments(cluster):
    from pegasus_tpu.runtime.service_app import _tables_meta_route

    c, gold, tin = cluster
    for i in range(30):
        gold.set(b"g%d" % i, b"s", b"v" * 20)
    for i in range(5):
        tin.set(b"t%d" % i, b"s", b"v")
    for i in range(10):
        gold.get(b"g%d" % i, b"s")
    folded = _wait_folded(c, "gold", 30, 10)
    # every replica of a write charges it: 3 replicas x 30 acknowledged
    assert folded["gold"]["write_qps"] >= 30
    assert folded["gold"]["read_qps"] >= 10
    # tin's charges may ride a later beacon than gold's
    _wait_folded(c, "tin", 5)
    # the process-wide ledgers may hold other tests' tables too: rank
    # this cluster's two against each other
    view = c.meta.table_stats(k=100)
    ops = [e["table"] for e in view["top"]["ops"]]
    assert ops.index("gold") < ops.index("tin")
    ref_view = _tables_meta_route(c.meta)("/tables")
    assert ref_view["tables"] == view["tables"]


def test_table_stats_command_and_shell_tables(cluster):
    from pegasus_tpu_torch.shell.main import Shell

    c, gold, _ = cluster
    gold.set(b"sh", b"s", b"v")
    node = next(iter(c.nodes))
    out = io.StringIO()
    sh = Shell([c.meta_addr], out=out)
    reply = json.loads(sh._node_command(node, "table-stats", []))
    assert list(reply) == [f"pid:{os.getpid()}"]
    assert "gold" in reply[f"pid:{os.getpid()}"]
    sh.run_line("tables 3")
    shown = json.loads(out.getvalue())
    assert set(shown) == {"tables", "top"}
    assert shown["tables"]["gold"]["write_qps"] >= 1
    assert len(shown["top"]["ops"]) <= 3


def test_rejected_dispatch_is_charged_to_its_table(cluster):
    from pegasus_tpu_torch.runtime import fail_points

    c, gold, _ = cluster
    app_id = gold.resolver.app_id
    led_before = TABLE_STATS.snapshot()["gold"]["errors"]
    fail_points.setup()
    try:
        # the stubs' beacons dispatch in this process too: a count of one
        # may be spent on a beacon before the set reaches its primary
        fail_points.cfg("serve.dispatch", "20*raise(busy)")
        with pytest.raises(Exception):
            gold.set(b"rej", b"s", b"v")
    finally:
        fail_points.teardown()
    assert TABLE_STATS.snapshot()["gold"]["errors"] >= led_before + 1
    assert TABLE_STATS.table_for_app(app_id) == "gold"
