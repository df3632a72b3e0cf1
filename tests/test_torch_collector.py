"""The info collector, the SLO evaluator and the counter reporter
(pegasus_tpu_torch.collector) against pegasus_tpu's, in one process.

- Hotspot analysis and the hotkey state machine give the same verdicts
  on seeded inputs.
- Both packages' InfoCollector drive the closed hotkey loop over the
  same scripted nodes and seeded QPS rounds: the same remote commands in
  the same order, the same hotspots, hotkey verdicts and read-residency
  pins (time frozen in both modules: a verdict carries its time).
- On the port's in-process cluster, behind the port's meta and behind
  the reference's, the port collector's collect_once runs over real
  sockets while every reply is recorded; the reference collector's
  collect_once then reads the same replies. Both give the same app,
  compaction, lag, slow-request and table rollups and the same SLO
  verdicts, and the port's doctor names a burning table.
- evaluate_slos on seeded samples, with the same `now` and the same
  metric-history window in both packages: equal verdicts and gauges.
- prometheus_text and falcon_payload of one snapshot are byte-equal; a
  port CounterReporter serves /metrics, /slo, /tables, /health/cluster,
  /jobs and /metrics/history.
- The wire: collector-info's JSON and the slo-status reply are equal
  across the packages.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from pegasus_tpu.collector import info_collector as ref_ic
from pegasus_tpu.collector import reporter as ref_rep
from pegasus_tpu.engine import hotkey_collector as ref_hk
from pegasus_tpu.rpc.transport import RpcError as RefRpcError
from pegasus_tpu.runtime import metric_history as ref_mh
from pegasus_tpu.runtime.perf_counters import counters as ref_counters
from pegasus_tpu_torch.collector import cluster_doctor as port_cd
from pegasus_tpu_torch.collector import info_collector as port_ic
from pegasus_tpu_torch.collector import reporter as port_rep
from pegasus_tpu_torch.engine import hotkey_collector as port_hk
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc.transport import RpcError
from pegasus_tpu_torch.runtime import metric_history as port_mh
from pegasus_tpu_torch.runtime.perf_counters import counters
from tests.test_torch_cluster import Cluster, make_client
from tests.test_torch_replication import _FrozenTime

MODS = (port_ic, ref_ic)
ERRORS = (RpcError, RefRpcError)


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


@pytest.fixture
def frozen(monkeypatch):
    """time.time() frozen at one instant in both info_collector modules;
    `frozen.t` moves it."""
    clocks = [_FrozenTime(mod.time) for mod in MODS]
    for mod, clk in zip(MODS, clocks):
        monkeypatch.setattr(mod, "time", clk)

    class _Clock:
        @property
        def t(self):
            return clocks[0]._t

        @t.setter
        def t(self, v):
            for c in clocks:
                c._t = v

    yield _Clock()
    for mod in MODS:
        mod.reset_slo()


@pytest.fixture
def slo_env(monkeypatch):
    for k in ("PEGASUS_SLO_CONFIG", "PEGASUS_SLO_AVAIL",
              "PEGASUS_SLO_P99_US", "PEGASUS_SLO_FAST_S",
              "PEGASUS_SLO_SLOW_S", "PEGASUS_SLO_BURN_WARN",
              "PEGASUS_SLO_BURN_CRIT", "PEGASUS_TABLE_TOPK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# ------------------------------------------------------------ pure folds


@pytest.mark.parametrize("seed", range(6))
def test_hotspot_partitions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(0, 12))
        qps = {p: float(rng.choice([0.0, 10.0, rng.integers(0, 50)]))
               for p in range(n)}
        if n and rng.random() < 0.5:
            qps[int(rng.integers(0, n))] = float(rng.integers(100, 1000))
        assert port_ic.hotspot_partitions(dict(qps)) == \
            ref_ic.hotspot_partitions(dict(qps))
    qps = {i: 10.0 for i in range(8)}
    assert port_ic.hotspot_partitions(qps) == []
    qps[3] = 500.0
    assert port_ic.hotspot_partitions(qps) == [3]


def test_hotkey_state_machine():
    """One dominant key among background noise: both packages' read
    collectors walk coarse -> fine -> finished to the same key."""
    hcs = [mod.HotkeyCollector("read", coarse_threshold=50,
                               fine_threshold=30)
           for mod in (port_hk, ref_hk)]
    for hc in hcs:
        assert hc.state == port_hk.STOPPED
        hc.start()
        assert hc.state == port_hk.COARSE
    for i in range(200):
        for hc in hcs:
            hc.capture(b"HOT" if i % 2 == 0 else b"bg%d" % i)
        assert hcs[0].state == hcs[1].state
    for hc in hcs:
        assert hc.state == port_hk.FINISHED and hc.result == b"HOT"
    assert hcs[0].query() == hcs[1].query()
    assert b"HOT" in hcs[0].query().encode()
    for hc in hcs:
        hc.stop()
        assert hc.state == port_hk.STOPPED


class _FakeHotkeyNode:
    """Scripted detect_hotkey endpoint for the closed-loop driver."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.calls = []

    def remote_command(self, addr, command, args):
        if command == "set-read-residency":
            self.calls.append((addr, (command,) + tuple(args)))
            return f"read residency {args[1]} for {args[0]}"
        assert command == "detect_hotkey"
        self.calls.append((addr, tuple(args)))
        action = args[2]
        if action == "start":
            return "read hotkey detection started (coarse)"
        if action == "stop":
            return "read hotkey detection stopped"
        return self.answers.pop(0)


def _loop_state(coll) -> str:
    return _dumps({"hotkeys": {a: {str(p): v for p, v in r.items()}
                               for a, r in coll.hotkey_results.items()},
                   "residency": sorted((list(k), v) for k, v in
                                       coll.read_residency.items()),
                   "detections": sorted((list(k), v) for k, v in
                                        coll._detections.items()),
                   "streak": sorted((list(k), v) for k, v in
                                    coll._hot_streak.items())})


def test_hotkey_loop_state_machine(frozen):
    """A partition flagged hotkey_rounds rounds in a row gets the
    detect_hotkey start/query/stop sequence; the read verdict pins the
    partition's residency, calming releases it; both packages send the
    same commands and publish the same counters."""
    colls = [mod.InfoCollector(["x:1"], hotkey_rounds=2) for mod in MODS]
    fakes = [_FakeHotkeyNode(["read detection state: FINE_DETECTING",
                              "read hotkey: b'HOT'"]) for _ in MODS]
    for c, f in zip(colls, fakes):
        c.remote_command = f.remote_command
    primaries = {3: "node-a:34801"}
    rounds = [([3], primaries, {3: 100.0}, {3: 1.0})] * 3 + [
        ([], primaries, None, None)]
    for i, args in enumerate(rounds):
        for c in colls:
            with c._lock:
                c.drive_hotkey_loop("happ", 9, *args)
        assert fakes[0].calls == fakes[1].calls
        assert _loop_state(colls[0]) == _loop_state(colls[1])
        if i == 0:
            assert fakes[0].calls == []
        if i == 1:
            assert fakes[0].calls[0] == ("node-a:34801",
                                         ("9.3", "read", "start"))
            assert ("happ", 3) in colls[0]._detections
        if i == 2:
            assert colls[0].hotkey_results["happ"][3] == {
                "kind": "read", "key": "b'HOT'", "ts": frozen.t}
            assert ("node-a:34801", ("set-read-residency", "9.3", "on")) \
                in fakes[0].calls
            assert ("happ", 3) in colls[0].read_residency
    assert ("node-a:34801", ("set-read-residency", "9.3", "off")) \
        in fakes[0].calls
    assert ("happ", 3) not in colls[0].read_residency
    snaps = [reg.snapshot(prefix="collector.app.happ.hotkey.")
             for reg in (counters, ref_counters)]
    for snap in snaps:
        assert snap["collector.app.happ.hotkey.3.hot"] == 0
        assert snap["collector.app.happ.hotkey.3.device_resident"] == 0
        assert snap["collector.app.happ.hotkey.active_detections"] == 0
    for c in colls:
        c.stop()


def test_hotkey_loop_survives_dead_or_moved_primary():
    """An unreachable node burns the query budget instead of pinning a
    detection; a moved primary abandons the detection (its stop goes to
    the old node); both packages alike."""
    for mod, err in zip(MODS, ERRORS):
        coll = mod.InfoCollector(["x:1"], hotkey_rounds=1,
                                 hotkey_query_limit=2)
        calls = []

        def unreachable(addr, command, args, calls=calls, err=err):
            calls.append(tuple(args))
            if args[2] == "start":
                return "read hotkey detection started (coarse)"
            raise err(7, "connection refused")

        coll.remote_command = unreachable
        for expect in (True, True, False):
            with coll._lock:
                coll.drive_hotkey_loop("dapp", 4, [0], {0: "dead-node:1"})
            assert (("dapp", 0) in coll._detections) is expect
        # the expired detection's stop is tried (and fails) too
        assert calls == [("4.0", "read", "start")] + \
            [("4.0", "read", "query")] * 3 + [("4.0", "read", "stop")]
        coll2 = mod.InfoCollector(["x:1"], hotkey_rounds=1)
        fake = _FakeHotkeyNode(["read detection state: COARSE_DETECTING"])
        coll2.remote_command = fake.remote_command
        with coll2._lock:
            coll2.drive_hotkey_loop("mapp", 6, [0], {0: "node-a:1"})
            assert ("mapp", 0) in coll2._detections
            coll2.drive_hotkey_loop("mapp", 6, [0], {0: "node-b:1"})
        assert ("mapp", 0) not in coll2._detections
        assert fake.calls[-1] == ("node-a:1", ("6.0", "read", "stop"))
        coll.stop()
        coll2.stop()


def test_collector_hotkey_verdict_drives_read_residency():
    """A read verdict turns the partition's residency on; calming turns
    it off, and a dropped release is resent next round."""
    for mod, reg, err in zip(MODS, (counters, ref_counters), ERRORS):
        ic = mod.InfoCollector([], interval_seconds=3600, hotkey_rounds=2)
        calls = []
        fail_next = [False]

        def fake_rc(node, command, args, calls=calls, fail_next=fail_next,
                    err=err):
            if command == "set-read-residency" and fail_next[0]:
                fail_next[0] = False
                raise err(7, "connection refused")
            calls.append((node, command, list(args)))
            if command == "detect_hotkey":
                return {"start": "started", "query": "hotkey: user42",
                        "stop": "stopped"}[args[2]]
            return "read residency %s for %s" % (args[1], args[0])

        ic.remote_command = fake_rc
        primaries = {p: "n1:1" for p in range(4)}
        read_qps = {0: 500.0, 1: 1.0, 2: 1.0, 3: 1.0}
        with ic._lock:
            for _ in range(ic.hotkey_rounds):
                ic.drive_hotkey_loop("t", 7, [0], primaries, read_qps, {})
            assert ("n1:1", "set-read-residency", ["7.0", "on"]) in calls
            assert ("t", 0) in ic.read_residency
            assert reg.number(
                "collector.app.t.hotkey.0.device_resident").value() == 1
            fail_next[0] = True
            ic.drive_hotkey_loop("t", 7, [], primaries, read_qps, {})
            assert ("t", 0) in ic.read_residency    # kept for the retry
            ic.drive_hotkey_loop("t", 7, [], primaries, read_qps, {})
        assert ("n1:1", "set-read-residency", ["7.0", "off"]) in calls
        assert ("t", 0) not in ic.read_residency
        assert reg.number(
            "collector.app.t.hotkey.0.device_resident").value() == 0
        ic.stop()


class _SeededNodes:
    """detect_hotkey and set-read-residency answers drawn from a seeded
    stream; each package's collector gets its own copy of the stream."""

    def __init__(self, seed, err):
        self.rng = np.random.default_rng(seed)
        self.err = err
        self.calls = []

    def remote_command(self, addr, command, args):
        self.calls.append((addr, command, tuple(args)))
        roll = self.rng.random()
        if roll < 0.08:
            raise self.err(7, "connection refused")
        if command == "set-read-residency":
            return f"read residency {args[1]} for {args[0]}"
        action = args[2]
        if action == "start":
            return ("read hotkey detection started (coarse)"
                    if roll < 0.8 else "ERROR: busy")
        if action == "stop":
            return "read hotkey detection stopped"
        if roll < 0.35:
            return f"{args[1]} hotkey: b'k{int(self.rng.integers(0, 9))}'"
        if roll < 0.45:
            return f"{args[1]} detection state: STOPPED (timed out)"
        return f"{args[1]} detection state: COARSE_DETECTING"


@pytest.mark.parametrize("seed", range(4))
def test_seeded_qps_rounds_drive_the_same_loop(seed, frozen):
    """Seeded QPS rounds over two apps with moving primaries: both
    packages' loops send the same commands in the same order and keep
    the same hotspots, verdicts and pins every round."""
    rng = np.random.default_rng(1000 + seed)
    colls = [mod.InfoCollector(["x:1"], hotkey_rounds=2,
                               hotkey_query_limit=3) for mod in MODS]
    nodes = [_SeededNodes(seed, err) for err in ERRORS]
    for c, n in zip(colls, nodes):
        c.remote_command = n.remote_command
    for rnd in range(30):
        frozen.t = 1.7e9 + rnd
        for app, app_id, parts in (("a", 3, 6), ("b", 5, 4)):
            primaries = {p: f"n{int(rng.integers(0, 3))}:1"
                         if rng.random() < 0.15 else f"n{p % 3}:1"
                         for p in range(parts)}
            hot = int(rng.integers(0, parts))
            read = {p: float(rng.integers(0, 20)) for p in range(parts)}
            write = {p: float(rng.integers(0, 20)) for p in range(parts)}
            if rng.random() < 0.7:
                (read if rng.random() < 0.7 else write)[hot] = 900.0
            total = {p: read[p] + write[p] for p in range(parts)}
            flagged = [port_ic.hotspot_partitions(total),
                       ref_ic.hotspot_partitions(total)]
            assert flagged[0] == flagged[1]
            for c in colls:
                c.hotspots[app] = flagged[0]
                with c._lock:
                    c.drive_hotkey_loop(app, app_id, flagged[0], primaries,
                                        read, write)
        assert nodes[0].calls == nodes[1].calls
        assert _loop_state(colls[0]) == _loop_state(colls[1])
    assert any(c[1] == "set-read-residency" for c in nodes[0].calls)
    for c in colls:
        c.stop()


# ------------------------------------------------------------- the SLOs


def test_slo_config_ini_overrides_env_defaults(tmp_path, slo_env):
    slo_env.setenv("PEGASUS_SLO_AVAIL", "0.99")
    slo_env.setenv("PEGASUS_SLO_P99_US", "0")
    cfg = tmp_path / "slo.ini"
    cfg.write_text("[slo]\n"
                   "table.gold.availability = 0.9999\n"
                   "table.gold.p99_us = 5000\n"
                   "table.my.dotted.name.availability = 0.5\n"
                   "table.gold.bogus_field = 1\n"
                   "table.brass.p99_us = not-a-number\n"
                   "notatable.x.availability = 0.1\n")
    slo_env.setenv("PEGASUS_SLO_CONFIG", str(cfg))
    tables = ["gold", "brass", "my.dotted.name"]
    per = port_ic._slo_config(tables)
    assert per == ref_ic._slo_config(tables)
    assert per["gold"] == {"availability": 0.9999, "p99_us": 5000.0}
    assert per["brass"] == {"availability": 0.99, "p99_us": 0.0}
    assert per["my.dotted.name"]["availability"] == 0.5
    slo_env.delenv("PEGASUS_SLO_CONFIG")
    assert port_ic._slo_config(tables)["gold"] == {"availability": 0.99,
                                                   "p99_us": 0.0}


def _fold(rng, tables, ops, errs):
    out = {}
    for t in tables:
        ops[t] += int(rng.integers(0, 400))
        if rng.random() < 0.4:
            errs[t] += int(rng.integers(0, 40))
        out[t] = {"read_qps": ops[t] // 2, "write_qps": ops[t] - ops[t] // 2,
                  "scan_qps": 0, "errors": errs[t],
                  "ops_total": ops[t], "errors_total": errs[t],
                  "read_latency_us": {"p99": int(rng.integers(0, 9000))},
                  "write_latency_us": {"p99": int(rng.integers(0, 9000))}}
    return out


def _window(rng, tables, n):
    samples = []
    acc = {t: [0, 0] for t in tables}
    for i in range(n):
        vals = {}
        for t in tables:
            acc[t][0] += int(rng.integers(0, 500))
            acc[t][1] += int(rng.integers(0, 20))
            if rng.random() < 0.8:
                vals[f"collector.table.{t}.ops_total"] = float(acc[t][0])
                vals[f"collector.table.{t}.errors_total"] = float(acc[t][1])
        samples.append({"ts": 1.7e9 + i, "values": vals})
    return {"samples": samples}


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_slos_equal_the_reference(seed, frozen, slo_env,
                                           monkeypatch):
    """Rounds of seeded table folds, the same `now` and the same
    metric-history window in both packages: equal verdicts (the fast
    window's trim, the slow window's deltas, the latency bound) and equal
    slo.<table>.* gauges."""
    rng = np.random.default_rng(seed)
    slo_env.setenv("PEGASUS_SLO_FAST_S", "30")
    slo_env.setenv("PEGASUS_SLO_P99_US", "4000")
    tables = ["gold", "brass", "t.dot"][: 1 + seed % 3]
    ops = {t: 0 for t in tables}
    errs = {t: 0 for t in tables}
    colls = [mod.InfoCollector(["x:1"]) for mod in MODS]
    window = {}
    for hist in (port_mh.HISTORY, ref_mh.HISTORY):
        monkeypatch.setattr(hist, "window",
                            lambda seconds=None, prefix=None, deltas=False:
                            window)
    for rnd in range(12):
        frozen.t = 1.7e9 + 7 * rnd
        window.clear()
        window.update(_window(rng, tables, int(rng.integers(0, 4))))
        folded = _fold(rng, tables, ops, errs)
        if rnd == 8 and len(tables) > 1:
            folded.pop(tables[-1])       # a dropped table forgets its samples
        got = []
        for c in colls:
            c.table_stats = json.loads(json.dumps(folded))
            got.append(c.evaluate_slos())
        assert _dumps(got[0]) == _dumps(got[1])
        assert port_ic.latest_slo() is got[0]
        for t in folded:
            for g in ("fast_burn", "slow_burn", "verdict"):
                assert counters.number(f"slo.{t}.{g}").value() == \
                    ref_counters.number(f"slo.{t}.{g}").value()
    assert {v["verdict"] for v in got[0].values()} & {"warn", "burning",
                                                       "ok"}
    for c in colls:
        c.stop()


def test_burning_table_is_a_doctor_cause(frozen, slo_env, monkeypatch):
    """gold burns on both windows, brass stays ok: both evaluators say
    so, and the port doctor's _check_slo names gold as the reference's
    does."""
    from pegasus_tpu.collector import cluster_doctor as ref_cd

    for hist in (port_mh.HISTORY, ref_mh.HISTORY):
        monkeypatch.setattr(hist, "window", lambda **kw: {"samples": []})
    colls = [mod.InfoCollector(["x:1"]) for mod in MODS]
    base = {"gold": {"ops_total": 100, "errors_total": 0},
            "brass": {"ops_total": 100, "errors_total": 0}}
    after = {"gold": {"ops_total": 200, "errors_total": 40},
             "brass": {"ops_total": 300, "errors_total": 0}}
    for stats in (base, after):
        frozen.t += 1
        for c in colls:
            c.table_stats = json.loads(json.dumps(stats))
            c.evaluate_slos()
    verdicts = [mod.latest_slo() for mod in MODS]
    assert _dumps(verdicts[0]) == _dumps(verdicts[1])
    assert verdicts[0]["gold"]["verdict"] == "burning"
    assert verdicts[0]["gold"]["errors_fast"] == 40
    assert verdicts[0]["brass"]["verdict"] == "ok"
    causes = []
    for mod in (port_cd, ref_cd):
        c, ev = [], {}
        mod._check_slo(c, ev)
        causes.append(c)
        assert _dumps(ev["slo"]) == _dumps(verdicts[0])
    assert causes[0] == causes[1]
    assert [c["cause"].split(" (")[0] for c in causes[0]] == \
        ["table gold SLO burning"]
    for c in colls:
        c.stop()


# ------------------------------------------- rollups over a live cluster


class _Recording:
    """Wraps the port collector's `_call`: every reply body is kept under
    (addr, code, request bytes), so the reference collector can read the
    same replies (the request bytes are equal across the packages)."""

    def __init__(self, coll):
        self.coll, self.real, self.bodies = coll, coll._call, {}

    def __call__(self, addr, code, req):
        body = self.real(addr, code, req)
        self.bodies[(addr, code, codec.encode(req))] = body
        return body

    def replay(self, ref_coll):
        from pegasus_tpu.rpc import codec as ref_codec

        def call(addr, code, req):
            return self.bodies[(addr, code, ref_codec.encode(req))]

        ref_coll._call = call


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    made = {}

    def get(meta):
        if meta not in made:
            c = Cluster(tmp_path_factory.mktemp(f"c_{meta}"),
                        ref_meta=meta == "reference")
            gold = make_client(c, "gold", partitions=4)
            brass = make_client(c, "brass", partitions=3)
            for i in range(40):
                gold.set(b"g%03d" % i, b"s", b"v%d" % i)
                brass.set(b"b%03d" % i, b"s", b"v%d" % i)
            for i in range(120):
                assert gold.get(b"g007", b"s") == b"v7"
            assert brass.batch_get([(b"b%03d" % i, b"s")
                                    for i in range(40)]) == \
                [b"v%d" % i for i in range(40)]
            gold.close()
            brass.close()
            made[meta] = c
        return made[meta]

    yield get
    for c in made.values():
        c.stop()


@pytest.mark.parametrize("meta", ["port", "reference"])
def test_collect_once_rollups_equal_behind_either_meta(meta, clusters,
                                                       frozen, slo_env,
                                                       monkeypatch):
    c = clusters(meta)
    for hist in (port_mh.HISTORY, ref_mh.HISTORY):
        monkeypatch.setattr(hist, "window", lambda **kw: {"samples": []})
    port_coll = port_ic.InfoCollector([c.meta_addr])
    ref_coll = ref_ic.InfoCollector([c.meta_addr])
    rec = _Recording(port_coll)
    port_coll._call = rec
    rec.replay(ref_coll)
    try:
        got = [port_coll.collect_once(), ref_coll.collect_once()]
        assert _dumps(got[0]) == _dumps(got[1])
        assert set(got[0]) >= {"gold", "brass"}
        assert got[0]["gold"]["get_qps"] > 0
        for attr in ("app_stats", "compact_stats", "lag_stats",
                     "cluster_slow_requests", "table_stats", "table_top",
                     "hotspots"):
            assert _dumps(getattr(port_coll, attr)) == \
                _dumps(getattr(ref_coll, attr)), attr
        assert {"gold", "brass"} <= set(port_coll.table_stats)
        assert _dumps(port_ic.latest_slo()) == _dumps(ref_ic.latest_slo())
        assert port_ic.latest_slo()["gold"]["verdict"] == "ok"
        assert counters.number("collector.app.gold.get_qps").value() == \
            ref_counters.number("collector.app.gold.get_qps").value()
        # every scrape the reference made was one the port made
        assert port_coll._c_scrape_err.total() == 0
    finally:
        port_coll.stop()
        ref_coll.stop()


def test_doctor_names_a_burning_table_on_the_cluster(clusters, frozen,
                                                     slo_env, monkeypatch):
    """The port's evaluator drives the port's doctor: a table burning in
    this process's verdicts is a degraded cause of run_cluster_doctor."""
    c = clusters("port")
    monkeypatch.setattr(port_mh.HISTORY, "window",
                        lambda **kw: {"samples": []})
    coll = port_ic.InfoCollector([c.meta_addr])
    try:
        coll.collect_once()
        folded = json.loads(json.dumps(coll.table_stats))
        folded["brass"] = dict(folded["brass"],
                               ops_total=folded["brass"]["ops_total"] + 100,
                               errors_total=50)
        frozen.t += 1
        coll.table_stats = folded
        verdicts = coll.evaluate_slos()
        assert verdicts["brass"]["verdict"] == "burning"
        assert verdicts["gold"]["verdict"] == "ok"
        report = port_cd.run_cluster_doctor([c.meta_addr], slow_last=0)
        named = [x["cause"] for x in report["causes"] if "SLO" in x["cause"]]
        assert len(named) == 1 and named[0].startswith(
            "table brass SLO burning (")
        assert report["verdict"] != "healthy"
    finally:
        coll.stop()


# ------------------------------------------------------------- reporter


def _snapshot(seed=5) -> dict:
    rng = np.random.default_rng(seed)
    snap = {}
    for i in range(40):
        name = f"app.{i % 3}.{i}.get-qps:x/{i}"
        if i % 5 == 0:
            snap[name] = {q: float(rng.integers(0, 10 ** 6))
                          for q in ("p50", "p90", "p99", "p999")}
        else:
            snap[name] = float(rng.random() * 10 ** int(rng.integers(0, 9)))
    snap["engine.hbm.resident_bytes"] = 123456789.0
    return snap


def test_prometheus_and_falcon_text_equal_the_reference():
    snap = _snapshot()
    assert port_rep.prometheus_text(snap) == ref_rep.prometheus_text(snap)
    assert port_rep.falcon_payload("n1:1", snap) == \
        ref_rep.falcon_payload("n1:1", snap)
    text = port_rep.prometheus_text(snap)
    assert "engine_hbm_resident_bytes 123456789.0\n" in text
    assert "# TYPE app_0_0_get_qps:x_0_p99 gauge\n" in text
    assert list(port_rep._flatten(snap)) == list(ref_rep._flatten(snap))


def _get(addr, path):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=30) as r:
        return r.status, r.read()


def test_reporter_serves_the_collector_routes(clusters, frozen, slo_env,
                                              monkeypatch):
    """A port CounterReporter with the meta's and the collector's routes:
    /metrics (Prometheus text), /slo, /tables, /health/cluster, /jobs,
    /metrics/history, a 404 and a route that raises."""
    from pegasus_tpu_torch.runtime import service_app as sa

    c = clusters("port")
    monkeypatch.setattr(port_mh.HISTORY, "window",
                        lambda **kw: {"samples": [], "patched": True})
    coll = port_ic.InfoCollector([c.meta_addr])
    coll.collect_once()
    routes = dict(sa._meta_http_routes(c.meta))
    routes["/health/cluster"] = sa._health_cluster_route([c.meta_addr])
    routes["/boom"] = lambda p: 1 / 0
    rep = port_rep.CounterReporter(port=0, routes=routes).start()
    try:
        counters.number("engine.hbm.resident_bytes")   # registered
        status, body = _get(rep.address, "/metrics")
        assert status == 200
        assert b"collector_app_gold_get_qps " in body
        assert b"# TYPE engine_hbm_resident_bytes gauge" in body
        slo = json.loads(_get(rep.address, "/slo")[1])
        assert slo["slo"]["gold"]["verdict"] == "ok"
        tables = json.loads(_get(rep.address, "/tables")[1])
        assert {"gold", "brass"} <= set(tables["tables"])
        assert tables["top"] == json.loads(json.dumps(
            sa._tables_meta_route(c.meta)("/tables")["top"]))
        health = json.loads(_get(rep.address, "/health/cluster?scrape=0")[1])
        assert health["verdict"] in ("healthy", "degraded")
        assert "nodes" in health["evidence"]
        jobs = json.loads(_get(rep.address, "/jobs?last=5&active=0")[1])
        assert isinstance(jobs["jobs"], list)
        hist = json.loads(_get(rep.address,
                               "/metrics/history?seconds=60")[1])
        assert hist["patched"] is True
        info = json.loads(_get(rep.address, "/meta/app?name=gold")[1])
        assert info["partition_count"] == 4
        counters_json = json.loads(_get(rep.address, "/counters")[1])
        assert "collector.app.gold.get_qps" in counters_json
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(rep.address, "/nope")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(rep.address, "/boom")
        assert e.value.code == 500
    finally:
        rep.stop()
        coll.stop()


def test_pipeline_counters_reach_metrics_surface():
    """The pipeline's counters (the port exports its stage spans as
    compact.stage.pipeline.*) appear in the Prometheus rendering after a
    pipelined run: one process-wide registry behind every surface."""
    import time

    from pegasus_tpu_torch.ops.pipeline import CompactPipeline

    CompactPipeline(depth=2).map(
        [1, 2, 3], lambda x: time.sleep(0.02) or x, lambda i, p: p,
        lambda i, d: d)
    text = port_rep.prometheus_text()
    assert "compact_stage_pipeline_stall_count" in text
    assert "compact_stage_pipeline_stall_duration_us_p99" in text


# ---------------------------------------------------------------- wire


def test_collector_info_and_slo_status_equal_the_reference(tmp_path,
                                                           frozen, slo_env):
    """collector-info and slo-status of an unstarted collector role of
    each package (its meta a dead address): the same JSON."""
    from pegasus_tpu.runtime.config import Config as RefConfig
    from pegasus_tpu.runtime.remote_command import \
        RemoteCommandService as RefCommands
    from pegasus_tpu.runtime.service_app import CollectorApp as RefApp
    from pegasus_tpu_torch.runtime.config import Config
    from pegasus_tpu_torch.runtime.remote_command import RemoteCommandService
    from pegasus_tpu_torch.runtime.service_app import CollectorApp

    ini = ("[apps.collector]\ntype = collector\nport = 0\n"
           "[pegasus.server]\nmeta_servers = 127.0.0.1:1\n")
    apps = [CollectorApp("collector", Config(text=ini), "apps.collector"),
            RefApp("collector", RefConfig(text=ini), "apps.collector")]
    try:
        for app in apps:
            app.collector.hotspots = {"t": [1]}
            app.collector.app_stats = {"t": {"get_qps": 2.5}}
            app.collector.lag_stats = {"apply_gap_max": {
                "value": 1.0, "node": "n:1", "name": "x"}}
        infos = [json.loads(a.commands.invoke("collector-info", []))
                 for a in apps]
        assert _dumps(infos[0]) == _dumps(infos[1])
        assert sorted(infos[0]) == [
            "app_stats", "availability", "compact_sched", "compact_stats",
            "hotkeys", "hotspots", "lag_stats", "slow_requests"]
        assert apps[0].commands.invoke("compact-sched-status", []) == \
            apps[1].commands.invoke("compact-sched-status", [])
        assert "trigger-incident" not in apps[0].commands.invoke("help", [])
    finally:
        apps[0].rpc.stop()
        apps[1].rpc._srv.server_close()  # never served: stop() would wait
        for a in apps:
            a.collector.stop()
    for mod in MODS:
        mod._SLO_LATEST = {"gold": {"verdict": "burning", "fast_burn": 3.0}}
    got = []
    for cls in (RemoteCommandService, RefCommands):
        svc = cls()
        svc.register_defaults(node_kind="replica")
        got.append(svc.invoke("slo-status", []))
    assert got[0] == got[1]
    assert json.loads(got[0]) == {f"pid:{os.getpid()}": {
        "gold": {"verdict": "burning", "fast_burn": 3.0}}}
