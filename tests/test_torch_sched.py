"""The compaction scheduler (pegasus_tpu_torch.collector.compact_scheduler)
and its engine and stub halves against pegasus_tpu's, in one process.

- The pure folds (fold_decisions, localize_decisions, assign_placements,
  tune_knobs, stage_cost_us) give byte-equal JSON in both packages on
  seeded inputs, and the reference's named cases hold in the port.
- A port and a reference engine under the same token sequence keep the
  same L0 counts, policies and state digests: defer holds then expires,
  the ceiling overrides defer, urgent fires at trigger // 2, no token is
  the plain trigger; the device gate, its cap lease, the maintenance
  poke, the manual-compact queue jump and the debt throttle's slopes.
- A wedged or crashed tick (`compact.sched`) never blocks compaction.
- On the port's in-process cluster with tiny memtables: both packages'
  ticks decide the same, and each package's tick delivered to the other
  package's nodes installs the same tokens; the shell's compact_sched
  prints the reference shell's lines.
"""

import io
import json
import re
import threading
import time

import numpy as np
import pytest

from pegasus_tpu.collector import compact_scheduler as ref_cs
from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine import db as ref_db
from pegasus_tpu.engine import throttling as ref_th
from pegasus_tpu_torch.collector import compact_scheduler as port_cs
from pegasus_tpu_torch.collector.cluster_doctor import ClusterCaller
from pegasus_tpu_torch.engine import db as port_db
from pegasus_tpu_torch.engine import throttling as port_th
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.runtime import fail_points as port_fp
from pegasus_tpu_torch.runtime.perf_counters import counters
from tests.test_torch_cluster import Cluster, make_client

KNOBS = {"urgent_l0": 4, "backlog_urgent": 64, "max_urgent_per_node": 2,
         "max_device": 0, "ttl_s": 30.0}
NODES = ["a:1", "b:1", "c:1", "d:1", "e:1"]


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


def _part(node="n1:1", l0=0, debt=0, gap=0, ceiling=12):
    return {"node": node, "l0_files": l0, "debt_bytes": debt,
            "apply_gap": gap, "ceiling_files": ceiling,
            "pending_installs": 0}


# ------------------------------------------------------------ pure folds


def _random_inputs(rng):
    parts = {}
    for i in range(int(rng.integers(1, 24))):
        parts[f"{1 + i % 3}.{i}"] = _part(
            node=str(rng.choice(NODES)), l0=int(rng.integers(0, 16)),
            debt=int(rng.integers(0, 4)) * 1000,
            gap=int(rng.integers(0, 200)),
            ceiling=int(rng.choice([0, 8, 12])))
    gpids = sorted(parts)
    hot = {g for g in gpids if rng.random() < 0.3}
    knobs = dict(KNOBS, urgent_l0=int(rng.integers(1, 8)),
                 backlog_urgent=int(rng.integers(8, 128)),
                 max_urgent_per_node=int(rng.integers(0, 4)))
    places = ({f"svc{i}:1": int(rng.integers(0, 4))
               for i in range(int(rng.integers(1, 4)))}
              if rng.random() < 0.6 else None)
    weights = {g: int(rng.integers(1, 4)) for g in gpids}
    hosts = {g: sorted(set(rng.choice(NODES, 3))) for g in gpids}
    return parts, hot, knobs, places, weights, hosts


@pytest.mark.parametrize("seed", range(8))
def test_fold_and_localize_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    parts, hot, knobs, places, weights, hosts = _random_inputs(rng)
    slow = int(rng.integers(0, 3))
    dec = [mod.fold_decisions(json.loads(json.dumps(parts)), hot=hot,
                              slow_count=slow, knobs=knobs, places=places,
                              weights=weights)
           for mod in (port_cs, ref_cs)]
    assert _dumps(dec[0]) == _dumps(dec[1])
    for node in NODES:
        breaker = bool(rng.random() < 0.3)
        cap = int(rng.integers(0, 3))
        got = [mod.localize_decisions(dec[0], hosts, node,
                                      breaker_open=breaker, cap=cap)
               for mod in (port_cs, ref_cs)]
        assert _dumps(got[0]) == _dumps(got[1])


@pytest.mark.parametrize("seed", range(4))
def test_assign_placements_and_tuner_equal_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    parts, _, knobs, places, weights, _ = _random_inputs(rng)
    base = port_cs.fold_decisions(parts, knobs=knobs)
    for d in base.values():
        d.pop("where")
    places = places or {"svc:1": 3}
    got = [mod.assign_placements(json.loads(json.dumps(base)), places,
                                 weights=weights)
           for mod in (port_cs, ref_cs)]
    assert _dumps(got[0]) == _dumps(got[1])
    window = {"samples": [{"ts": i, "values": {
        k: float(rng.integers(0, 3_000_000))
        for k in port_cs._STAGE_SERIES if rng.random() < 0.7}}
        for i in range(int(rng.integers(0, 5)))]}
    assert port_cs.stage_cost_us(window) == ref_cs.stage_cost_us(window)
    full = dict(port_cs._knobs(), **knobs)
    for ewma in (0.0, 100_000.0, 1e6, port_cs.stage_cost_us(window)):
        assert _dumps(port_cs.tune_knobs(ewma, full)) == \
            _dumps(ref_cs.tune_knobs(ewma, full))


def test_fold_hot_read_partition_deferred():
    out = port_cs.fold_decisions({"1.0": _part(l0=5), "1.1": _part(l0=0)},
                                 hot={"1.0"}, knobs=KNOBS)
    assert out["1.0"]["policy"] == "defer"
    assert out["1.0"]["reasons"] == ["hot_read"]
    assert out["1.1"]["policy"] == "normal"


def test_fold_backlogged_partition_promoted():
    parts = {"1.0": _part(gap=100), "1.1": _part(gap=10)}
    out = port_cs.fold_decisions(parts, slow_count=3, knobs=KNOBS)
    assert out["1.0"]["policy"] == "urgent"
    assert out["1.0"]["reasons"] == ["apply_backlog", "slow_requests"]
    assert out["1.1"]["policy"] == "normal"
    out = port_cs.fold_decisions(parts, slow_count=0, knobs=KNOBS)
    assert out["1.0"]["reasons"] == ["apply_backlog"]


def test_fold_debt_ceiling_overrides_defer_and_breaker():
    out = port_cs.fold_decisions({"1.0": _part(node="bad:1", l0=12)},
                                 hot={"1.0"}, knobs=KNOBS)
    assert out["1.0"]["policy"] == "urgent"
    assert out["1.0"]["reasons"] == ["debt_ceiling"]
    mine = port_cs.localize_decisions(out, {"1.0": ["bad:1"]}, "bad:1",
                                      breaker_open=True, cap=1)
    assert mine["1.0"]["policy"] == "urgent"


def test_breaker_open_receiver_is_never_promoted():
    parts = {"1.0": _part(node="bad:1", l0=6, gap=999),
             "1.1": _part(node="ok:1", l0=6)}
    out = port_cs.fold_decisions(parts, slow_count=1, knobs=KNOBS)
    hosts = {"1.0": ["bad:1", "ok:1"], "1.1": ["ok:1"]}
    on_bad = port_cs.localize_decisions(out, hosts, "bad:1",
                                        breaker_open=True, cap=2)
    on_ok = port_cs.localize_decisions(out, hosts, "ok:1", cap=2)
    assert on_bad["1.0"]["policy"] == "normal"
    assert "breaker_open" in on_bad["1.0"]["reasons"]
    assert on_ok["1.0"]["policy"] == on_ok["1.1"]["policy"] == "urgent"


def test_localize_applies_the_urgent_cap_per_receiver():
    parts = {f"1.{i}": _part(node=f"p{i}:1", l0=6, debt=600 - i)
             for i in range(4)}
    parts["1.9"] = _part(node="p9:1", l0=12)       # a ceiling urgent
    decisions = port_cs.fold_decisions(
        parts, knobs=dict(KNOBS, max_urgent_per_node=8))
    assert all("node_cap" not in d["reasons"] for d in decisions.values())
    mine = port_cs.localize_decisions(decisions, {g: ["sec:1"]
                                                  for g in parts},
                                      "sec:1", cap=2)
    urgents = [g for g, d in mine.items() if d["policy"] == "urgent"]
    assert "1.9" in urgents and len(urgents) == 3
    assert len([g for g, d in mine.items()
                if "node_cap" in d["reasons"]]) == 2
    assert mine["1.0"]["policy"] == "urgent"       # the highest debt kept


def test_localize_defer_lands_on_the_primary_only():
    decisions = port_cs.fold_decisions({"1.0": _part(node="prim:1", l0=3)},
                                       hot={"1.0"}, knobs=KNOBS)
    hosts = {"1.0": ["prim:1", "sec:1"]}
    assert port_cs.localize_decisions(decisions, hosts, "prim:1")["1.0"][
        "policy"] == "defer"
    on_sec = port_cs.localize_decisions(decisions, hosts, "sec:1")
    assert on_sec["1.0"]["policy"] == "normal"
    assert "defer_primary_only" in on_sec["1.0"]["reasons"]


# ---------------------------------------------------------- engine halves


def _key(i):
    from pegasus_tpu_torch.base.key_schema import generate_key

    return generate_key(b"hk%04d" % i, b"s")


class _Pair:
    """A port and a reference engine driven in lockstep."""

    def __init__(self, tmp_path, trigger=2, name="e"):
        self.port = port_db.LsmEngine(
            str(tmp_path / f"{name}.port"),
            EngineOptions(backend="cpu", device="cpu", memtable_bytes=1,
                          l0_compaction_trigger=trigger))
        self.ref = ref_db.LsmEngine(
            str(tmp_path / f"{name}.ref"),
            RefOptions(backend="cpu", memtable_bytes=1,
                       l0_compaction_trigger=trigger))
        self.both = (self.port, self.ref)

    def flush_one(self, i) -> int:
        for e in self.both:
            e.put(_key(i), b"v" * 32)
            e.flush()
        return self.l0()

    def l0(self) -> int:
        port, ref = (e.stats()["l0_files"] for e in self.both)
        assert port == ref
        return port

    def policy(self) -> tuple:
        port, ref = (e.compact_policy() for e in self.both)
        assert port[:2] == ref[:2] and (port[2] > 0) == (ref[2] > 0)
        return port

    def token(self, *args, **kw):
        for e in self.both:
            e.set_compact_policy(*args, **kw)

    def digest(self) -> str:
        port, ref = (e.state_digest(now=1)["digest"] for e in self.both)
        assert port == ref
        return port

    def close(self):
        for e in self.both:
            e.close()


def _rate(name) -> int:
    """A rate counter's monotone total (its window rolls on reads)."""
    return counters.rate(name).total()


def test_engine_defer_token_holds_the_trigger_and_expires(tmp_path):
    p = _Pair(tmp_path, trigger=2)
    c0 = _rate("engine.compact.sched.deferred_count")
    p.token("defer", reasons=["hot_read"], ttl_s=60)
    assert [p.flush_one(i) for i in range(3)] == [1, 2, 3]
    assert _rate("engine.compact.sched.deferred_count") > c0
    policy, reasons, expires_in = p.policy()
    assert policy == "defer" and reasons == ["hot_read"] and expires_in > 0
    p.token("defer", ttl_s=0.05)
    time.sleep(0.1)
    assert p.policy() == ("normal", [], 0.0)
    assert p.flush_one(99) <= 1
    p.digest()
    p.close()


def test_engine_debt_ceiling_overrides_defer(tmp_path, monkeypatch):
    monkeypatch.setenv("PEGASUS_SCHED_DEBT_CEILING_FILES", "4")
    p = _Pair(tmp_path, trigger=2)
    c0 = _rate("engine.compact.sched.ceiling_override_count")
    p.token("defer", ttl_s=60)
    assert [p.flush_one(i) for i in range(4)][-1] <= 1
    assert _rate("engine.compact.sched.ceiling_override_count") > c0
    assert p.port.compaction_debt()["ceiling_files"] == 4
    p.digest()
    p.close()


def test_engine_urgent_fires_at_half_the_trigger(tmp_path):
    p = _Pair(tmp_path, trigger=4)
    c0 = _rate("engine.compact.sched.urgent_count")
    p.token("urgent", reasons=["l0_debt"], ttl_s=60)
    assert [p.flush_one(i) for i in range(2)] == [1, 0]
    assert _rate("engine.compact.sched.urgent_count") > c0
    p.digest()
    p.close()


def test_engine_bad_policy_rejected(tmp_path):
    p = _Pair(tmp_path)
    for e in p.both:
        with pytest.raises(ValueError):
            e.set_compact_policy("yolo")
    p.close()


def _sst_bytes(path) -> list:
    import os

    return [open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".sst")]


def test_engine_without_token_writes_the_reference_bytes(tmp_path):
    """No token, the gate at its default: the plain L0 trigger, the same
    L0 counts and SST bytes as the reference; an engine whose defer token
    lapsed converges to the same digest and reads."""
    a = _Pair(tmp_path, trigger=2, name="a")
    b = _Pair(tmp_path, trigger=2, name="b")
    # the lease outlives the rounds however slow the host is, and lapses
    # for both of b's engines at one round boundary: a wall-clock lease
    # that ran out between b's port and reference flush split their L0
    b.token("defer", ttl_s=60)
    rows = [(_key(i), b"val%d" % i) for i in range(40)]
    for i, (k, v) in enumerate(rows):
        for e in a.both + b.both:
            e.put(k, v)
        if i % 8 == 7:
            for e in a.both + b.both:
                e.flush()
            a.l0()
            b.l0()
    b.token("defer", ttl_s=0)
    for e in a.both + b.both:
        e.flush()
    for e in b.both:
        e._maybe_trigger_l0()
    assert a.digest() == b.digest()
    assert _sst_bytes(a.port.path) == _sst_bytes(a.ref.path)
    for k, v in rows:
        assert a.port.get(k) == v and b.port.get(k) == v
    a.close()
    b.close()


def test_device_gate_defers_the_elective_trigger(tmp_path):
    """At the node's device cap a cuda engine's elective trigger holds
    (counted), as a tpu engine's does in the reference; cap 0 releases."""
    p = _Pair(tmp_path, trigger=2)
    c0 = _rate("engine.compact.sched.gate_deferred_count")
    p.flush_one(0)
    p.token("defer", ttl_s=60)
    assert p.flush_one(1) == 2
    p.token("normal", ttl_s=60)
    gates = (port_db.SCHED_GATE, ref_db.SCHED_GATE)
    try:
        for gate in gates:
            gate.set_max(1)
            gate.enter()
        p.port.opts.backend, p.ref.opts.backend = "cuda", "tpu"
        for e in p.both:
            assert e._maybe_trigger_l0() is False
        assert p.l0() == 2
        assert _rate("engine.compact.sched.gate_deferred_count") > c0
        assert port_db.SCHED_GATE.state() == ref_db.SCHED_GATE.state() == \
            {"max": 1, "default": 0, "running": 1}
    finally:
        for gate in gates:
            gate.exit()
            gate.set_max(0)
        p.port.opts.backend = p.ref.opts.backend = "cpu"
    for e in p.both:
        assert e.poke_compaction() is True
    assert p.l0() == 0
    p.digest()
    p.close()


def test_device_gate_cap_lease_expires_to_default():
    gate = port_db.SCHED_GATE
    assert gate.state()["max"] == gate.state()["default"] == 0
    gate.enter()
    try:
        gate.set_max(1, ttl_s=0.05)
        assert gate.at_cap()
        time.sleep(0.1)
        assert not gate.at_cap() and gate.state()["max"] == 0
        gate.set_max(3)     # a set without a ttl leases too
        assert gate._max_expire is not None
    finally:
        gate.exit()
        gate.set_max(0)


def test_poke_compaction_retries_after_token_lapse(tmp_path):
    p = _Pair(tmp_path, trigger=2)
    p.token("defer", ttl_s=60)
    assert [p.flush_one(i) for i in range(3)][-1] == 3
    p.token("defer", ttl_s=0.05)
    time.sleep(0.1)
    for e in p.both:
        assert e.poke_compaction() is True
    assert p.l0() == 0
    p.digest()
    p.close()


def test_manual_compact_urgent_jumps_the_queue(tmp_path):
    from pegasus_tpu_torch.base import consts
    from pegasus_tpu_torch.engine.manual_compact_service import GATE
    from pegasus_tpu_torch.engine.server_impl import PegasusServer

    srv = PegasusServer(str(tmp_path / "mc"), app_id=7, pidx=0,
                        options=EngineOptions(device="cpu"))
    srv.engine.put(_key(0), b"v")
    envs = {consts.MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY: "1",
            consts.MANUAL_COMPACT_MAX_CONCURRENT_RUNNING_COUNT_KEY: "1"}
    svc = srv.manual_compact_service
    svc.set_mock_now(10)
    assert GATE.try_acquire(0)  # an unrelated running compaction
    try:
        assert svc.start_manual_compact_if_needed(dict(envs)) is False
        srv.engine.set_compact_policy("urgent", ttl_s=60)
        c0 = _rate("manual_compact.queue_jump_count")
        assert svc.start_manual_compact_if_needed(dict(envs)) is True
        assert _rate("manual_compact.queue_jump_count") > c0
    finally:
        GATE.release()
    srv.close()


class _RatioEngine:
    def __init__(self, ratio, policy="normal"):
        self.ratio = ratio
        self.policy = policy

    def compact_debt_ratio(self):
        return self.ratio

    def compact_policy_fast(self):
        return self.policy


@pytest.mark.parametrize("env,steps,want", [
    ({"PEGASUS_SCHED_THROTTLE_SOFT": "0.5",
      "PEGASUS_SCHED_THROTTLE_MAX_MS": "10",
      "PEGASUS_SCHED_THROTTLE_REJECT": "2.0"},
     [(0.25, "normal"), (0.75, "normal"), (2.5, "normal")], (1, 1)),
    ({"PEGASUS_SCHED_THROTTLE_SOFT": "0.5",
      "PEGASUS_SCHED_THROTTLE_MAX_MS": "1"},
     [(0.75, "defer"), (0.9, "defer"), (0.75, "normal")], (2, 0)),
    ({"PEGASUS_SCHED_THROTTLE": "0"}, [(5.0, "normal")], (0, 0)),
    ({"PEGASUS_SCHED_THROTTLE_MAX_MS": "1"}, [(5.0, "normal")], (1, 0)),
], ids=["slope_and_reject", "defer_frees_the_slope", "disabled",
        "default_never_rejects"])
def test_debt_throttle_equals_the_reference(monkeypatch, env, steps, want):
    """The same ratios and tokens through both packages' throttles: the
    same delays, rejects and counts. Under a defer token the slope starts
    at 7/8 of the ceiling; without one, at the soft ratio."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for mod in (port_th, ref_th):
        eng = _RatioEngine(0.0)
        th = mod.DebtThrottle(eng)
        out = []
        for ratio, policy in steps:
            eng.ratio, eng.policy = ratio, policy
            try:
                out.append(round(th.consume(), 6))
            except mod.ThrottleReject:
                out.append("reject")
        got.append((out, th.delayed_count, th.rejected_count))
    assert got[0] == got[1]
    assert got[0][1:] == want


def test_debt_throttle_engages_before_the_stall(tmp_path, monkeypatch):
    monkeypatch.setenv("PEGASUS_SCHED_THROTTLE_SOFT", "0.25")
    monkeypatch.setenv("PEGASUS_SCHED_THROTTLE_MAX_MS", "2")
    eng = port_db.LsmEngine(str(tmp_path / "e"), EngineOptions(
        backend="cpu", device="cpu", memtable_bytes=1,
        l0_compaction_trigger=64))  # ceiling 192: no inline compaction
    th = port_th.DebtThrottle(eng)
    c0 = _rate("engine.throttle.debt_delay_count")
    for i in range(80):
        th.consume()
        eng.put(_key(i), b"v" * 32)
        eng.flush()
    assert th.delayed_count > 0 and th.rejected_count == 0
    assert _rate("engine.throttle.debt_delay_count") > c0
    assert eng.get(_key(0)) == b"v" * 32
    eng.close()


# ------------------------------------------------------------- chaos


@pytest.fixture
def failpoints():
    port_fp.setup()
    yield port_fp
    port_fp.teardown()


def test_wedged_tick_never_blocks_compaction(tmp_path, failpoints):
    failpoints.cfg("compact.sched", "sleep(1500)")
    done, result = threading.Event(), {}

    def tick():
        result["r"] = port_cs.run_scheduler_tick(["127.0.0.1:1"])
        done.set()

    t = threading.Thread(target=tick, daemon=True)
    t0 = time.monotonic()
    t.start()
    eng = port_db.LsmEngine(str(tmp_path / "e"), EngineOptions(
        backend="cpu", device="cpu", memtable_bytes=1,
        l0_compaction_trigger=2))
    eng.set_compact_policy("defer", ttl_s=0.2)
    time.sleep(0.25)
    for i in range(3):
        eng.put(_key(i), b"v" * 32)
        eng.flush()
    assert eng.stats()["l0_files"] <= 1
    eng.close()
    assert done.wait(30)
    assert time.monotonic() - t0 >= 1.0
    assert result["r"]["errors"] == ["no meta reachable"]


def test_crashed_tick_loop_survives(failpoints):
    from pegasus_tpu_torch.runtime.fail_points import FailPointError

    failpoints.cfg("compact.sched", "raise(sched-chaos)")
    with pytest.raises(FailPointError):
        port_cs.run_scheduler_tick(["127.0.0.1:1"])
    c0 = _rate("sched.tick_errors")
    sched = port_cs.CompactScheduler(["127.0.0.1:1"], interval_seconds=0.05)
    sched.start()
    try:
        deadline = time.monotonic() + 10
        while _rate("sched.tick_errors") <= c0:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert sched._thread.is_alive() and sched.status() == {}
    finally:
        sched.stop()
    assert not sched._thread.is_alive()


# --------------------------------------------------------- on a cluster

DEBT = {"memtable_bytes": 512, "l0_compaction_trigger": 32}
TICK_KNOBS = {"urgent_l0": 2, "max_urgent_per_node": 8, "ttl_s": 30.0,
              "max_device": 2}


def _settled_state(caller, min_l0=2, deadline_s=20.0) -> dict:
    """The snapshot once the beacons carry debt and two reads in a row
    hold the same replica states (both packages then fold one input)."""
    deadline = time.monotonic() + deadline_s
    last = None
    while time.monotonic() < deadline:
        state = caller.meta_state()
        rs = state["replica_states"] if state else {}
        l0 = [st.get("compact", {}).get("l0_files", 0)
              for s in rs.values() for st in s.values()]
        if l0 and max(l0) >= min_l0 and rs == last:
            return state
        last = rs
        time.sleep(0.3)
    raise AssertionError("beacons never settled on compaction debt")


def _statuses(caller, nodes) -> dict:
    out = {}
    for node in nodes:
        for gpid, st in json.loads(caller.remote_command(
                node, "compact-sched-status", [])).items():
            out[(node, gpid)] = (st["policy"], st["reasons"], st["offload"],
                                 st["expires_in_s"] > 0)
    return out


def _load(cluster, app, n=160):
    cli = make_client(cluster, app, partitions=4)
    for i in range(n):
        cli.set(b"user%05d" % i, b"f0", b"v" * 64)
    return cli


def test_ticks_decide_and_deliver_alike_across_packages(tmp_path):
    """One reference node and two port nodes behind the port's meta: the
    two packages' ticks decide the same from its snapshot, and each one
    delivered (to the other package's nodes too) installs the same
    tokens and device cap."""
    c = Cluster(tmp_path, kinds=("reference", "port", "port"),
                options=DEBT)
    caller = ClusterCaller([c.meta_addr])
    try:
        cli = _load(c, "sched")
        state = _settled_state(caller)
        app = state["apps"]["sched"]
        gpids = sorted(f"{app['app_id']}.{pc['pidx']}"
                       for pc in app["partitions"])
        hot = gpids[1]
        decided = [mod.run_scheduler_tick([c.meta_addr], hot_gpids={hot},
                                          knobs=TICK_KNOBS, deliver=False)
                   for mod in (port_cs, ref_cs)]
        assert _dumps(decided[0]) == _dumps(decided[1])
        assert decided[0]["decisions"][hot]["policy"] == "defer"
        assert any(d["policy"] == "urgent"
                   for d in decided[0]["decisions"].values())
        installed = []
        for mod in (ref_cs, port_cs):
            rep = mod.run_scheduler_tick([c.meta_addr], hot_gpids={hot},
                                         knobs=TICK_KNOBS)
            assert rep["errors"] == [] and len(rep["delivered"]) == 3
            installed.append(_statuses(caller, c.nodes))
            assert port_db.SCHED_GATE.state()["max"] == 2
            assert ref_db.SCHED_GATE.state()["max"] == 2
            port_db.SCHED_GATE.set_max(0)
            ref_db.SCHED_GATE.set_max(0)
        assert installed[0] == installed[1]
        assert len(installed[0]) == 3 * len(gpids)
        prim = decided[0]["decisions"][hot]["node"]
        for (node, gpid), (policy, reasons, _, _) in installed[0].items():
            if gpid == hot:
                assert policy == ("defer" if node == prim else "normal")
                if node != prim:
                    assert "defer_primary_only" in reasons
        cli.close()
    finally:
        port_db.SCHED_GATE.set_max(0)
        ref_db.SCHED_GATE.set_max(0)
        caller.close()
        c.stop()


def _hashkeys(cli, n_parts) -> dict:
    """{pidx: a hash key that routes to it}."""
    from pegasus_tpu_torch.base.key_schema import generate_key

    out, i = {}, 0
    while len(out) < n_parts:
        hk = b"sched-%d" % i
        out.setdefault(cli._route(generate_key(hk, b"s"))[0], hk)
        i += 1
    return out


def test_tokens_change_what_the_port_nodes_compact(tmp_path):
    """The port's tick on a port cluster: the debt gauges are exported,
    urgent partitions compact at trigger // 2 on their next flush, the
    deferred primary holds its L0 past the trigger (its secondaries,
    `normal`, compact at it), and a second tick without the hot set
    lifts the defer so the maintenance poke compacts it."""
    c = Cluster(tmp_path, options={"memtable_bytes": 1 << 20,
                                   "l0_compaction_trigger": 4})
    caller = ClusterCaller([c.meta_addr])
    try:
        cli = make_client(c, "sched", partitions=4)
        app_id = cli.resolver.app_id
        gpids = [f"{app_id}.{p}" for p in range(4)]
        hot, urgent = gpids[0], gpids[1:]
        hks = _hashkeys(cli, 4)

        def flush_round(i):
            for p in range(4):
                cli.set(hks[p], b"s%d" % i, b"v")
                pc = c.meta._parts[app_id][p]
                c.replica(pc.primary, app_id, p).broadcast_commit_point()
            for node in c.nodes:
                caller.remote_command(node, "flush-memtable", [])

        def l0(node, gpid):
            return json.loads(caller.remote_command(
                node, "compact-sched-status", [gpid]))[gpid]["l0_files"]

        flush_round(0)
        _settled_state(caller, min_l0=1)
        u0 = _rate("engine.compact.sched.urgent_count")
        d0 = _rate("engine.compact.sched.deferred_count")
        knobs = dict(TICK_KNOBS, urgent_l0=1, max_device=0)
        rep = port_cs.run_scheduler_tick([c.meta_addr], hot_gpids={hot},
                                         knobs=knobs)
        assert rep["errors"] == [] and len(rep["delivered"]) == 3
        assert {g: rep["decisions"][g]["policy"] for g in gpids} == \
            dict({hot: "defer"}, **{g: "urgent" for g in urgent})
        prim = rep["decisions"][hot]["node"]
        flush_round(1)   # L0 = 2 = trigger // 2: every urgent replica
        assert all(l0(n, g) == 0 for n in c.nodes for g in urgent)
        assert _rate("engine.compact.sched.urgent_count") - u0 == 9
        snap = json.loads(caller.remote_command(
            prim, "perf-counters-by-prefix", ["engine.compact."]))
        assert f"engine.compact.{hot}.l0_files" in snap
        flush_round(2)
        flush_round(3)   # the hot primary at the trigger, held
        assert l0(prim, hot) == 4
        assert _rate("engine.compact.sched.deferred_count") > d0
        assert all(l0(n, hot) == 0 for n in c.nodes if n != prim)
        rep = port_cs.run_scheduler_tick([c.meta_addr], knobs=knobs)
        assert rep["errors"] == []
        assert rep["decisions"][hot]["policy"] != "defer"
        engine = c.replica(prim, app_id, 0).server.engine
        assert engine.compact_policy()[0] != "defer"
        assert engine.poke_compaction() is True
        assert l0(prim, hot) == 0
        for i in range(4):
            for p in range(4):
                assert cli.get(hks[p], b"s%d" % i) == b"v"
        cli.close()
    finally:
        caller.close()
        c.stop()


def test_shell_compact_sched_prints_the_reference_lines(tmp_path):
    from pegasus_tpu.shell.main import Shell as RefShell
    from pegasus_tpu_torch.shell.main import NOT_PORTED, Shell

    assert "compact_sched" not in NOT_PORTED
    c = Cluster(tmp_path, options=DEBT)
    caller = ClusterCaller([c.meta_addr])
    try:
        cli = _load(c, "shsched", n=80)
        _settled_state(caller)
        rep = port_cs.run_scheduler_tick(
            [c.meta_addr], hot_gpids={f"{cli.resolver.app_id}.0"},
            knobs=dict(TICK_KNOBS, max_device=0))
        assert rep["errors"] == []
        lines = []
        for cls in (Shell, RefShell):
            out = io.StringIO()
            sh = cls([c.meta_addr], out=out)
            try:
                sh.run_line("compact_sched")
            finally:
                sh.pool.close()
            lines.append(re.sub(r"expires_in=[0-9.]+s", "expires_in=Ts",
                                out.getvalue()).splitlines())
        assert lines[0] == lines[1]
        text = "\n".join(lines[0])
        assert "hot_read" in text and "defer" in text and "urgent" in text
        assert len([ln for ln in lines[0] if ln.startswith("  ")]) == 12
        cli.close()
    finally:
        caller.close()
        c.stop()


def test_maintenance_tick_pokes_at_most_one_compaction(tmp_path):
    """The stub's maintenance loop retries held L0 triggers after its
    per-replica work, and stops at the first poke that compacted: one
    merge per tick, so a long merge never stalls every sibling."""
    import types

    from pegasus_tpu_torch.replication.replica_stub import ReplicaStub

    engines = []
    for name in ("a", "b"):
        eng = port_db.LsmEngine(str(tmp_path / name), EngineOptions(
            backend="cpu", device="cpu", memtable_bytes=1,
            l0_compaction_trigger=2))
        eng.set_compact_policy("defer", ttl_s=60)
        for i in range(3):
            eng.put(_key(i), b"v" * 32)
            eng.flush()
        eng.set_compact_policy("defer", ttl_s=0.01)
        engines.append(eng)
    time.sleep(0.05)  # both defer tokens lapse: both triggers are due

    def replica(eng, name):
        svc = types.SimpleNamespace(
            start_manual_compact_if_needed=lambda envs: False)
        return types.SimpleNamespace(
            name=name, gc_log=lambda: None,
            server=types.SimpleNamespace(engine=eng, app_envs={},
                                         manual_compact_service=svc))

    ticks = iter([False, True])    # one tick, then stop
    stub = types.SimpleNamespace(
        _stop=types.SimpleNamespace(wait=lambda s: next(ticks)),
        _maint_interval=0.0, _lock=threading.Lock(),
        _replicas={(1, p): replica(e, f"r{p}")
                   for p, e in enumerate(engines)})
    ReplicaStub._maintenance_loop(stub)
    assert sorted(e.stats()["l0_files"] for e in engines) == [0, 3]
    for e in engines:
        e.close()
