"""The port's runtime planes held to the JAX package's on the CPU: lock
ranks, tasking, the metric history and the remote commands.

Lock ranks: an AB/BA inversion is caught under PEGASUS_LOCKRANK=raise
with the reference's violation record; a condition wait over a named
lock forms no false edge; the port's replication group and in-process
cluster (writes, a kill, a relearn, compactions) leave the port's
GRAPH.violations empty. Tasking: every spawn and executor is tracked
and joinable; pools run by priority; timers repeat and cancel. Metric
history: the same samples give the reference's windows. Remote
commands: the eight the port adds answer the reference's JSON shapes.
"""

import json
import os
import threading
import time

import pytest

import pegasus_tpu.runtime.lockrank as ref_lr
import pegasus_tpu_torch.runtime.lockrank as port_lr
from pegasus_tpu_torch.runtime import tasking
from pegasus_tpu_torch.runtime.perf_counters import counters


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools

    stop_pools()
    tasking.TRACKED.join_all(timeout_s=5.0)


# ---------------------------------------------------------------- lockrank


def _inversion(mod, monkeypatch, raise_mode):
    monkeypatch.setenv("PEGASUS_LOCKRANK", "raise" if raise_mode else "1")
    g = mod._Graph()
    a, b = mod.NamedLock("t.a", g), mod.NamedLock("t.b", g)
    with a:
        with b:
            pass
    if raise_mode:
        with pytest.raises(mod.LockOrderError, match="t.b -> t.a"):
            with b:
                with a:
                    pass
        assert not a.locked() and not b.locked()
    else:
        with b:
            with a:
                pass
    return g.violations


@pytest.mark.parametrize("raise_mode", [True, False])
def test_ab_ba_inversion_is_caught(monkeypatch, raise_mode):
    port = _inversion(port_lr, monkeypatch, raise_mode)
    ref = _inversion(ref_lr, monkeypatch, raise_mode)
    assert len(port) == len(ref) == 1
    strip = ("held_site", "acquire_site", "reverse_edge", "thread", "pid")
    assert {k: v for k, v in port[0].items() if k not in strip} == \
        {k: v for k, v in ref[0].items() if k not in strip} == {
            "cycle": ["t.a", "t.b", "t.a"], "held": "t.b",
            "acquiring": "t.a"}
    assert set(port[0]) == set(ref[0])
    assert port[0]["acquire_site"].startswith("tests/test_torch_runtime.py:")


def test_factories_follow_the_knob(monkeypatch):
    monkeypatch.setenv("PEGASUS_LOCKRANK", "0")
    assert not isinstance(port_lr.named_lock("x"), port_lr.NamedLock)
    assert not isinstance(port_lr.named_rlock("x"), port_lr.NamedRLock)
    monkeypatch.setenv("PEGASUS_LOCKRANK", "1")
    assert isinstance(port_lr.named_lock("x"), port_lr.NamedLock)
    cv = port_lr.named_condition("x.cv")
    assert isinstance(cv._lock, port_lr.NamedRLock)


def test_condition_wait_forms_no_false_edge(monkeypatch):
    monkeypatch.setenv("PEGASUS_LOCKRANK", "raise")
    g = port_lr._Graph()
    outer = port_lr.NamedRLock("t.outer", g)
    cv = threading.Condition(outer)
    other = port_lr.NamedLock("t.other", g)
    hit = []

    def waker():
        with other:
            with cv:
                hit.append(1)
                cv.notify_all()

    with cv:
        t = threading.Thread(target=waker)
        t.start()
        cv.wait_for(lambda: hit, timeout=5)
    t.join()
    # other -> outer is the only edge: the wait released outer
    assert g.snapshot()["edges"] == {"t.other": ["t.outer"]}
    assert g.violations == []


def test_the_port_planes_leave_no_lock_order_violation(tmp_path):
    """The port's locks are named under the suite's PEGASUS_LOCKRANK=1:
    a replication group and an in-process cluster doing writes, a kill,
    a relearn and compactions record edges and no cycle."""
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.replication import ReplicaGroup
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.task_codes import RPC_PUT
    from tests.test_torch_cluster import Cluster, make_client

    assert port_lr.enabled(), "the suite arms PEGASUS_LOCKRANK"
    before = len(port_lr.GRAPH.violations)
    g = ReplicaGroup(str(tmp_path / "g"), n=3, options_factory=lambda:
                     EngineOptions(device="cpu", memtable_bytes=2048,
                                   l0_compaction_trigger=2))
    try:
        for i in range(60):
            g.write(RPC_PUT, msg.UpdateRequest(b"\x00\x02k%d" % i,
                                               b"v" * 64, 0))
        victim = [n for n in g.alive if n != g.primary][0]
        g.kill(victim)
        g.write(RPC_PUT, msg.UpdateRequest(b"\x00\x02kx", b"v", 0))
        g.restart(victim)
        g.primary_replica().server.engine.manual_compact()
    finally:
        g.close()
    c = Cluster(tmp_path / "c")
    try:
        cl = make_client(c, "lr", partitions=2)
        for i in range(40):
            cl.set(b"h%d" % i, b"s", b"v" * 32)
        for stub in c.nodes.values():
            stub.batched_manual_compact()
        cl.close()
    finally:
        c.stop()
    edges = port_lr.GRAPH.snapshot()["edges"]
    assert "engine.compaction" in edges and "replica.lock" in edges
    assert port_lr.GRAPH.violations[before:] == []


# ----------------------------------------------------------------- tasking


def test_spawned_threads_and_executors_are_tracked():
    from pegasus_tpu_torch.ops.pipeline import stop_pools

    stop_pools()  # join_all shuts every tracked executor down
    stop = threading.Event()
    t = tasking.spawn_thread(stop.wait, 10, name="t-tracked")
    ex = tasking.tracked_executor(1, thread_name_prefix="t-ex")
    assert t in tasking.TRACKED.live_threads()
    assert ex in tasking.TRACKED.live_executors()
    stop.set()
    assert tasking.TRACKED.join_all(timeout_s=5.0) == []
    assert not t.is_alive()
    with pytest.raises(RuntimeError):
        ex.submit(print)


def test_pool_runs_by_priority_and_timers_repeat():
    pool = tasking.ThreadPool("t-pool", worker_count=1)
    gate, order = threading.Event(), []
    pool.enqueue(gate.wait, 5)
    for p in (0, 2, 1):
        pool.enqueue(order.append, p, priority=p)
    gate.set()
    fired = []
    timer = tasking.Timer(pool, 0.01, fired.append, 1)
    deadline = time.time() + 5
    while len(fired) < 3:
        assert time.time() < deadline
        time.sleep(0.01)
    timer.cancel()
    pool.stop()
    assert order == [2, 1, 0]
    with pytest.raises(RuntimeError):
        pool.enqueue(print)


# ---------------------------------------------------------- metric history


def test_history_windows_equal_the_reference():
    from pegasus_tpu.runtime.metric_history import \
        MetricHistory as RefHistory
    from pegasus_tpu.runtime.perf_counters import counters as ref_counters
    from pegasus_tpu_torch.runtime.metric_history import MetricHistory

    windows = []
    for make, ctr in ((MetricHistory, counters), (RefHistory, ref_counters)):
        h = make(interval_s=1, capacity=3, prefixes=("t_hist.",))
        lvl = ctr.number("t_hist.level")
        pct = ctr.percentile("t_hist.lat")
        for i, ts in enumerate((100.0, 101.0, 102.0, 103.0)):
            lvl.set(10 * i)
            pct.set(5 * (i + 1))
            h.sample_once(now=ts)
        windows.append((h.window(deltas=True),
                        h.window(seconds=1.5, now=103.0, deltas=True),
                        h.series("t_hist.level")))
    assert windows[0] == windows[1]
    full, tail, series = windows[0]
    assert [s["ts"] for s in full["samples"]] == [101.0, 102.0, 103.0]
    assert tail["samples"][0]["deltas"]["t_hist.level"] == 10.0
    assert series[-1] == (103.0, 30.0)
    assert "t_hist.lat.p99" in full["samples"][0]["values"]


def test_history_is_refcounted():
    from pegasus_tpu_torch.runtime.metric_history import MetricHistory

    h = MetricHistory(interval_s=0.01, capacity=4, prefixes=("history.",))
    h.start()
    h.start()
    h.stop()
    deadline = time.time() + 5
    while not h.window()["samples"]:
        assert time.time() < deadline
        time.sleep(0.01)
    h.stop()
    assert h._stop_evt is None and h._refs == 0


# --------------------------------------------------------- remote commands


def _services():
    from pegasus_tpu.runtime.remote_command import \
        RemoteCommandService as RefCommands
    from pegasus_tpu_torch.runtime.remote_command import RemoteCommandService

    port, ref = RemoteCommandService(), RefCommands()
    port.register_defaults("replica")
    ref.register_defaults("replica")
    return port, ref


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(x) for x in v[:1]]
    return type(v).__name__


@pytest.mark.parametrize("cmd,args", [
    ("metrics-history", ["60", "history."]),
    ("request-trace-dump", ["5"]),
    ("slow-requests", ["5"]),
    ("job-trace", ["0"]),
    ("table-stats", []),
])
def test_structural_commands_answer_the_reference_shape(cmd, args):
    port, ref = _services()
    got, want = (json.loads(s.invoke(cmd, args)) for s in (port, ref))
    if isinstance(want, dict) and set(want) == {f"pid:{os.getpid()}"}:
        assert list(got) == list(want)
        got, want = (list(x.values())[0] for x in (got, want))
    assert type(got) is type(want)
    if cmd == "metrics-history":
        assert set(got) == set(want) == {"interval_s", "capacity",
                                         "samples"}


def test_set_fail_point_and_compact_trace_dump_match_the_reference():
    from pegasus_tpu.runtime import fail_points as ref_fp
    from pegasus_tpu_torch.runtime import fail_points as port_fp

    port, ref = _services()
    port_fp.setup()
    ref_fp.setup()
    try:
        for args in (["t.point", "1*sleep(5)"], ["t.point"],
                     ["t.point", "bogus!"]):
            assert port.invoke("set-fail-point", args) == \
                ref.invoke("set-fail-point", args)
        assert port_fp.fail_point("t.point") is None  # the sleep ran
    finally:
        port_fp.teardown()
        ref_fp.teardown()
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    with COMPACT_TRACER.span("t_dump_stage", records=3):
        pass
    dump = port.invoke("compact-trace-dump", ["5"])
    assert dump.splitlines()[-1].split()[1:] == [
        "t_dump_stage", dump.splitlines()[-1].split()[2], "records=3",
        "bytes=0"]


def test_device_health_reports_the_port_watchdog():
    from pegasus_tpu_torch.ops.device_watchdog import watchdog_for

    port, _ = _services()
    wd = watchdog_for("cpu")
    wd.interval_s = 3600
    wd.start()
    try:
        assert wd.probe()
        got = json.loads(port.invoke("device-health", []))
    finally:
        wd.stop()
    assert got["device"] == "cpu" and got["wedged_at_stage"] is None
    assert got["last_ok"] is not None and got["last_ok"] <= time.time()
    assert set(got) >= {"last_ok", "last_error", "wedged_at_stage",
                        "open_stages"}


def test_help_lists_the_ported_commands_not_slo_status():
    port, ref = _services()
    names = set(port.invoke("help", []).split())
    for cmd in ("set-fail-point", "metrics-history", "compact-trace-dump",
                "device-health", "request-trace-dump", "slow-requests",
                "job-trace", "table-stats"):
        assert cmd in names
    # slo-status is served now (the collector's evaluator is ported):
    # the port's defaults are the reference's
    assert "slo-status" in names
    assert names == set(ref.invoke("help", []).split())
