"""The port's tracers (pegasus_tpu_torch/runtime/tracing.py) held to the
JAX package's on the CPU, and request tracing on the port's wire and
serving path.

StageTracer: nesting, the mid-span box, the bounded ring and its dump,
counter export and the open-span view give the reference's rows; the
port's sessions are process-wide (a span closed on any thread lands in
every active session). RequestTracer: the reference's unit behaviour on
both packages' tracers, with equal span lists. Then an in-process port
onebox put yields ONE trace holding the client, rpc, replica.prepare,
plog.append and engine spans; the slow-request ledger answers over
`slow-requests`; a port client against a reference server, and the
reverse, carry one trace_id into the other package's tracer; the
toollets wrap a port RpcServer and send its frames per frame.
"""

import io
import json
import os
import threading
import time
import urllib.request

import pytest

import pegasus_tpu.runtime.tracing as ref_tr
import pegasus_tpu_torch.runtime.tracing as port_tr
from pegasus_tpu_torch.runtime.perf_counters import counters
from pegasus_tpu_torch.runtime.tracing import (REQUEST_TRACER, RequestTracer,
                                               StageTracer, TraceContext)

PACKAGES = {"reference": ref_tr, "port": port_tr}


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


def _rows(tracer, last=1000):
    return [{k: v for k, v in r.items()
             if k not in ("ts", "duration_us", "cpu_us")}
            for r in tracer.trace(last)]


# ------------------------------------------------------------ StageTracer


def _stage_scenario(mod, prefix):
    tr = mod.StageTracer(capacity=8, prefix=prefix)
    with tr.span("outer"):
        with tr.span("inner"):
            pass
        with tr.span("gather", records=1) as sp:
            sp["records"] = 41
            sp["bytes"] = 1000
    tr.event("pipeline.overlap", 0.25, records=2)
    return tr


def test_stage_rows_equal_the_reference():
    ref = _stage_scenario(ref_tr, "t_ref_rows")
    port = _stage_scenario(port_tr, "t_port_rows")
    assert _rows(port) == _rows(ref)
    assert [(r["stage"], r["depth"]) for r in _rows(port)] == [
        ("inner", 1), ("gather", 1), ("outer", 0), ("pipeline.overlap", 0)]
    assert port.trace()[1]["records"] == 41
    assert port.trace()[3]["duration_us"] == 250000


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_ring_is_bounded_and_dumps_every_row(pkg):
    tr = PACKAGES[pkg].StageTracer(capacity=8, prefix=f"t_ring_{pkg}")
    for i in range(50):
        with tr.span(f"s{i}"):
            pass
    rows = tr.trace(last=1000)
    assert [r["stage"] for r in rows] == [f"s{i}" for i in range(42, 50)]
    assert tr.dump(1000).count("\n") == 7
    assert PACKAGES[pkg].StageTracer().dump() == "no spans"


def test_spans_export_the_reference_counters():
    tr = StageTracer(prefix="t_port_exp")
    with tr.span("device", records=7, nbytes=64):
        time.sleep(0.002)
    snap = counters.snapshot(prefix="t_port_exp.stage.device.")
    assert set(snap) == {"t_port_exp.stage.device.count",
                         "t_port_exp.stage.device.duration_us",
                         "t_port_exp.stage.device.records",
                         "t_port_exp.stage.device.bytes"}
    assert counters.percentile(
        "t_port_exp.stage.device.duration_us").percentile(0.5) >= 2000


def test_sessions_aggregate_and_are_process_wide():
    tr = StageTracer(prefix="t_sess")
    with tr.session() as outer:
        for _ in range(3):
            with tr.span("pack", records=10, nbytes=100):
                pass
        with tr.session() as inner:

            def other():
                with tr.span("device", records=30):
                    pass

            t = threading.Thread(target=other)
            t.start()
            t.join()
    assert outer.stages["pack"] == dict(outer.stages["pack"], calls=3,
                                        records=30, bytes=300)
    assert set(outer.stages) == {"pack", "device"}
    assert set(inner.stages) == {"device"}
    assert inner.summary()["device"]["records"] == 30


def test_open_stages_and_innermost_open():
    tr = StageTracer(prefix="t_open")
    release, entered = threading.Event(), threading.Event()

    def worker():
        with tr.span("compact"):
            with tr.span("device"):
                entered.set()
                release.wait(10)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert entered.wait(10)
        (stack,) = tr.open_stages().values()
        assert stack == ["compact", "device"]
        stage, t0 = tr.innermost_open()
        assert stage == "device" and t0 <= time.time()
    finally:
        release.set()
        t.join()
    assert tr.open_stages() == {} and tr.innermost_open() is None


def test_watchdog_names_the_open_stage():
    from pegasus_tpu_torch.ops.device_watchdog import DeviceHealthWatchdog

    tr = StageTracer(prefix="t_wd")
    wd = DeviceHealthWatchdog("cpu", probe_fn=lambda: False, tracer=tr,
                              fail_threshold=1)
    with tr.span("gather"):
        assert not wd.probe()
    st = wd.state()
    assert st["wedged_at_stage"] == "gather"
    assert set(st) == {"device", "last_ok", "last_error", "wedged_at_stage",
                       "open_stages"}


# ---------------------------------------------------------- RequestTracer


def _request_scenario(mod):
    tr = mod.RequestTracer()
    tr.slow_threshold_us = 1 << 60
    with tr.root("OP") as ctx:
        assert tr.current() is ctx
        with tr.span("stage.a", records=3):
            with tr.span("stage.b"):
                pass
        with tr.root("NESTED"):
            pass
    assert tr.current() is None
    with tr.span("orphan"):
        pass
    with tr.serve(mod.TraceContext(0xABC, sampled=True, remote=True),
                  "RPC_X"):
        with tr.span("replica.on_prepare"):
            pass
    return tr


def _spans(trace):
    return [(s["name"], s["depth"], s.get("records"))
            for s in trace["spans"]]


def test_request_traces_equal_the_reference():
    ref, port = _request_scenario(ref_tr), _request_scenario(port_tr)
    got, want = port.trace(), ref.trace()
    assert [_spans(t) for t in got] == [_spans(t) for t in want]
    assert [(t["op"], sorted(t)) for t in got] == \
        [(t["op"], sorted(t)) for t in want]
    assert _spans(got[0]) == [("stage.b", 2, None), ("stage.a", 1, 3),
                              ("client.NESTED", 1, None),
                              ("client.OP", 0, None)]
    assert got[1]["trace_id"] == want[1]["trace_id"] == format(0xABC, "016x")
    assert [s["name"] for s in got[1]["spans"]] == \
        ["replica.on_prepare", "rpc.server.RPC_X"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_sampling_and_the_slow_ledger_are_independent(pkg):
    tr = PACKAGES[pkg].RequestTracer()
    tr.sample_every = 1 << 30
    tr.slow_threshold_us = 0
    with tr.root("OP"):
        pass
    assert tr.trace() == [] and len(tr.slow_requests()) == 1
    assert tr.find(tr.slow_requests()[0]["trace_id"]) is not None


def test_request_tracer_defaults_are_the_reference_knobs(monkeypatch):
    assert RequestTracer().slow_threshold_us == 50000
    assert RequestTracer().sample_every == 1
    monkeypatch.setenv("PEGASUS_SLOW_REQUEST_US", "7")
    monkeypatch.setenv("PEGASUS_TRACE_SAMPLE_EVERY", "3")
    assert RequestTracer().slow_threshold_us == 7
    assert RequestTracer().sample_every == 3


def test_cross_thread_spans_join_the_trace():
    tr = RequestTracer()
    tr.slow_threshold_us = 1 << 60
    with tr.root("OP") as ctx:
        def server():
            with tr.serve(TraceContext(ctx.trace_id, True, remote=True),
                          "RPC_X"):
                with tr.span("plog.append"):
                    pass

        t = threading.Thread(target=server)
        t.start()
        t.join()
    (trace,) = tr.trace(1)
    assert {"client.OP", "rpc.server.RPC_X", "plog.append"} <= {
        s["name"] for s in trace["spans"]}


def test_parallel_prepare_keeps_spans_in_the_trace(tmp_path, monkeypatch):
    """The prepare fan-out runs on a pool: each worker adopts the trace."""
    from pegasus_tpu_torch.base import key_schema
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.replication import ReplicaGroup
    import pegasus_tpu_torch.replication.mutation_log as ml
    import pegasus_tpu_torch.replication.replica as rp
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.task_codes import RPC_PUT

    monkeypatch.setenv("PEGASUS_PARALLEL_PREPARE", "1")
    g = ReplicaGroup(str(tmp_path), n=3,
                     options_factory=lambda: EngineOptions(device="cpu"))
    try:
        tr = RequestTracer()
        tr.slow_threshold_us = 1 << 60
        monkeypatch.setattr(rp, "REQUEST_TRACER", tr)
        monkeypatch.setattr(ml, "REQUEST_TRACER", tr)
        with tr.root("PUT"):
            g.write(RPC_PUT, msg.UpdateRequest(
                key_schema.generate_key(b"ph", b"ps"), b"v", 0))
        (trace,) = tr.trace(1)
        names = [s["name"] for s in trace["spans"]]
        assert names.count("plog.append") == 3, names
        assert names.count("replica.on_prepare") == 2, names
        assert "replica.prepare" in names and "replica.commit" in names
    finally:
        g.close()


# ---------------------------------------------------------- the onebox


@pytest.fixture(scope="module")
def onebox(tmp_path_factory):
    from tests.test_torch_cluster import Cluster, make_client

    c = Cluster(tmp_path_factory.mktemp("tracebox"))
    client = make_client(c, "tracetest", partitions=2)
    yield c, client
    client.close()
    c.stop()


def _put_traces(traces):
    return [t for t in traces if t["op"] == "RPC_RRDB_RRDB_PUT"
            and any(s["name"] == "replica.prepare" for s in t["spans"])]


def test_one_put_yields_one_trace_with_every_stage(onebox):
    _, client = onebox
    before = {t["trace_id"] for t in REQUEST_TRACER.trace(500)}
    client.set(b"tk", b"sk", b"payload")
    new = [t for t in _put_traces(REQUEST_TRACER.trace(500))
           if t["trace_id"] not in before]
    assert len(new) == 1, "one client put must yield exactly one trace"
    names = [s["name"] for s in new[0]["spans"]]
    for want in ("client.RPC_RRDB_RRDB_PUT", "rpc.RPC_RRDB_RRDB_PUT",
                 "rpc.server.RPC_RRDB_RRDB_PUT", "replica.prepare",
                 "replica.on_prepare", "plog.append", "replica.commit",
                 "engine.apply", "engine.write"):
        assert want in names, (want, names)
    assert names.count("plog.append") == 3
    client_span = next(s for s in new[0]["spans"]
                       if s["name"] == "client.RPC_RRDB_RRDB_PUT")
    assert client_span["duration_us"] <= new[0]["duration_us"]


def test_traced_get_is_served_in_its_trace(onebox):
    _, client = onebox
    client.set(b"gk", b"sk", b"v")
    before = {t["trace_id"] for t in REQUEST_TRACER.trace(500)}
    assert client.get(b"gk", b"sk") == b"v"
    gets = [t for t in REQUEST_TRACER.trace(500)
            if t["trace_id"] not in before and t["op"] == "RPC_RRDB_RRDB_GET"]
    assert gets and any(s["name"] == "rpc.server.RPC_RRDB_RRDB_GET"
                        for s in gets[-1]["spans"])


def test_untraced_waves_stay_batched_traced_ones_go_per_frame():
    """call_many outside a trace (the read-backs' path) is one batch
    handler call; the same wave inside a trace dispatches per frame."""
    from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcServer

    srv = RpcServer()
    calls = {"batch": 0, "frame": 0}

    def frame(h, b):
        calls["frame"] += 1
        return b

    def batch(headers, bodies):
        calls["batch"] += 1
        return list(bodies)

    srv.register("RPC_T_WAVE", frame)
    srv.register_batch("RPC_T_WAVE", batch)
    srv.start()
    conn = RpcConnection(srv.address)
    try:
        wave = [("RPC_T_WAVE", b"x%d" % i) for i in range(16)]
        assert [b for _, b in conn.call_many(wave)] == [b for _, b in wave]
        assert calls == {"batch": 1, "frame": 0}
        with REQUEST_TRACER.root("WAVE"):
            conn.call_many(wave)
        assert calls == {"batch": 1, "frame": 16}
    finally:
        conn.close()
        srv.stop()


def test_slow_requests_over_the_wire(onebox):
    from pegasus_tpu_torch.rpc import codec
    from pegasus_tpu_torch.rpc.transport import RpcConnection
    from pegasus_tpu_torch.runtime.remote_command import (
        RemoteCommandRequest, RemoteCommandResponse)

    c, client = onebox
    old = REQUEST_TRACER.slow_threshold_us
    REQUEST_TRACER.slow_threshold_us = 0
    try:
        client.set(b"slowk", b"sk", b"ledger-me")
    finally:
        REQUEST_TRACER.slow_threshold_us = old
    slow = _put_traces(REQUEST_TRACER.slow_requests(500))
    assert slow and any(s["name"] == "plog.append"
                        for s in slow[-1]["spans"])
    addr = next(iter(c.nodes))
    host, _, port = addr.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        outs = {}
        for cmd in ("slow-requests", "request-trace-dump"):
            _, body = conn.call("RPC_CLI_CLI_CALL", codec.encode(
                RemoteCommandRequest(cmd, ["500"])), timeout=10)
            outs[cmd] = json.loads(codec.decode(RemoteCommandResponse,
                                                body).output)
    finally:
        conn.close()
    assert any(t["trace_id"] == slow[-1]["trace_id"]
               for t in outs["slow-requests"])
    assert _put_traces(outs["request-trace-dump"])


def test_shell_prints_the_traces(onebox):
    from pegasus_tpu.shell.main import Shell as RefShell
    from pegasus_tpu_torch.shell.main import Shell

    c, client = onebox
    client.set(b"shk", b"sk", b"v")
    node = next(iter(c.nodes))
    for cmd in (f"request_trace {node} 5", f"slow_requests {node} 5",
                f"compact_trace {node} 5", f"job_trace {node} 5"):
        port_out, ref_out = io.StringIO(), io.StringIO()
        Shell([c.meta_addr], out=port_out).run_line(cmd)
        RefShell([c.meta_addr], out=ref_out).run_line(cmd)
        # both shells print one reply per command: valid JSON (or the
        # stage dump) from the same node
        assert port_out.getvalue().strip(), cmd
        if "compact_trace" not in cmd:
            json.loads(port_out.getvalue())
            json.loads(ref_out.getvalue())
    out = io.StringIO()
    Shell([c.meta_addr], out=out).run_line("device_health")
    text = out.getvalue()
    assert text.count("[") >= len(c.nodes) and "wedged_at_stage" in text


def test_set_fail_point_reaches_a_node_and_names_the_stage(onebox):
    """set_fail_point arms a sleep on one node's prepare; the slow
    ledger then holds a put whose prepare stage took the sleep."""
    from pegasus_tpu_torch.runtime import fail_points
    from pegasus_tpu_torch.shell.main import Shell

    c, client = onebox
    node = next(iter(c.nodes))
    out = io.StringIO()
    fail_points.setup()
    try:
        Shell([c.meta_addr], out=out).run_line(
            f"set_fail_point {node} replica.prepare 1*sleep(120)")
        assert f"[{node}] " in out.getvalue()
        assert json.loads(out.getvalue().split("] ", 1)[1]) == {
            f"pid:{os.getpid()}": "replica.prepare=1*sleep(120)"}
    finally:
        fail_points.teardown()


# ------------------------------------------------- across the packages


def _echo_trace_server(pkg_transport, tracer):
    """A bare RpcServer whose handler answers the trace id it serves."""
    srv = pkg_transport.RpcServer()

    def handler(header, body):
        ctx = tracer.current()
        return b"%d" % (ctx.trace_id if ctx else 0)

    srv.register("RPC_TRACE_ECHO", handler)
    return srv.start()


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_trace_id_crosses_between_the_packages(client_pkg):
    import pegasus_tpu.rpc.transport as ref_transport
    import pegasus_tpu_torch.rpc.transport as port_transport

    if client_pkg == "port":
        cli_t, cli_tr = port_transport, REQUEST_TRACER
        srv_t, srv_tr = ref_transport, ref_tr.REQUEST_TRACER
    else:
        cli_t, cli_tr = ref_transport, ref_tr.REQUEST_TRACER
        srv_t, srv_tr = port_transport, REQUEST_TRACER
    srv = _echo_trace_server(srv_t, srv_tr)
    conn = cli_t.RpcConnection(srv.address)
    try:
        with cli_tr.root("ECHO") as ctx:
            _, body = conn.call("RPC_TRACE_ECHO", b"", timeout=10)
        assert int(body) == ctx.trace_id != 0
        # the server's tracer finalized its remote view under that id
        deadline = time.time() + 5
        while srv_tr.find(format(ctx.trace_id, "016x")) is None:
            assert time.time() < deadline
            time.sleep(0.01)
        view = srv_tr.find(format(ctx.trace_id, "016x"))
        assert [s["name"] for s in view["spans"]] == \
            ["rpc.server.RPC_TRACE_ECHO"]
        # untraced calls carry trace_id 0 both ways
        _, body = conn.call("RPC_TRACE_ECHO", b"", timeout=10)
        assert int(body) == 0
    finally:
        conn.close()
        srv.stop()


# ------------------------------------------------------------ toollets


def test_toollets_wrap_every_handler_and_force_per_frame():
    from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcServer
    from pegasus_tpu_torch.runtime.remote_command import RemoteCommandService
    from pegasus_tpu_torch.runtime.toollets import install_toollets

    srv = RpcServer()
    calls = {"batch": 0}
    srv.register("RPC_T_ECHO", lambda h, b: b)

    def batch(headers, bodies):
        calls["batch"] += 1
        return list(bodies)

    srv.register_batch("RPC_T_ECHO", batch)
    cmds = RemoteCommandService()
    got = install_toollets(srv, ["tracer", "profiler", "nope"],
                           command_service=cmds)
    assert sorted(got) == ["profiler", "tracer"]
    srv.start()
    conn = RpcConnection(srv.address)
    try:
        out = conn.call_many([("RPC_T_ECHO", b"x%d" % i) for i in range(8)])
        assert [b for _, b in out] == [b"x%d" % i for i in range(8)]
    finally:
        conn.close()
        srv.stop()
    assert calls["batch"] == 0, "middlewares send every frame per frame"
    dump = cmds.invoke("tracer-dump", ["100"])
    assert dump.count("RPC_T_ECHO") == 8
    assert counters.rate("profiler.RPC_T_ECHO.qps").total() >= 8


def test_dispatch_queue_depth_gauge_is_registered():
    from pegasus_tpu_torch.rpc.transport import RpcServer

    srv = RpcServer()
    try:
        assert "rpc.server.dispatch_queue_depth" in counters.snapshot(
            prefix="rpc.server.")
    finally:
        srv.stop()


def test_core_toollets_no_longer_refused_http_port_still_is(tmp_path):
    from pegasus_tpu_torch.runtime.config import Config
    from pegasus_tpu_torch.runtime.service_app import MetaApp

    ini = ("[core]\ntoollets = tracer, profiler\n"
           f"[apps.meta]\ntype = meta\nport = 0\nstate_dir = {tmp_path}/m\n")
    app = MetaApp("meta", Config(text=ini), "apps.meta")
    app.start()
    try:
        assert len(app.rpc._middlewares) == 2
    finally:
        app.stop()
    # http_port is served now: the meta's reporter answers /metrics and
    # its routes; serve groups are still refused, by name
    app = MetaApp("meta", Config(text=ini + "http_port = 0\n"), "apps.meta")
    app.start()
    try:
        host, port = app.reporter.address
        with urllib.request.urlopen(f"http://{host}:{port}/version",
                                    timeout=10) as r:
            assert json.loads(r.read())["server_type"] == "meta"
    finally:
        app.stop()
    with pytest.raises(ValueError, match="serve_groups"):
        MetaApp("meta", Config(text=ini + "serve_groups = 2\n"), "apps.meta")
