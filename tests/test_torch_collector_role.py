"""The collector role of the port in processes, and onebox.ini booted
whole, on the CPU.

A meta, three replicas and a collector run as `python -m
pegasus_tpu_torch.server` processes (compaction_backend = cpu), started
once for the module. The collector's canary reaches real samples; reads
hammered on one hash key flag its partition, the hotkey loop finds the
key on the primary and pins the partition's read residency; the shell's
`detect_hotkey`, `slo`, `app_stat` and `slow_requests --cluster` answer;
`collector-info` carries the reference's keys. A collector restarted
under PEGASUS_SCHED=1 names the pinned partition hot in its first
scheduler round. Then a copy of onebox.ini (every `run = true` app, free
ports, data under tmp_path, the cpu backend) boots in one process, every
app prints its started line, and replica1's http_port serves /metrics.
"""

import configparser
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.client import MetaResolver, PegasusClient
from pegasus_tpu_torch.meta import messages as mm
from pegasus_tpu_torch.meta.meta_server import (RPC_CM_CREATE_APP,
                                                RPC_CM_LIST_NODES,
                                                RPC_CM_QUERY_CONFIG)
from pegasus_tpu_torch.rpc import codec
from pegasus_tpu_torch.rpc.transport import RpcConnection, RpcError
from pegasus_tpu_torch.runtime.remote_command import (RemoteCommandRequest,
                                                      RemoteCommandResponse)
from pegasus_tpu_torch.shell.main import Shell
from tests.test_torch_cluster import _free_ports

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFO_KEYS = ["app_stats", "availability", "compact_sched", "compact_stats",
             "hotkeys", "hotspots", "lag_stats", "slow_requests"]


def _call(addr, code, req, resp_cls, timeout=10.0):
    host, _, port = addr.rpartition(":")
    conn = RpcConnection((host, int(port)))
    try:
        _, body = conn.call(code, codec.encode(req), timeout=timeout)
        return codec.decode(resp_cls, body)
    finally:
        conn.close()


def command(addr, name, args=(), timeout=10.0):
    return _call(addr, "RPC_CLI_CLI_CALL",
                 RemoteCommandRequest(name, list(args)),
                 RemoteCommandResponse, timeout).output


def wait_for(fn, timeout=30.0, interval=0.3):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = fn()
            if last:
                return last
        except (RpcError, OSError, ValueError):
            pass
        time.sleep(interval)
    return last


class _Proc:
    """One `python -m pegasus_tpu_torch.server --app <name>` process."""

    def __init__(self, ini, name, work, env=None):
        self.ini, self.name, self.work = ini, name, work
        self.env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
        self.log = os.path.join(work, f"{name}.log")
        with open(self.log, "a") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pegasus_tpu_torch.server",
                 "--config", ini, "--app", name], stdout=out,
                stderr=subprocess.STDOUT, cwd=work, env=self.env)

    def started(self, deadline):
        marker = f"[pegasus-tpu] app {self.name} started "
        while True:
            with open(self.log) as f:
                for line in f:
                    if line.startswith(marker):
                        return line.split()[-1]
            assert self.proc.poll() is None, self.tail()
            assert time.monotonic() < deadline, f"{self.name}: no start"
            time.sleep(0.1)

    def tail(self):
        with open(self.log) as f:
            return f.read()[-3000:]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


class _Box:
    def __init__(self, root):
        self.root = str(root)
        p_meta, p1, p2, p3, pc = _free_ports(5)
        self.meta = f"127.0.0.1:{p_meta}"
        self.collector = f"127.0.0.1:{pc}"
        ini = [f"[apps.meta1]\ntype = meta\nport = {p_meta}\n"
               f"state_dir = {self.root}/meta\n"]
        for i, p in enumerate((p1, p2, p3), 1):
            ini.append(f"[apps.replica{i}]\ntype = replica\nport = {p}\n"
                       f"data_dir = {self.root}/replica{i}\n")
        for name in ("collector", "collector_sched"):
            ini.append(f"[apps.{name}]\ntype = collector\nport = {pc}\n"
                       "interval_seconds = 1.0\n"
                       "detect_interval_seconds = 0.4\n")
        ini.append(f"[pegasus.server]\nmeta_servers = {self.meta}\n"
                   "compaction_backend = cpu\n"
                   "[failure_detector]\nbeacon_interval_seconds = 0.2\n"
                   "grace_seconds = 60\n")
        self.ini = os.path.join(self.root, "role.ini")
        with open(self.ini, "w") as f:
            f.write("".join(ini))
        self.procs = {n: _Proc(self.ini, n, self.root)
                      for n in ("meta1", "replica1", "replica2", "replica3")}
        deadline = time.monotonic() + 120
        self.nodes = [self.procs[f"replica{i}"].started(deadline)
                      for i in (1, 2, 3)]
        self.procs["meta1"].started(deadline)

        def alive():
            r = _call(self.meta, RPC_CM_LIST_NODES, mm.ListNodesRequest(),
                      mm.ListNodesResponse)
            return sum(n.alive for n in r.nodes) == 3

        assert wait_for(alive, timeout=60)
        # with every node alive, the canary's table gets its 3 replicas
        self.procs["collector"] = _Proc(self.ini, "collector", self.root)
        self.procs["collector"].started(deadline)

    def info(self):
        return json.loads(command(self.collector, "collector-info"))

    def stop(self):
        rcs = {n: p.stop() for n, p in reversed(list(self.procs.items()))}
        return rcs


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    b = _Box(tmp_path_factory.mktemp("role"))
    yield b
    rcs = b.stop()
    assert all(rc == 0 for rc in rcs.values()), {
        n: (rc, b.procs[n].tail()) for n, rc in rcs.items() if rc}


def _hot_key_client(box, table, parts):
    r = _call(box.meta, RPC_CM_CREATE_APP,
              mm.CreateAppRequest(table, parts, 3), mm.CreateAppResponse)
    assert r.error == 0, r
    cl = PegasusClient(MetaResolver([box.meta], table), timeout=10)
    for i in range(16):
        cl.set(b"k%d" % i, b"s", b"v%d" % i)
    cl.set(b"hammered", b"s", b"hot")
    return cl


class _Hammer:
    """Reads of one hash key (a few to others) from a thread of its own
    client until stopped: the partition stays flagged (a calm round would
    release the pin) while the test reads what the loop concluded."""

    def __init__(self, box, table):
        self.client = PegasusClient(MetaResolver([box.meta], table),
                                    timeout=10)
        self.stop = threading.Event()
        self.reads = 0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            assert self.client.get(b"hammered", b"s") == b"hot"
            self.reads += 1
            if self.reads % 10 == 0:
                self.client.get(b"k%d" % (self.reads % 16), b"s")

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        self.client.close()


def _shell(box, line):
    out = io.StringIO()
    sh = Shell([box.meta], out=out)
    try:
        sh.run_line(line)
    finally:
        sh.pool.close()
    assert not sh.failed, out.getvalue()
    return out.getvalue()


def test_collector_app_role_canary_and_hotspot(box):
    assert "collector" in command(box.collector, "server-info")

    def canary_up():
        av = box.info()["availability"]
        return av if av["samples"] >= 3 and av["minute"] > 0.9 else None

    assert wait_for(canary_up, timeout=90), box.info()["availability"]
    probe = PegasusClient(MetaResolver([box.meta], "test"), timeout=10)
    assert wait_for(lambda: probe.get(b"detect_available_result", b"last"))
    probe.close()
    assert sorted(box.info()) == INFO_KEYS

    cl = _hot_key_client(box, "hotreads", 4)
    app_id = cl.resolver.app_id
    pidx, _ = cl._route(generate_key(b"hammered", b"s"))
    resident = f"collector.app.hotreads.hotkey.{pidx}.device_resident"

    def pinned():
        gauges = json.loads(command(box.collector, "perf-counters-by-prefix",
                                    ["collector.app.hotreads.hotkey."]))
        return gauges if gauges.get(resident) == 1 else None

    with _Hammer(box, "hotreads") as hammer:
        verdict = wait_for(lambda: box.info()["hotkeys"].get("hotreads"),
                           timeout=60)
        assert verdict, box.info()
        assert list(verdict.values())[0]["key"] == repr(b"hammered")
        assert list(verdict.values())[0]["kind"] == "read"
        assert int(list(verdict)[0]) == pidx
        gauges = wait_for(pinned, timeout=30)
        assert gauges and gauges[
            f"collector.app.hotreads.hotkey.{pidx}.hot"] == 1
        assert box.info()["hotspots"]["hotreads"] == [pidx]
    assert hammer.reads > 0
    hot_pidx = pidx
    # calm: the loop releases the pin
    assert wait_for(lambda: not pinned(), timeout=30)

    # the shell reaches the same planes
    cfg = _call(box.meta, RPC_CM_QUERY_CONFIG,
                mm.QueryConfigRequest("hotreads"), mm.QueryConfigResponse)
    primary = cfg.partitions[hot_pidx].primary
    gpid = f"{app_id}.{hot_pidx}"
    assert "started" in _shell(
        box, f"detect_hotkey {primary} {gpid} read start")
    for _ in range(300):
        cl.get(b"hammered", b"s")
    assert "b'hammered'" in _shell(
        box, f"detect_hotkey {primary} {gpid} read query")
    _shell(box, f"detect_hotkey {primary} {gpid} read stop")
    slo = json.loads(_shell(box, f"slo {box.collector}"))
    verdicts = list(slo.values())[0]
    assert verdicts["hotreads"]["verdict"] == "ok"
    assert {"fast_burn", "slow_burn", "availability_target"} <= set(
        verdicts["hotreads"])
    stat = _shell(box, "app_stat").splitlines()
    assert stat[0].split() == ["app", "get_qps", "put_qps", "multi_get_qps",
                               "scan_qps", "recent_read_cu",
                               "recent_write_cu"]
    assert {line.split()[0] for line in stat[1:]} >= {"hotreads", "test"}
    slow = json.loads(_shell(box, "slow_requests --cluster 5"))
    assert isinstance(slow, list) and len(slow) <= 5
    assert all(t["node"] in box.nodes for t in slow)
    cl.close()


def test_collector_under_sched_names_the_pinned_partition_hot(box):
    """The role restarted under PEGASUS_SCHED=1: its hotkey loop pins the
    hammered partition again before the scheduler's first round, whose
    decisions name that gpid hot (`hot_read`)."""
    assert box.procs.pop("collector").stop() == 0
    box.procs["collector_sched"] = _Proc(
        box.ini, "collector_sched", box.root,
        env={"PEGASUS_SCHED": "1", "PEGASUS_SCHED_INTERVAL_S": "15"})
    box.procs["collector_sched"].started(time.monotonic() + 60)
    cl = PegasusClient(MetaResolver([box.meta], "hotreads"), timeout=10)
    app_id = cl.resolver.app_id

    def first_round():
        st = box.info()["compact_sched"]
        assert st["enabled"] is True
        return st if st.get("decisions") else None

    pidx, _ = cl._route(generate_key(b"hammered", b"s"))
    gpid = f"{app_id}.{pidx}"
    with _Hammer(box, "hotreads"):
        pinned = wait_for(lambda: box.info()["hotkeys"].get("hotreads"),
                          timeout=60)
        assert pinned and list(pinned) == [str(pidx)], pinned
        assert box.info()["compact_sched"].get("decisions") is None, \
            "the pin came after the scheduler's first round"
        st = wait_for(first_round, timeout=30)
    assert st, box.info()["compact_sched"]
    assert st["decisions"][gpid]["policy"] == "defer"
    assert st["decisions"][gpid]["reasons"] == ["hot_read"]
    assert all("hot_read" not in d["reasons"]
               for g, d in st["decisions"].items() if g != gpid)
    assert json.loads(command(box.collector,
                              "compact-sched-status"))["enabled"] is True
    cl.close()


def test_onebox_ini_boots_every_app(tmp_path):
    cp = configparser.ConfigParser()
    cp.read(os.path.join(ROOT, "onebox.ini"))
    apps = [s[len("apps."):] for s in cp.sections()
            if s.startswith("apps.") and cp.getboolean(s, "run",
                                                       fallback=True)]
    assert set(apps) == {"meta1", "meta2", "meta3", "replica1", "replica2",
                         "replica3", "collector"}
    ports = iter(_free_ports(16))
    for sec in cp.sections():
        s = cp[sec]
        for key in ("port", "http_port"):
            if key in s:
                s[key] = str(next(ports))
        for key in ("state_dir", "data_dir", "job_dir"):
            if key in s:
                s[key] = str(tmp_path / s[key])
    metas = [f"127.0.0.1:{cp[f'apps.meta{i}']['port']}" for i in (1, 2, 3)]
    cp["pegasus.server"]["meta_servers"] = ",".join(metas)
    cp["pegasus.server"]["compaction_backend"] = "cpu"
    ini = tmp_path / "onebox.ini"
    with open(ini, "w") as f:
        cp.write(f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pegasus_tpu_torch.server", "--config",
         str(ini)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=str(tmp_path))
    try:
        started = []
        deadline = time.monotonic() + 90
        while len(started) < len(apps):
            assert time.monotonic() < deadline and proc.poll() is None, \
                proc.stderr.read()
            line = proc.stdout.readline()
            if line.startswith("[pegasus-tpu] app ") and " started " in line:
                started.append(line.split()[2])
        assert sorted(started) == sorted(apps)
        http = cp["apps.replica1"]["http_port"]
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "# TYPE rpc_server_dispatch_queue_depth gauge" in text
        with urllib.request.urlopen(f"http://127.0.0.1:{http}/replica/info",
                                    timeout=30) as r:
            assert isinstance(json.loads(r.read()), list)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0, proc.stderr.read()[-3000:]
