"""Toollets: pluggable tracer / profiler / fault injector for the RPC layer.

Port of pegasus_tpu/runtime/toollets.py. Each toollet is an RpcServer
middleware wrapping every registered handler (RpcServer.add_middleware):

  tracer   — ring buffer of (ts, code, seq, dur_us, req/resp sizes) spans,
             dumpable through the `tracer-dump` remote command.
  profiler — per-task-code qps, latency percentile and size counters.
  fault_injector — fail-point actions per task code:
             arm("rpc.<CODE>", "10%return()") errors matching RPCs.

Enable from ini: [core] toollets = tracer, profiler (the service roles
install them onto every app's RpcServer). A server with a middleware
serves every frame on the per-frame path (rpc/transport.py).
"""

import collections
import threading
import time

from . import fail_points
from .perf_counters import counters


class Tracer:
    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=capacity)

    def middleware(self, code, header, body, next_fn):
        t0 = time.perf_counter()
        out = next_fn(header, body)
        dur_us = int((time.perf_counter() - t0) * 1e6)
        with self._lock:
            self._spans.append((time.time(), code, header.seq, dur_us,
                                len(body), len(out) if out else 0))
        return out

    def dump(self, last: int = 100) -> str:
        with self._lock:
            spans = list(self._spans)[-last:]
        return "\n".join(
            f"{ts:.6f} {code} seq={seq} {dur}us req={rq}B resp={rs}B"
            for ts, code, seq, dur, rq, rs in spans) or "no spans"


class Profiler:
    """profiler::*.qps / .latency.server / .size.{request,response}.server"""

    def middleware(self, code, header, body, next_fn):
        t0 = time.perf_counter()
        out = next_fn(header, body)
        counters.rate(f"profiler.{code}.qps").increment()
        counters.percentile(f"profiler.{code}.latency_us").set(
            int((time.perf_counter() - t0) * 1e6))
        counters.percentile(f"profiler.{code}.size.request").set(len(body))
        if out:
            counters.percentile(f"profiler.{code}.size.response").set(len(out))
        return out


class FaultInjector:
    """Per-task-code fault injection through the fail-point registry:
    fail_points.cfg('rpc.RPC_RRDB_RRDB_GET', '10%return()') makes 10% of
    gets fail; 'delay(50)' style argument on the print verb adds latency."""

    def middleware(self, code, header, body, next_fn):
        fp = fail_points.fail_point(f"rpc.{code}")
        if fp is not None:
            verb, arg = fp
            if verb == "return":
                from ..rpc.transport import ERR_BUSY, RpcError

                raise RpcError(ERR_BUSY, f"fault injected: {arg or 'drop'}")
            if verb == "print" and arg.startswith("delay"):
                try:
                    ms = float(arg[arg.index("(") + 1 : arg.rindex(")")] or 0)
                except ValueError:
                    ms = 0
                time.sleep(ms / 1000.0)
        return next_fn(header, body)


TOOLLETS = {"tracer": Tracer, "profiler": Profiler,
            "fault_injector": FaultInjector}


def install_toollets(rpc_server, names, command_service=None):
    """Instantiate the named toollets onto an RpcServer; returns them.
    Registers `tracer-dump` when a RemoteCommandService is provided."""
    out = {}
    for name in names:
        cls = TOOLLETS.get(name.strip())
        if cls is None:
            continue
        t = cls()
        rpc_server.add_middleware(t.middleware)
        out[name.strip()] = t
    tracer = out.get("tracer")
    if tracer is not None and command_service is not None:
        command_service.register(
            "tracer-dump",
            lambda args: tracer.dump(int(args[0]) if args else 100))
    return out
