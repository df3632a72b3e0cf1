"""Remote commands: name -> handler registry invocable over RPC.

Port of pegasus_tpu/runtime/remote_command.py. A server registers its
commands and serves them on the RPC_CLI_CLI_CALL task code; the request
and response messages are the JAX package's, so its shell and
collectors query a port service as they query their own. The default
commands are the JAX package's. The structural commands answer JSON
keyed by this process's pid, as the JAX package's do.
"""

import json
import os
import time
from dataclasses import dataclass, field
from typing import List

from ..rpc import codec
from .perf_counters import counters

VERSION = "pegasus-tpu-torch 2.0"
_START_TIME = time.time()


@dataclass
class RemoteCommandRequest:
    command: str = ""
    arguments: List[str] = field(default_factory=list)


@dataclass
class RemoteCommandResponse:
    output: str = ""


class RemoteCommandService:
    def __init__(self):
        self._commands = {}

    def register(self, name: str, fn) -> None:
        """fn(args: list[str]) -> str."""
        self._commands[name] = fn

    def register_defaults(self, node_kind: str, describe=None) -> None:
        self.register("help", lambda a: "\n".join(sorted(self._commands)))
        self.register("server-info", lambda a: (
            f"{VERSION}, {node_kind}, started "
            f"{int(time.time() - _START_TIME)}s ago"))
        self.register("server-stat", self._cmd_server_stat)
        self.register("perf-counters", lambda a: self._dump_counters(None))
        self.register("perf-counters-by-prefix",
                      lambda a: self._dump_counters(
                          lambda n: any(n.startswith(p) for p in a)))
        self.register("perf-counters-by-substr",
                      lambda a: self._dump_counters(
                          lambda n: any(p in n for p in a)))
        self.register("set-fail-point", self._cmd_set_fail_point)
        self.register("events-dump", self._cmd_events_dump)
        self.register("metrics-history", self._cmd_metrics_history)
        self.register("compact-trace-dump", self._cmd_compact_trace_dump)
        self.register("device-health", self._cmd_device_health)
        self.register("request-trace-dump", self._cmd_request_trace_dump)
        self.register("slow-requests", self._cmd_slow_requests)
        self.register("job-trace", self._cmd_job_trace)
        self.register("table-stats", self._cmd_table_stats)
        self.register("slo-status", self._cmd_slo_status)
        if describe is not None:
            self.register("describe",
                          lambda a: json.dumps(describe(), indent=1))

    @staticmethod
    def _cmd_set_fail_point(args) -> str:
        """set-fail-point <name> <action>: arm (or heal, with 'off()') a
        fail point in THIS server process at runtime, in the action
        language the tests use (`sleep(ms)`, `raise(msg)`, `return(v)`,
        `N%`/`K*` modifiers). Arming never clears other armed points."""
        from . import fail_points

        if len(args) < 2:
            return "usage: set-fail-point <name> <action>"
        name, action = args[0], " ".join(args[1:])
        try:
            fail_points.arm(name, action)
        except ValueError as e:
            return str(e)
        return json.dumps({f"pid:{os.getpid()}": f"{name}={action}"})

    @staticmethod
    def _cmd_metrics_history(args) -> str:
        """metrics-history [seconds] [prefix]: this process's metric
        history window (runtime/metric_history.py)."""
        from .metric_history import HISTORY

        seconds = float(args[0]) if args else None
        prefix = args[1] if len(args) > 1 else None
        return json.dumps({f"pid:{os.getpid()}":
                           HISTORY.window(seconds=seconds, prefix=prefix)})

    @staticmethod
    def _cmd_compact_trace_dump(args) -> str:
        """compact-trace-dump [last]: recent stage spans from the
        process-wide ring (runtime/tracing.py COMPACT_TRACER)."""
        from .tracing import COMPACT_TRACER

        return COMPACT_TRACER.dump(int(args[0]) if args else 100)

    @staticmethod
    def _cmd_device_health(args) -> str:
        """device-health: the device watchdog's liveness and wedge state
        (ops/device_watchdog.py)."""
        from ..ops.device_watchdog import health_watchdog

        return json.dumps(health_watchdog().state(), indent=1)

    @staticmethod
    def _cmd_request_trace_dump(args) -> str:
        """request-trace-dump [last]: recent sampled request traces
        (runtime/tracing.py REQUEST_TRACER)."""
        from .tracing import REQUEST_TRACER

        return json.dumps(
            REQUEST_TRACER.trace(int(args[0]) if args else 50), indent=1)

    @staticmethod
    def _cmd_slow_requests(args) -> str:
        """slow-requests [last]: the slow-request ledger, full stage
        timelines of every request over the slow threshold."""
        from .tracing import REQUEST_TRACER

        return json.dumps(
            REQUEST_TRACER.slow_requests(int(args[0]) if args else 50),
            indent=1)

    @staticmethod
    def _cmd_job_trace(args) -> str:
        """job-trace [last | <job-id>]: this process's background-job
        timelines (runtime/job_trace.py), completed and still open, or
        ONE timeline when a j-prefixed id is given."""
        from .job_trace import JOB_TRACER

        if args and args[0].startswith("j"):
            found = JOB_TRACER.find(args[0])
            return json.dumps({f"pid:{os.getpid()}":
                               [found] if found else []})
        last = int(args[0]) if args else 50
        return json.dumps({f"pid:{os.getpid()}": JOB_TRACER.jobs(last=last)})

    @staticmethod
    def _cmd_table_stats(args) -> str:
        """table-stats: this process's per-table ledger totals
        (runtime/table_stats.py); callers fold the fragments with
        table_stats.fold_snapshots."""
        from .table_stats import TABLE_STATS

        return json.dumps({f"pid:{os.getpid()}": TABLE_STATS.snapshot()})

    @staticmethod
    def _cmd_slo_status(args) -> str:
        """slo-status: the per-table SLO burn-rate verdicts this process
        computed last ({} on nodes that never evaluate SLOs: the
        collector is the evaluator), keyed by this process's pid."""
        from ..collector.info_collector import latest_slo

        return json.dumps({f"pid:{os.getpid()}": latest_slo()})

    @staticmethod
    def _cmd_events_dump(args) -> str:
        """events-dump [last] [prefix]: this process's event ring
        (runtime/events.py), as a JSON dict keyed by this process's pid."""
        from .events import EVENTS

        last = int(args[0]) if args else None
        prefix = args[1] if len(args) > 1 else None
        return json.dumps({f"pid:{os.getpid()}":
                           EVENTS.snapshot(last=last, prefix=prefix)})

    def _cmd_server_stat(self, args) -> str:
        """One-line digest of the *_qps counters."""
        snap = counters.snapshot()
        keys = sorted(k for k in snap if k.endswith("_qps"))[:8]
        parts = [f"{k.rsplit('.', 1)[-1]}={snap[k]:.0f}" for k in keys]
        return ", ".join(parts) if parts else "no stats yet"

    def _dump_counters(self, pred) -> str:
        snap = counters.snapshot()
        out = {k: v for k, v in sorted(snap.items())
               if pred is None or pred(k)}
        return json.dumps(out, indent=1)

    def invoke(self, command: str, arguments: list) -> str:
        fn = self._commands.get(command)
        if fn is None:
            return f"unknown command: {command!r} (try 'help')"
        try:
            return fn(list(arguments))
        except Exception as e:  # surface the error text, keep serving
            return f"command failed: {e!r}"

    def rpc_handler(self, header, body) -> bytes:
        req = codec.decode(RemoteCommandRequest, body)
        return codec.encode(RemoteCommandResponse(
            self.invoke(req.command, req.arguments)))
