"""Remote commands: name -> handler registry invocable over RPC.

Port of pegasus_tpu/runtime/remote_command.py. A server registers its
commands and serves them on the RPC_CLI_CLI_CALL task code; the request
and response messages are the JAX package's, so its shell and
collectors query a port service as they query their own. Only the
commands whose machinery the port has are registered by default.
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
        self.register("events-dump", self._cmd_events_dump)
        if describe is not None:
            self.register("describe",
                          lambda a: json.dumps(describe(), indent=1))

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
