"""Counter reporter: Prometheus text exposition of the perf-counter registry.

Port of pegasus_tpu/collector/reporter.py (upstream
pegasus_counter_reporter, which pushes counters to Falcon or exposes
Prometheus): a lightweight HTTP exposer serves `/metrics` in Prometheus
text format and `/counters` as JSON from the process-wide registry, plus
the routes each server role mounts, and a helper builds the Falcon-style
JSON payload for an external pusher.
"""

import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.perf_counters import counters
from ..runtime.tasking import spawn_thread

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _flatten(snap: dict):
    """Yield (name, float) pairs; percentile counters snapshot as a
    {p50..p999} dict and flatten to `<name>.<quantile>` series."""
    for name, value in sorted(snap.items()):
        if isinstance(value, dict):
            for q, v in value.items():
                yield f"{name}.{q}", float(v)
        else:
            yield name, float(value)


def prometheus_text(snapshot: dict = None) -> str:
    snap = counters.snapshot() if snapshot is None else snapshot
    lines = []
    for name, value in _flatten(snap):
        metric = _NAME_RE.sub("_", name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value}")
    return "\n".join(lines) + "\n"


def falcon_payload(endpoint: str, snapshot: dict = None) -> str:
    """Falcon push body (list of metric dicts), reference
    pegasus_counter_reporter.cpp falcon_gauge JSON shape."""
    snap = counters.snapshot() if snapshot is None else snapshot
    out = [{"endpoint": endpoint, "metric": name, "value": v,
            "step": 60, "counterType": "GAUGE", "tags": ""}
           for name, v in _flatten(snap)]
    return json.dumps(out)


class CounterReporter:
    """HTTP exposer on (host, port); port 0 picks an ephemeral port.

    Beyond /metrics and /counters, server roles mount extra routes
    (version/info endpoints — the reference's rDSN http_service surface,
    e.g. /version, /meta/cluster_info): `routes` maps an EXACT path to
    `fn(full_path_with_query) -> JSON-serializable` (or raw bytes)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, routes=None):
        routes = dict(routes or {})

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                # exact routes FIRST: the /metrics prefix fallback must
                # not shadow a mounted subpath (/metrics/history)
                fn = routes.get(self.path.split("?")[0])
                if fn is None and self.path.startswith("/metrics"):
                    body = prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif fn is None and self.path.startswith("/counters"):
                    body = json.dumps(counters.snapshot(), indent=1).encode()
                    ctype = "application/json"
                else:
                    if fn is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    try:
                        out = fn(self.path)
                        if isinstance(out, bytes):
                            body, ctype = out, "application/octet-stream"
                        else:
                            # dumps inside the try: an unserializable route
                            # result must 500, not drop the connection
                            body = json.dumps(out, indent=1).encode()
                            ctype = "application/json"
                    except Exception as e:  # surface, don't kill the server
                        self.send_response(500)
                        self.end_headers()
                        self.wfile.write(repr(e).encode())
                        return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.address = self._srv.server_address
        self._thread = spawn_thread(self._srv.serve_forever, daemon=True,
                                    start=False)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
